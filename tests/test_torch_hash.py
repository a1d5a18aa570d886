"""PyTorch port, the sorted-hash collision broad phase
(`collision_broad_phase="hash"`: `_cell_hash`, `_grid_pass`,
`_WINDOW_CHUNK`) against the JAX package's, on the CPU.

`_cell_hash` must equal JAX's uint32 hash bit for bit (the port computes it
in int64 and keeps the low 32 bits), on negative cells and on cells at the
int32 ends. The pass is compared on N = 2048 clouds with a window of 2 rows
a segment (so most bodies overflow into the exact residual) and five big
bodies, for an explicit and a radius-scaled (0.0) cell size. Tolerance:
1e-5 * max(max|v|, 10) on positions and velocities (summation order), and
momentum to 1e-5 of sum m|v|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbodysim_tpu as nb
import nbodysim_tpu_torch as nt
from nbodysim_tpu.physics import collisions as jcoll
from nbodysim_tpu_torch.physics import collisions as tcoll

from _torch_helpers import CPU, INT_MAX, INT_MIN, as_np, as_t

N = 2048


def _cloud(dim: int, seed: int = 0):
    """A colliding cloud in [-40, 40]^D with five big bodies (radius 9,
    past half the radius-scaled cell)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-40.0, 40.0, (N, dim)).astype(np.float32)
    vel = rng.uniform(-5.0, 5.0, (N, dim)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, N).astype(np.float32)
    radius = (np.cbrt(mass) * 0.8).astype(np.float32)
    radius[:5] = 9.0
    return pos, vel, mass, radius


def _both(dim, **cfg):
    pos, vel, mass, radius = _cloud(dim)
    js = nb.ParticleState.create(jnp.asarray(pos), jnp.asarray(vel),
                                 jnp.asarray(mass), radius=jnp.asarray(radius))
    ts = nt.ParticleState.create(as_t(pos), as_t(vel), as_t(mass),
                                 radius=as_t(radius))
    kw = dict(n=N, dim=dim, collision_broad_phase="hash", **cfg)
    return js, nb.SimConfig(**kw), ts, nt.SimConfig(**kw)


@pytest.mark.parametrize("dim", [2, 3])
def test_cell_hash_matches_jax_bit_for_bit(dim):
    rng = np.random.default_rng(dim)
    ends = np.array([INT_MIN, INT_MIN + 1, -(2 ** 30), -7, -1, 0, 1, 5,
                     2 ** 30, INT_MAX - 1, INT_MAX], np.int64)
    cells = np.concatenate([
        rng.choice(ends, (600, dim)),
        rng.integers(-5000, 5000, (400, dim))]).astype(np.int32)
    for n_buckets in (2, 4096, 1 << 23, 1 << 30):
        want = np.asarray(jcoll._cell_hash(jnp.asarray(cells), n_buckets))
        got = as_np(tcoll._cell_hash(as_t(cells), n_buckets))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cell_size", [3.0, 0.0])
@pytest.mark.parametrize("dim", [2, 3])
def test_grid_pass_matches_jax(dim, cell_size):
    js, jcfg, ts, tcfg = _both(dim, collision_cell_size=cell_size,
                               collision_max_neighbors=2)
    g = tcoll._hash_grid(ts.pos, ts.radius, tcfg)
    overflow = int((~g.in_win & ~g.big_s).sum())
    assert int(g.bigs.big_sel.sum()) == 5
    assert 0 < overflow <= tcoll._OVERFLOW_CAP   # the residual has work
    want = jax.jit(jcoll.resolve_collisions, static_argnums=1)(js, jcfg)
    got = tcoll.resolve_collisions(ts, tcfg)
    vmax = max(float(np.abs(np.asarray(want.vel)).max()), 10.0)
    assert float(np.abs(np.asarray(want.vel) - np.asarray(js.vel)).max()) \
        > 1.0   # pairs fired
    for name in ("pos", "vel"):
        np.testing.assert_allclose(as_np(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-5 * vmax, err_msg=name)
    m = ts.mass[:, None]
    drift = (m * (got.vel - ts.vel)).sum(0).abs().max()
    assert float(drift) <= 1e-5 * float((ts.mass * ts.vel.norm(dim=1)).sum())


def test_grid_pass_chunks_give_the_same_deltas(monkeypatch):
    """The window scan in chunks of `_WINDOW_CHUNK` rows (a ragged last
    chunk included) equals the scan in one chunk bit for bit."""
    _, _, ts, tcfg = _both(2, collision_cell_size=0.0,
                           collision_max_neighbors=2)
    whole = tcoll.resolve_collisions(ts, tcfg)
    monkeypatch.setattr(tcoll, "_WINDOW_CHUNK", 700)
    chunked = tcoll.resolve_collisions(ts, tcfg)
    assert torch.equal(whole.pos, chunked.pos)
    assert torch.equal(whole.vel, chunked.vel)


def test_hash_pass_corrections_go_through_k5(monkeypatch):
    """On the kernel route the hash pass's big-body passes and its two
    residual rectangles call K5's wrapper (`rect_pair_deltas`), four
    launches a pass; here the wrapper's plain version stands in for the
    card, and the result equals the plain route's."""
    _, _, ts, tcfg = _both(2, collision_cell_size=0.0,
                           collision_max_neighbors=2)
    plain = tcoll.resolve_collisions(ts, tcfg)
    calls = []

    def spy(tgt, src, **kw):
        calls.append((tgt[0].shape[0], src[0].shape[0], kw["max_cheb"]))
        return tcoll.rect_pair_deltas_plain(tgt, src, **kw)

    monkeypatch.setattr(tcoll, "_use_kernels", lambda state, config: True)
    monkeypatch.setattr(tcoll, "rect_pair_deltas", spy)
    routed = tcoll.resolve_collisions(ts, tcfg)
    assert [c[2] for c in calls] == [None, None, 1, 1]
    assert calls[0] == (N, 64, None) and calls[1] == (64, N, None)
    assert torch.equal(plain.pos, routed.pos)
    assert torch.equal(plain.vel, routed.vel)


def test_auto_never_picks_the_hash(monkeypatch):
    """'auto' resolves to dense, bucket or block, never to the hash; an
    explicit 'hash' stays as given in Simulation and in the probe."""
    monkeypatch.setattr(tcoll, "DENSE_THRESHOLD", 512)
    _, _, ts, _ = _both(2)
    for dim in (2, 3):
        state = ts if dim == 2 else nt.ParticleState.create(
            torch.cat([ts.pos, ts.pos[:, :1]], 1),
            torch.zeros(N, 3), ts.mass)
        cfg = nt.SimConfig(n=N, dim=dim, collision_grid_res=16)
        assert tcoll._broad_phase(state, cfg) != "hash"
        hcfg = cfg.replace(collision_broad_phase="hash")
        assert tcoll.resolve_collision_phase_for_state(state, hcfg) is hcfg
        assert tcoll._broad_phase(state, hcfg) == "hash"
