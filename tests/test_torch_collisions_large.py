"""PyTorch port, collisions past N = 65,536: the 2D bucket pass against the
JAX package's, the exact corrections beyond the residual's cap, the
occupancy probes and the 'auto' switch to the block pass, and the collision
branches of `Simulation.check_capacity`, mirroring tests/test_collisions.py.
Inputs are drawn with numpy.

Tolerances: 1e-5 * max(max|v|, 1) against JAX (the same pairs, summed in
another order); 1e-3 against the dense pass on the big-body regression, as
the JAX test; momentum to 1e-5 of sum m|v|."""

import warnings

import numpy as np
import pytest
import jax.numpy as jnp

import nbodysim_tpu as nb
import nbodysim_tpu_torch as nt
from nbodysim_tpu.physics import collisions as JC
from nbodysim_tpu_torch.physics import collisions as TC

from _torch_helpers import CPU, as_np, as_t


def _states(*arrays):
    return (nb.ParticleState.create(*map(jnp.asarray, arrays)),
            nt.ParticleState.create(*map(as_t, arrays)))


def _cfgs(n, **kw):
    return (nb.SimConfig(n=n, collision_backend="xla", **kw),
            nt.SimConfig(n=n, **kw))


def _momentum(mass, vel):
    return (np.asarray(mass)[:, None] * np.asarray(vel)).sum(0)


def _check_momentum(mass, vel0, vel1):
    np.testing.assert_allclose(
        _momentum(mass, vel1), _momentum(mass, vel0),
        atol=1e-5 * float((mass[:, None] * np.abs(vel0)).sum()))


def test_bucket_pass_matches_jax_with_overflow_and_bigs():
    """A 2048-body cloud on a 32^2 grid with 8 slots: cells overflow (the
    residual runs) and four big bodies leave the grid."""
    rng = np.random.default_rng(3)
    n = 2048
    pos = rng.uniform(-400.0, 400.0, (n, 2)).astype(np.float32)
    pos[:300] = rng.normal(size=(300, 2)).astype(np.float32) * 20.0
    vel = rng.uniform(-10.0, 10.0, (n, 2)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    radius = rng.uniform(1.0, 4.0, n).astype(np.float32)
    radius[:4] = (60.0, 45.0, 80.0, 45.0)
    js, ts = _states(pos, vel, mass, radius)
    jc, tc = _cfgs(n, collision_grid_res=32, collision_max_neighbors=8)
    over = TC.collision_bucket_overflow(ts, tc)
    assert 0 < over <= TC._OVERFLOW_CAP
    assert over == JC.collision_bucket_overflow(js, jc)
    tout = TC._bucket_pass(ts, tc)
    jout = JC._bucket_pass(js, jc)
    scale = max(float(np.abs(np.asarray(jout.vel)).max()), 1.0)
    for ours, theirs in ((tout.pos, jout.pos), (tout.vel, jout.vel)):
        np.testing.assert_allclose(as_np(ours), np.asarray(theirs),
                                   atol=1e-5 * scale)
    assert float(np.abs(as_np(tout.vel) - vel).max()) > 0.1
    _check_momentum(mass, vel, as_np(tout.vel))


def test_bucket_pass_big_plus_overflow_matches_dense():
    """tests/test_collisions.py's regression: a big body adjacent to a cell
    that overflows the slot cap; big<->overflow pairs count once."""
    rng = np.random.default_rng(9)
    pos = np.concatenate([rng.uniform(-5.0, 5.0, (12, 2)),
                          [[3.0, 0.0]]]).astype(np.float32)
    vel = rng.uniform(-2.0, 2.0, (13, 2)).astype(np.float32)
    mass = np.concatenate([np.ones(12), [50.0]]).astype(np.float32)
    radius = np.concatenate([np.full(12, 1.5), [400.0]]).astype(np.float32)
    js, ts = _states(pos, vel, mass, radius)
    jc, tc = _cfgs(13, collision_max_neighbors=4, collision_grid_res=64)
    tout = TC._bucket_pass(ts, tc)
    jout = JC._bucket_pass(js, jc)
    dense = TC._dense_pass(ts, tc)
    for a, b in ((tout.pos, dense.pos), (tout.vel, dense.vel)):
        np.testing.assert_allclose(as_np(a), as_np(b), atol=1e-3)
    scale = max(float(np.abs(np.asarray(jout.vel)).max()), 1.0)
    np.testing.assert_allclose(as_np(tout.vel), np.asarray(jout.vel),
                               atol=1e-5 * scale)
    np.testing.assert_allclose(_momentum(mass, tout.vel),
                               _momentum(mass, vel), atol=1e-2)


def test_bucket_residual_beyond_cap_conserves_momentum(monkeypatch):
    """Overflow beyond a residual cap of 32 drops pairs symmetrically:
    momentum conserved, no NaN, and collisions still happen. (The block
    pass's case is in tests/test_torch_collide_block.py.)"""
    monkeypatch.setattr(TC, "_OVERFLOW_CAP", 32)
    rng = np.random.default_rng(7)
    n = 512
    pos = np.concatenate([5.0 * rng.normal(size=(n - 8, 2)),
                          rng.uniform(-2e4, 2e4, (8, 2))]).astype(np.float32)
    vel = rng.uniform(-50.0, 50.0, (n, 2)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    state = nt.ParticleState.create(*map(as_t, (
        pos, vel, mass, np.full(n, 0.5, np.float32))))
    cfg = nt.SimConfig(n=n, collision_max_neighbors=8, collision_grid_res=64,
                       collision_broad_phase="bucket")
    assert TC.collision_bucket_overflow(state, cfg) > 32
    out = TC.resolve_collisions(state, cfg)
    assert bool(np.isfinite(as_np(out.vel)).all())
    _check_momentum(mass, vel, as_np(out.vel))
    assert not np.allclose(as_np(out.vel), vel)


def _clustered_70k():
    """70,000 bodies: a tight blob plus two far outliers, so the span-scaled
    bucket cell (~3900 units) holds the whole blob (merger-nuclei
    geometry) and overflows the residual."""
    rng = np.random.default_rng(3)
    n = 70_000
    pos = (50.0 * rng.normal(size=(n, 2))).astype(np.float32)
    pos[0], pos[1] = (1e6, 0.0), (-1e6, 0.0)
    return (pos, np.zeros((n, 2), np.float32), np.ones(n, np.float32),
            np.ones(n, np.float32))


def test_auto_switches_to_block_at_70k():
    """The probe only (no pair work): the bucket overflow matches JAX's,
    'auto' switches to the block pass with radius-scaled cells and warns;
    explicit broad phases are honoured."""
    js, ts = _states(*_clustered_70k())
    jc, tc = _cfgs(70_000)
    over = TC.collision_bucket_overflow(ts, tc)
    assert over > TC._OVERFLOW_CAP
    assert over == JC.collision_bucket_overflow(js, jc)
    with pytest.warns(RuntimeWarning, match="block"):
        out = TC.resolve_collision_phase_for_state(ts, tc)
    assert (out.collision_broad_phase, out.collision_cell_size) == \
        ("block", 0.0)
    assert TC._broad_phase(ts, out) == "block"
    assert TC._broad_phase(ts, tc) == "bucket"
    for bp in ("bucket", "block", "dense"):
        cfg = tc.replace(collision_broad_phase=bp)
        assert TC.resolve_collision_phase_for_state(ts, cfg) is cfg
    # A spread scene stays on the bucket grid.
    rng = np.random.default_rng(4)
    spread = ts.replace(pos=as_t(rng.uniform(
        -2e4, 2e4, (70_000, 2)).astype(np.float32)))
    assert TC.collision_bucket_overflow(spread, tc) <= TC._OVERFLOW_CAP
    assert TC.resolve_collision_phase_for_state(spread, tc) is tc


def test_check_capacity_warnings(monkeypatch):
    """Simulation warns at init when the bucket grid or the block windows
    overflow the collision residual (thresholds shrunk to test scale, as
    tests/test_collisions.py does), and not when nothing overflows."""
    monkeypatch.setattr(TC, "DENSE_THRESHOLD", 1024)
    monkeypatch.setattr(TC, "_OVERFLOW_CAP", 64)
    rng = np.random.default_rng(5)
    n = 2048
    pos = (50.0 * rng.normal(size=(n, 2))).astype(np.float32)
    pos[0], pos[1] = (1e6, 0.0), (-1e6, 0.0)
    state = nt.ParticleState.create(*map(as_t, (
        pos, np.zeros((n, 2), np.float32), np.ones(n, np.float32))))
    cfg = nt.SimConfig(n=n)
    with pytest.warns(RuntimeWarning, match="bucket overflow"):
        sim = nt.Simulation(cfg.replace(collision_broad_phase="bucket"),
                            state=state, device=CPU)
    assert sim.config.collision_broad_phase == "bucket"
    point = state.replace(pos=state.pos * 0.0)
    with pytest.warns(RuntimeWarning, match="block-window overflow"):
        nt.Simulation(cfg.replace(collision_broad_phase="block"),
                      state=point, device=CPU)
    # 'auto' switches (one warning) and the block pass then covers it all.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim = nt.Simulation(cfg, state=state, device=CPU)
    assert sim.config.collision_broad_phase == "block"
    assert [str(w.message).split(":")[0] for w in caught] == \
        ["auto collision broad phase"]
    assert sim.check_capacity() is False
