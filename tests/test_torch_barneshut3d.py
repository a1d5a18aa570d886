"""PyTorch port, the 3D tree code (`physics/barneshut3d.py`, the octree FMM)
against the JAX package on the CPU: each stage on the same numpy inputs,
the whole force evaluation on a uniform, a Plummer and a heavy-hitter
system, its accuracy against exact forces, one Simulation step, the
state-aware backend resolution in 3D, and the M2L precision pin (fault F1).

Tolerances: 1e-5 * max for forces and stages, as tests/test_barneshut3d.py
holds the Pallas near field to the XLA one; the ports differ from the JAX
package only in f32 summation order (the M2L convolution, the pooling,
`index_add_` against `.at[].add`). Against exact forces the JAX tests'
bounds: median relative error < 0.015 at R = 2, < 0.003 at R = 3.
"""

import functools
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import nbodysim_tpu as nb
from nbodysim_tpu.config import SimConfig as JaxConfig
from nbodysim_tpu.physics import barneshut as jb
from nbodysim_tpu.physics import barneshut3d as jb3
from nbodysim_tpu.physics import forces as jforces
from nbodysim_tpu.physics.integrators import make_step as jax_make_step
import nbodysim_tpu_torch as nt
from nbodysim_tpu_torch.physics import barneshut as tb
from nbodysim_tpu_torch.physics import barneshut3d as tb3
from nbodysim_tpu_torch.physics import forces as tforces

from _torch_helpers import CPU, as_np, as_t, rand_system, to_port


def _close(got, ref, rel=1e-5):
    got, ref = as_np(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=rel * np.abs(ref).max())


def _clustered(n, n_hot, seed):
    """Uniform in +-1000^3, with n_hot of the bodies packed into one spot."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1000.0, 1000.0, (n, 3))
    pos[:n_hot] = rng.uniform(100.0, 110.0, (n_hot, 3))
    return pos.astype(np.float32), rng.uniform(0.1, 10.0, n).astype(np.float32)


def _jax_plummer(n, **kw):
    s = nb.init_scene("plummer", JaxConfig(n=n, dim=3, force_backend="xla",
                                           **kw),
                      total_mass=1e4, scale_radius=1000.0)
    return np.asarray(s.pos), np.asarray(s.mass)


def _heavy(n, seed):
    pos, mass = rand_system(n, dim=3, seed=seed)
    mass[0] = 1e9
    return pos, mass


def test_pyramid3_matches_jax_and_conserves_mass():
    pos, mass = rand_system(1000, dim=3)
    grids, corner, size, ci, flat = tb3._build_pyramid3(as_t(pos),
                                                        as_t(mass), 4)
    jg, jcorner, jsize, jci, jflat = jb3._build_pyramid3(
        jnp.asarray(pos), jnp.asarray(mass), 4)
    np.testing.assert_array_equal(as_np(ci), np.asarray(jci))
    np.testing.assert_array_equal(as_np(flat), np.asarray(jflat))
    _close(corner, jcorner)
    _close(size, jsize)
    total = float(mass.astype(np.float64).sum())
    # A coarse cell sums ~1000 terms that cancel (m x over a centred cube),
    # so f32 summation order moves it by ~1e-7 of the terms' magnitude, far
    # more than 1e-5 of the sum: each channel is held to 1e-6 of the sum of
    # its terms' magnitudes.
    mag = np.abs(as_np(tb3._moment_payload3(as_t(pos), as_t(mass)))).sum(0)
    for lv in range(5):
        np.testing.assert_allclose(float(grids[lv][0].sum()), total,
                                   rtol=1e-5)
        assert len(grids[lv]) == 10
        for c, (got, ref) in enumerate(zip(grids[lv], jg[lv])):
            np.testing.assert_allclose(as_np(got), np.asarray(ref),
                                       atol=1e-6 * mag[c])


def _level_window(levels):
    pos, mass = rand_system(4096, dim=3)
    grids, corner, size, _, _ = tb3._build_pyramid3(as_t(pos), as_t(mass),
                                                    levels)
    return grids[levels], corner, size


@pytest.mark.parametrize("levels,radius", [(3, 2), (4, 2), (4, 3)])
def test_m2l_conv3_matches_jax_and_the_stencil(levels, radius):
    """The conv's channel order is the child enumeration of
    `_m2l_conv_taps`; a wrong order would pass a kernel-vs-plain check on
    the card (both routes share this code) but not this one."""
    g, corner, size = _level_window(levels)
    r, qh, p = 1 << levels, radius - 1, 2 * radius - 1
    gx = torch.nn.functional.pad(torch.stack(g, -1),
                                 (0, 0) * 3 + (2 * qh, 2 * qh))
    conv = tb3._m2l_conv3(gx, corner, size, r, 1.0, radius, row0=0, rows=r)
    jc, js = jnp.asarray(as_np(corner)), jnp.asarray(as_np(size))
    jconv = jb3._m2l_conv3(tuple(jnp.asarray(as_np(gx[..., c]))
                                 for c in range(10)),
                           jc, js, r, 1.0, radius, row0=jnp.int32(0), rows=r)
    window = tuple(torch.nn.functional.pad(a, (p,) * 6) for a in g)
    stencil = tb3._m2l_stencil3(window, corner, size, r, 1.0, radius,
                                row0=0, rows=r)
    jstencil = jb3._m2l_stencil3(
        tuple(jnp.asarray(as_np(w)) for w in window), jc, js, r, 1.0, radius,
        row0=jnp.int32(0), rows=r)
    assert len(conv) == len(stencil) == 19
    for t in range(19):
        _close(conv[t], jconv[t])
        _close(stencil[t], jstencil[t])
    # Conv (moments about cell centres) and stencil (about the COM) carry
    # the same monopole and quadrupole and differ only in truncated
    # higher-order cross terms: the force terms F agree to ~1e-2.
    for t in (0, 1, 2):
        _close(conv[t], as_np(stencil[t]), rel=3e-2)


def test_m2l_conv3_runs_with_tf32_off(monkeypatch):
    """Fault F1: PyTorch runs f32 convolutions through cuDNN in TF32 by
    default; the 3D M2L convolution must run with it off, and restore it."""
    seen = []
    real_conv3d = torch.nn.functional.conv3d

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real_conv3d(*args, **kwargs)

    monkeypatch.setattr(tb3.F, "conv3d", spy)
    torch.backends.cudnn.allow_tf32 = True
    g, corner, size = _level_window(3)
    tb3._m2l_level3(g, corner, size, 1.0, 2)
    assert seen == [False]
    assert torch.backends.cudnn.allow_tf32 is True


def test_l2l_upsample3_and_l2p_match_jax():
    rng = np.random.default_rng(7)
    local = tuple(rng.normal(size=(4, 4, 4)).astype(np.float32)
                  for _ in range(19))
    got = tb3._l2l_upsample3(tuple(as_t(a) for a in local), 12.5)
    ref = jb3._l2l_upsample3(tuple(jnp.asarray(a) for a in local), 12.5)
    assert len(got) == 19
    for a, b in zip(got, ref):
        _close(a, b)
    pos = rng.uniform(-100.0, 100.0, (500, 3)).astype(np.float32)
    corner, size = np.float32([-101.0] * 3), np.float32(202.0)
    ci = np.clip(((pos - corner) / size * 8).astype(np.int32), 0, 7)
    fine = tuple(as_np(a) for a in got)
    out = tb3._l2p_eval3(tuple(as_t(a) for a in fine),
                         as_t(ci.astype(np.int64)), as_t(pos), as_t(corner),
                         as_t(size), 3)
    jout = jb3._l2p_eval3(tuple(jnp.asarray(a) for a in fine),
                          jnp.asarray(ci), jnp.asarray(pos),
                          jnp.asarray(corner), jnp.asarray(size), 3)
    _close(out, jout)


_jax_near3 = jax.jit(functools.partial(
    jb3._near_field_buckets3, levels=3, eps_sq=1.0, g_const=1.0,
    cap=jb.NEAR_CAP, radius=2))


@pytest.mark.parametrize("n_hot,tier", [(1500, "full"), (300, "small")])
def test_near_field_buckets3_both_residual_tiers(n_hot, tier):
    """N = 2048 > _OVERFLOW_SMALL, so the 1024-wide tier exists: a cluster
    of 1500 overflows past it (the full 2048-wide tier), one of 300 into
    it. The stable sort puts the same particles into the in-cap slots."""
    n, levels = 2048, 3
    pos, mass = _clustered(n, n_hot, seed=3)
    _, _, _, ci, flat = tb3._build_pyramid3(as_t(pos), as_t(mass), levels)
    acc, over = tb._near_field_buckets(
        as_t(pos), as_t(mass), ci, flat, levels, 1.0, 1.0, tb.NEAR_CAP, 2)
    jacc, jover = _jax_near3(jnp.asarray(pos), jnp.asarray(mass),
                             jnp.asarray(as_np(ci).astype(np.int32)),
                             jnp.asarray(as_np(flat).astype(np.int32)))
    assert int(over) == int(jover)
    small = tb._OVERFLOW_SMALL
    assert (int(over) > small) == (tier == "full") and int(over) > 0
    _close(acc, jacc)


def _systems():
    return {
        "uniform": rand_system(4096, dim=3),
        "plummer": _jax_plummer(4096, softening=10.0),
        "heavy": _heavy(2048, seed=1),
    }


@pytest.mark.parametrize("name", ["uniform", "plummer", "heavy"])
def test_bh3_accelerations_match_jax(name):
    pos, mass = _systems()[name]
    n = len(pos)
    kw = dict(n=n, dim=3, force_backend="bh",
              softening=10.0 if name == "plummer" else 1.0)
    got = tb.bh_accelerations(as_t(pos), as_t(mass), nt.SimConfig(**kw))
    ref = jb.bh_accelerations(jnp.asarray(pos), jnp.asarray(mass),
                              JaxConfig(**kw))
    assert bool(torch.isfinite(got).all())
    _close(got, ref)
    # The CPU wrappers run the plain versions: both routes agree exactly.
    plain = tb3.bh3_accelerations(as_t(pos), as_t(mass), nt.SimConfig(**kw),
                                  use_kernels=False)
    np.testing.assert_array_equal(as_np(got), as_np(plain))


def test_bh3_matches_the_pallas_near_field_route():
    """The JAX package's own Pallas near field (K7 in interpret mode) through
    the whole octree eval, against the port on the same input."""
    pos, mass = rand_system(2048, dim=3, seed=11)
    got = tb3.bh3_accelerations(as_t(pos), as_t(mass),
                                nt.SimConfig(n=2048, dim=3, bh_levels=3))
    ref = jb3.bh3_accelerations(
        jnp.asarray(pos), jnp.asarray(mass),
        JaxConfig(n=2048, dim=3, bh_levels=3, pallas_interpret=True))
    _close(got, ref)


@pytest.mark.parametrize("radius,tol_median", [(2, 0.015), (3, 0.003)])
def test_bh3_accuracy_against_exact(radius, tol_median):
    pos, mass = rand_system(4096, dim=3)
    cfg = nt.SimConfig(n=4096, dim=3, bh_levels=4, bh_accept_radius=radius)
    a_bh = as_np(tb3.bh3_accelerations(as_t(pos), as_t(mass), cfg))
    a_dir = as_np(tforces.direct_accelerations(as_t(pos), as_t(mass),
                                               eps_sq=1.0))
    err = np.linalg.norm(a_bh - a_dir, axis=1) / (
        np.linalg.norm(a_dir, axis=1) + 1e-12)
    assert np.median(err) < tol_median, np.median(err)


def test_bh3_momentum_balance():
    pos, mass = rand_system(2048, dim=3, seed=2)
    cfg = nt.SimConfig(n=2048, dim=3, bh_levels=4)
    acc = as_np(tb3.bh3_accelerations(as_t(pos), as_t(mass), cfg))
    net = np.abs((mass[:, None] * acc).sum(0))
    gross = np.abs(mass[:, None] * acc).sum()
    assert (net / gross < 5e-3).all()


def test_bh3_simulation_step_matches_jax():
    """N = 1024 Plummer: each mass (1e4 / 1024) is below the heavy-body
    threshold (0.1% of the total), so no tied masses are extracted
    (`torch.topk` and `lax.top_k` may pick different tied bodies)."""
    jcfg = JaxConfig(n=1024, dim=3, force_backend="bh", bh_levels=3,
                     enable_collisions=False)
    state = nb.init_scene("plummer", jcfg)
    ref = jax_make_step(jcfg)(state)
    cfg = nt.SimConfig(n=1024, dim=3, force_backend="bh", bh_levels=3,
                       enable_collisions=False)
    sim = nt.Simulation(cfg, state=to_port(state), device=CPU)
    assert sim.check_capacity() is False   # runs the 3D occupancy probe
    sim.step()
    for field in ("pos", "vel", "acc"):
        _close(getattr(sim.state, field), getattr(ref, field))
    assert sim.frame == 1


def _scene(kind):
    rng = np.random.default_rng(0)
    if kind == "clump":   # 448 bodies in one cell of a wide field
        pos = np.concatenate([rng.uniform(-1.0, 1.0, (448, 3)),
                              rng.uniform(-1000.0, 1000.0, (64, 3))])
    else:
        pos = rng.uniform(-1000.0, 1000.0, (512, 3))
    return pos.astype(np.float32), np.ones(512, np.float32)


@pytest.mark.parametrize("kind", ["spread", "clump"])
def test_resolve_config_for_state_agrees_in_3d(monkeypatch, kind):
    """'auto' picks the octree from BH3_AUTO_THRESHOLD; where the JAX
    package turns the deep-overflow chain on (overflow > _OVERFLOW_CAP), so
    does the port, with the same warning, and both pin the same
    (force_backend, bh_deep_levels, bh_nf_sparse); Simulation builds with
    it. Both thresholds are patched small, as tests/test_barneshut3d.py
    does."""
    monkeypatch.setattr(jforces, "BH3_AUTO_THRESHOLD", 256)
    monkeypatch.setattr(jb, "_OVERFLOW_CAP", 64)
    monkeypatch.setattr(tforces, "BH3_AUTO_THRESHOLD", 256)
    monkeypatch.setattr(tforces, "_OVERFLOW_CAP", 64)
    pos, mass = _scene(kind)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jcfg = jforces.resolve_config_for_state(
            jnp.asarray(pos), jnp.asarray(mass),
            JaxConfig(n=512, dim=3, bh_levels=3))
    cfg = nt.SimConfig(n=512, dim=3, bh_levels=3, enable_collisions=False)
    over = tb3.bh3_near_overflow(as_t(pos), as_t(mass), cfg)
    assert over == jb3.bh3_near_overflow(jnp.asarray(pos), jnp.asarray(mass),
                                         JaxConfig(n=512, dim=3,
                                                   bh_levels=3))
    fields = ("force_backend", "bh_deep_levels", "bh_nf_sparse")
    if kind == "clump":
        assert jcfg.bh_deep_levels != 0 and over > 64
        with pytest.warns(RuntimeWarning, match="deep-overflow"):
            got = tforces.resolve_config_for_state(as_t(pos), as_t(mass),
                                                   cfg)
        with pytest.warns(RuntimeWarning, match="deep-overflow"):
            sim = nt.Simulation(cfg, state=nt.ParticleState.create(
                as_t(pos), torch.zeros(512, 3), as_t(mass)), device=CPU)
        assert tuple(getattr(sim.config, f) for f in fields) == tuple(
            getattr(jcfg, f) for f in fields)
        assert sim.check_capacity() is False
    else:
        got = tforces.resolve_config_for_state(as_t(pos), as_t(mass), cfg)
        assert (got.force_backend, got.bh_deep_levels, got.bh_nf_sparse) == (
            "bh", 0, 0)
    assert tuple(getattr(got, f) for f in fields) == tuple(
        getattr(jcfg, f) for f in fields)


def test_nf_sparse_resolution_matches_jax(monkeypatch):
    """The JAX package pins bh_nf_sparse = -1 to 0 in 2D and in 3D without
    the deep chain (`_resolve_nf_sparse`); with the 3D deep chain on it
    counts the bucket-tier targets (`bh3_bucket_tier_count`) and pins 1
    when they fit half the sparse pass's capacity. So does the port; an
    explicit value is kept."""
    monkeypatch.setattr(jforces, "BH_AUTO_THRESHOLD", 256)
    monkeypatch.setattr(tforces, "BH_AUTO_THRESHOLD", 256)
    pos, mass = rand_system(1024)
    jcfg = jforces.resolve_config_for_state(
        jnp.asarray(pos), jnp.asarray(mass), JaxConfig(n=1024))
    got = tforces.resolve_config_for_state(as_t(pos), as_t(mass),
                                           nt.SimConfig(n=1024))
    assert nt.SimConfig().bh_nf_sparse == -1
    assert (got.force_backend, got.bh_nf_sparse) == (
        jcfg.force_backend, jcfg.bh_nf_sparse) == ("bh", 0)
    p3, m3 = rand_system(64, dim=3)
    pos3, mass3 = as_t(p3), as_t(m3)
    cfg3 = nt.SimConfig(n=64, dim=3, force_backend="bh")
    jcfg3 = JaxConfig(n=64, dim=3, force_backend="bh")
    assert tforces._resolve_nf_sparse(pos3, mass3, cfg3).bh_nf_sparse == 0
    assert tforces._resolve_nf_sparse(
        pos3, mass3, cfg3.replace(bh_nf_sparse=1)).bh_nf_sparse == 1
    # The deep chain on: the port's pin equals JAX's, where the bucket
    # tier fits the sparse pass (the default cap) and where it does not (a
    # cap of 16).
    for cap in (jb3._NF_SPARSE_CAP, 16):
        monkeypatch.setattr(jb3, "_NF_SPARSE_CAP", cap)
        monkeypatch.setattr(tforces, "_NF_SPARSE_CAP", cap)
        got = tforces._resolve_nf_sparse(
            pos3, mass3, cfg3.replace(bh_deep_levels=-1)).bh_nf_sparse
        ref = jforces._resolve_nf_sparse(
            jnp.asarray(p3), jnp.asarray(m3),
            jcfg3.replace(bh_deep_levels=-1)).bh_nf_sparse
        assert got == ref == (1 if cap > 16 else 0)


@pytest.mark.parametrize("n,cfg", [
    (4096, {}), (1 << 20, {}), (1 << 24, {}), (50_000, {"bh_levels": 9}),
    (50_000, {"theta": 0.3}), (50_000, {"bh_accept_radius": 7}),
    (50_000, {"bh_deep_levels": -1}), (50_000, {"bh_deep_levels": 12})])
def test_resolved_octree_parameters_match_jax(n, cfg):
    """Levels, radius and deep-chain depth resolve as in the JAX package;
    N = 1M gives the main path's 64^3 cells at R = 2."""
    tcfg, jcfg = nt.SimConfig(n=n, dim=3, **cfg), JaxConfig(n=n, dim=3, **cfg)
    levels = tb3._resolve_levels3(tcfg, n)
    assert levels == jb3._resolve_levels3(jcfg, n)
    assert tb3._resolve_radius3(tcfg) == jb3._resolve_radius3(jcfg)
    deep = tb3._resolve_deep_levels3(tcfg, levels)
    assert deep == jb3._resolve_deep_levels3(jcfg, levels)
    radius = tb3._resolve_radius3(tcfg)
    assert tb3._resolve_tile_params3(tcfg, deep, radius) == \
        jb3._resolve_tile_params3(jcfg, deep, radius)
    if n == 1 << 20 and not cfg:
        assert (levels, tb3._resolve_radius3(tcfg)) == (6, 2)
