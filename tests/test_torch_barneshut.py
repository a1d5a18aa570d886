"""PyTorch port, the 2D tree code (`physics/barneshut.py`) against the JAX
package on the CPU: each stage on the same numpy inputs, the whole force
evaluation on uniform, disc and Plummer-like systems, one Simulation step,
the state-aware backend resolution, and the M2L precision pin (fault F1).

Tolerances: 1e-5 * max|a| for forces, as tests/test_barneshut.py holds the
Pallas near field to the XLA one; the ports differ from the JAX package only
in f32 summation order (the M2L convolution, `index_add_` vs `.at[].add`).
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
from nbodysim_tpu.physics import forces as jforces
from nbodysim_tpu.physics.integrators import make_step as jax_make_step
import nbodysim_tpu_torch as nt
from nbodysim_tpu_torch.physics import barneshut as tb
from nbodysim_tpu_torch.physics import barneshut3d as tb3
from nbodysim_tpu_torch.physics import forces as tforces

from _torch_helpers import CPU, as_np, as_t, rand_system, to_port


def _plummer_like(n, seed, scale=100.0):
    """2D positions with Plummer's radial law (radii out to ~1000 scale
    lengths), the centrally concentrated case the outlier extraction
    exists for."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(1e-6, 1.0, n)
    r = scale / np.sqrt(u ** (-2.0 / 3.0) - 1.0)
    th = rng.uniform(0.0, 2.0 * np.pi, n)
    pos = np.stack([r * np.cos(th), r * np.sin(th)], -1).astype(np.float32)
    return pos, rng.uniform(0.5, 2.0, n).astype(np.float32)


def _disc(n):
    s = nb.init_scene("uniform_disc", JaxConfig(n=n, force_backend="xla"))
    return np.asarray(s.pos), np.asarray(s.mass)


def _clustered(n, n_hot, seed):
    """Uniform in +-1000, with n_hot of the bodies packed into one spot."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1000.0, 1000.0, (n, 2))
    pos[:n_hot] = rng.uniform(100.0, 110.0, (n_hot, 2))
    return pos.astype(np.float32), rng.uniform(0.1, 10.0, n).astype(np.float32)


def _close(got, ref, rel=1e-5):
    got, ref = as_np(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("synth_quad", [False, True])
def test_pyramid_matches_jax_and_conserves_mass(synth_quad):
    """synth_quad=True (the deep chain's build) synthesizes the quadrupole
    channels from (m, sx, sy)."""
    pos, mass = rand_system(1000)
    grids, corner, size, ci, flat = tb._build_pyramid(
        as_t(pos), as_t(mass), 5, synth_quad=synth_quad)
    jg, jcorner, jsize, jci, jflat = jb._build_pyramid(
        jnp.asarray(pos), jnp.asarray(mass), 5, synth_quad=synth_quad)
    np.testing.assert_array_equal(as_np(ci), np.asarray(jci))
    np.testing.assert_array_equal(as_np(flat), np.asarray(jflat))
    _close(corner, jcorner)
    _close(size, jsize)
    total = float(mass.astype(np.float64).sum())
    for lv in range(6):
        np.testing.assert_allclose(float(grids[lv][0].sum()), total, rtol=1e-5)
        for got, ref in zip(grids[lv], jg[lv]):
            _close(got, ref)


def _level_window(levels, radius):
    pos, mass = rand_system(4096)
    grids, corner, size, _, _ = tb._build_pyramid(as_t(pos), as_t(mass),
                                                  levels)
    return grids[levels], corner, size


@pytest.mark.parametrize("levels,radius", [(3, 3), (5, 3), (5, 2)])
def test_m2l_conv_matches_jax_and_the_stencil(levels, radius):
    g, corner, size = _level_window(levels, radius)
    r, qh, p = 1 << levels, radius - 1, 2 * radius - 1
    gx = torch.nn.functional.pad(torch.stack(g, -1),
                                 (0, 0, 0, 0, 2 * qh, 2 * qh))
    conv = tb._m2l_conv(gx, corner, size, r, 1.0, radius, row0=0, rows=r)
    jc, js = jnp.asarray(as_np(corner)), jnp.asarray(as_np(size))
    jconv = jb._m2l_conv(jnp.asarray(as_np(gx)), jc, js, r, 1.0, radius,
                         row0=jnp.int32(0), rows=r)
    window = tuple(torch.nn.functional.pad(a, (p, p, p, p)) for a in g)
    stencil = tb._m2l_stencil(window, corner, size, r, 1.0, radius,
                              row0=0, rows=r)
    jstencil = jb._m2l_stencil(tuple(jnp.asarray(as_np(w)) for w in window),
                               jc, js, r, 1.0, radius, row0=jnp.int32(0),
                               rows=r)
    assert len(conv) == 9
    for t in range(9):
        _close(conv[t], jconv[t])
        _close(stencil[t], jstencil[t])
    # Conv (moments about cell centres) and stencil (about the COM) carry
    # the same monopole and quadrupole and differ only in truncated
    # higher-order cross terms: the force terms F agree to ~1e-2.
    for t in (0, 1):
        _close(conv[t], as_np(stencil[t]), rel=3e-2)


def test_m2l_level_routes_even_grids_to_the_conv():
    g, corner, size = _level_window(4, 3)
    got = tb._m2l_level(g, corner, size, 1.0, 3)
    ref = jb._m2l_level(tuple(jnp.asarray(as_np(a)) for a in g),
                        jnp.asarray(as_np(corner)), jnp.asarray(as_np(size)),
                        1.0, 3)
    for a, b in zip(got, ref):
        _close(a, b)


def test_m2l_conv_runs_with_tf32_off(monkeypatch):
    """Fault F1: PyTorch runs f32 convolutions through cuDNN in TF32 by
    default; the M2L convolution must run with it off, and restore it."""
    seen = []
    real_conv2d = torch.nn.functional.conv2d

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real_conv2d(*args, **kwargs)

    monkeypatch.setattr(tb.F, "conv2d", spy)
    torch.backends.cudnn.allow_tf32 = True
    g, corner, size = _level_window(4, 3)
    tb._m2l_level(g, corner, size, 1.0, 3)
    assert seen == [False]
    assert torch.backends.cudnn.allow_tf32 is True


def test_l2l_upsample_and_l2p_match_jax():
    rng = np.random.default_rng(7)
    local = tuple(rng.normal(size=(8, 8)).astype(np.float32)
                  for _ in range(9))
    got = tb._l2l_upsample(tuple(as_t(a) for a in local), 12.5)
    ref = jb._l2l_upsample(tuple(jnp.asarray(a) for a in local), 12.5)
    for a, b in zip(got, ref):
        _close(a, b)
    pos = rng.uniform(-100.0, 100.0, (500, 2)).astype(np.float32)
    corner, size = np.float32([-101.0, -101.0]), np.float32(202.0)
    ci = np.clip(((pos - corner) / size * 16).astype(np.int32), 0, 15)
    fine = tuple(as_np(a) for a in got)
    out = tb._l2p_eval(tuple(as_t(a) for a in fine), as_t(ci.astype(np.int64)),
                       as_t(pos), as_t(corner), as_t(size), 4)
    jout = jb._l2p_eval(tuple(jnp.asarray(a) for a in fine), jnp.asarray(ci),
                        jnp.asarray(pos), jnp.asarray(corner),
                        jnp.asarray(size), 4)
    _close(out, jout)


_jax_near = jax.jit(functools.partial(
    jb._near_field_buckets, levels=4, eps_sq=1.0, g_const=1.0,
    cap=jb.NEAR_CAP, radius=3))


@pytest.mark.parametrize("n_hot,tier", [(1500, "full"), (300, "small")])
def test_near_field_buckets_both_residual_tiers(n_hot, tier):
    """N = 2048 > _OVERFLOW_SMALL, so the 1024-wide tier exists: a cluster
    of 1500 overflows past it (the full 2048-wide tier), one of 300 into
    it. The stable sort puts the same particles into the in-cap slots."""
    n, levels = 2048, 4
    pos, mass = _clustered(n, n_hot, seed=3)
    grids, corner, size, ci, flat = tb._build_pyramid(as_t(pos), as_t(mass),
                                                      levels)
    acc, over = tb._near_field_buckets(
        as_t(pos), as_t(mass), ci, flat, levels, 1.0, 1.0, tb.NEAR_CAP, 3)
    jacc, jover = _jax_near(jnp.asarray(pos), jnp.asarray(mass),
                            jnp.asarray(as_np(ci).astype(np.int32)),
                            jnp.asarray(as_np(flat).astype(np.int32)))
    assert int(over) == int(jover)
    small = tb._OVERFLOW_SMALL
    assert (int(over) > small) == (tier == "full") and int(over) > 0
    _close(acc, jacc)


def test_extract_heavy_outliers_on_the_disc():
    """The disc's 1e9 central body is extracted as the one heavy body."""
    pos, mass = _disc(2048)
    got = tb._extract_heavy_outliers(as_t(pos), as_t(mass))
    ref = jb._extract_heavy_outliers(jnp.asarray(pos), jnp.asarray(mass))
    assert int(got["is_heavy"].sum()) == 1 and float(mass.max()) >= 1e9
    for key in ("is_heavy", "is_out", "out_i", "out_sel"):
        np.testing.assert_array_equal(as_np(got[key]), np.asarray(ref[key]))
    for key in ("h_pos", "h_mass", "field_mass", "com", "tree_mass",
                "bulk_pos"):
        _close(got[key], ref[key])


def _systems():
    return {
        "uniform": rand_system(4096),
        "disc": _disc(2048),
        "plummer": _plummer_like(4096, seed=5),
    }


@pytest.mark.parametrize("name", ["uniform", "disc", "plummer"])
def test_bh_accelerations_match_jax(name):
    pos, mass = _systems()[name]
    n = len(pos)
    got = tb.bh_accelerations(as_t(pos), as_t(mass),
                              nt.SimConfig(n=n, force_backend="bh"))
    ref = jb.bh_accelerations(jnp.asarray(pos), jnp.asarray(mass),
                              JaxConfig(n=n, force_backend="bh"))
    assert bool(torch.isfinite(got).all())
    _close(got, ref)
    # The CPU wrappers run the plain versions: both routes agree exactly.
    plain = tb.bh_accelerations(as_t(pos), as_t(mass),
                                nt.SimConfig(n=n, force_backend="bh"),
                                use_kernels=False)
    np.testing.assert_array_equal(as_np(got), as_np(plain))


def test_bh_dispatch_and_one_simulation_step_match_jax():
    jcfg = JaxConfig(n=1024, force_backend="bh", enable_collisions=False)
    state = nb.init_scene("uniform_disc", jcfg)
    ref = jax_make_step(jcfg)(state)
    cfg = nt.SimConfig(n=1024, force_backend="bh", enable_collisions=False)
    sim = nt.Simulation(cfg, state=to_port(state), device=CPU)
    assert sim.config.force_backend == "bh"
    sim.step()
    for field in ("pos", "vel", "acc"):
        _close(getattr(sim.state, field), getattr(ref, field))
    assert sim.frame == 1
    acc = nt.compute_accelerations(to_port(state).pos, to_port(state).mass,
                                   cfg)
    _close(acc, jforces.compute_accelerations(state.pos, state.mass, jcfg))


@pytest.mark.parametrize("n_hot", [0, 60_000])
def test_resolve_config_for_state_agrees_on_the_deep_chain(n_hot):
    """'auto' at N = 100k picks the tree; where the JAX package turns the
    deep-overflow chain on (overflow > _OVERFLOW_CAP), so does the port,
    with the same warning, and both pin the same configuration."""
    n = 100_000
    pos, mass = _clustered(n, n_hot, seed=9)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jcfg = jforces.resolve_config_for_state(
            jnp.asarray(pos), jnp.asarray(mass), JaxConfig(n=n))
    cfg = nt.SimConfig(n=n, enable_collisions=False)
    over = tb.bh_near_overflow(as_t(pos), as_t(mass), cfg)
    assert over == jb.bh_near_overflow(jnp.asarray(pos), jnp.asarray(mass),
                                       JaxConfig(n=n))
    fields = ("force_backend", "bh_deep_levels", "bh_tile_levels",
              "bh_nf_sparse")
    if jcfg.bh_deep_levels != 0:
        assert n_hot and over > tb._OVERFLOW_CAP
        with pytest.warns(RuntimeWarning, match="deep-overflow"):
            got = tforces.resolve_config_for_state(as_t(pos), as_t(mass),
                                                   cfg)
        with pytest.warns(RuntimeWarning, match="deep-overflow"):
            sim = nt.Simulation(cfg, state=nt.ParticleState.create(
                as_t(pos), torch.zeros(n, 2), as_t(mass)), device=CPU)
        assert sim.config.bh_deep_levels == -1
        assert sim.check_capacity() is False
    else:
        assert not n_hot
        got = tforces.resolve_config_for_state(as_t(pos), as_t(mass), cfg)
    assert tuple(getattr(got, f) for f in fields) == tuple(
        getattr(jcfg, f) for f in fields)


def test_explicit_bh_overflow_warns_and_deep_chain_raises():
    """An explicit "bh" past the residual's cap warns; the deep chain runs
    and matches the JAX package on a small system, in 2D and (without
    tiles, which keeps JAX's compile short) in 3D."""
    n = 40_000
    pos, mass = _clustered(n, 30_000, seed=11)
    state = nt.ParticleState.create(as_t(pos), torch.zeros(n, 2), as_t(mass))
    cfg = nt.SimConfig(n=n, force_backend="bh", enable_collisions=False)
    with pytest.warns(RuntimeWarning, match="residual capacity"):
        sim = nt.Simulation(cfg, state=state, device=CPU)
    assert sim.check_capacity() is True
    deep = cfg.replace(n=64, bh_deep_levels=-1)
    acc = tb.bh_accelerations(as_t(pos[:64]), as_t(mass[:64]), deep)
    ref = jb.bh_accelerations(jnp.asarray(pos[:64]), jnp.asarray(mass[:64]),
                              JaxConfig(n=64, force_backend="bh",
                                        bh_deep_levels=-1))
    assert bool(torch.isfinite(acc).all())
    _close(acc, ref)
    # 3D: the octree runs, and so does its deep chain.
    pos3, mass3 = rand_system(64, dim=3)
    acc3 = tb.bh_accelerations(as_t(pos3), as_t(mass3), cfg.replace(dim=3))
    assert acc3.shape == (64, 3) and bool(torch.isfinite(acc3).all())
    # 40 of the 64 bodies in one level-2 cell: past its 16 slots.
    pos3[:40] = 0.01 * pos3[:40] + 100.0
    deep3 = dict(dim=3, bh_deep_levels=-1, bh_tile_levels=0)
    assert tb3.bh3_near_overflow(as_t(pos3), as_t(mass3),
                                 cfg.replace(n=64, dim=3)) > 0
    acc3 = tb.bh_accelerations(as_t(pos3), as_t(mass3), cfg.replace(
        n=64, **deep3))
    ref3 = jb.bh_accelerations(jnp.asarray(pos3), jnp.asarray(mass3),
                               JaxConfig(n=64, force_backend="bh", **deep3))
    assert bool(torch.isfinite(acc3).all())
    _close(acc3, ref3)


@pytest.mark.parametrize("cfg", [
    {}, {"bh_levels": 7, "bh_accept_radius": 2}, {"theta": 0.3},
    {"bh_deep_levels": -1}, {"bh_deep_levels": 12, "bh_tile_size": 16},
    {"bh_deep_levels": -1, "bh_tile_levels": 0}])
def test_resolved_tree_parameters_match_jax(cfg):
    """Levels, radius, deep-chain depth and tile parameters resolve as in
    the JAX package."""
    n = 50_000
    tcfg, jcfg = nt.SimConfig(n=n, **cfg), JaxConfig(n=n, **cfg)
    levels = tb._resolve_levels(tcfg, n)
    assert levels == jb._resolve_levels(jcfg, n)
    radius = tb._resolve_radius(tcfg)
    assert radius == jb._resolve_radius(jcfg)
    deep = tb._resolve_deep_levels(tcfg, levels)
    assert deep == jb._resolve_deep_levels(jcfg, levels)
    assert tb._resolve_tile_params(tcfg, deep, radius) == \
        jb._resolve_tile_params(jcfg, deep, radius)

