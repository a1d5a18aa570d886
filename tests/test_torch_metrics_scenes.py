"""PyTorch port: diagnostics and HUD metrics against the JAX package on the
same state, and the ported scenes against the constants and statistics that
tests/test_scenes.py checks for the JAX scenes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbodysim_tpu as nb
import nbodysim_tpu_torch as nt
from nbodysim_tpu.diagnostics import metrics as jmetrics
from nbodysim_tpu.scenes.disc import _lorenz_positions as jax_lorenz
from nbodysim_tpu_torch.diagnostics import metrics as tmetrics
from nbodysim_tpu_torch.scenes.disc import (
    CENTRAL_MASS, CENTRAL_RADIUS, OUTER_RADIUS_COEF, _lorenz_positions,
    uniform_disc)
from nbodysim_tpu_torch.scenes.kepler import kepler_period

from _torch_helpers import CPU, as_np, to_port

# f32 sums over a few hundred terms, in another order than XLA's.
REL = 1e-5


def _jax_disc_after(steps, n_bodies=512):
    cfg = nb.SimConfig(n=n_bodies, force_backend="xla")
    return nb.Simulation(cfg, scene="uniform_disc").run(steps), cfg


def _jax_cloud_3d(n_bodies=300, seed=3):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-500, 500, (n_bodies, 3)).astype(np.float32)
    vel = rng.uniform(-5, 5, (n_bodies, 3)).astype(np.float32)
    mass = rng.uniform(0.1, 10.0, n_bodies).astype(np.float32)
    return nb.ParticleState.create(pos, vel, mass), nb.SimConfig(
        n=n_bodies, dim=3, force_backend="xla")


@pytest.mark.parametrize("which", ["disc2d", "cloud3d"])
def test_diagnostics_match_jax(which):
    jstate, jcfg = _jax_disc_after(5) if which == "disc2d" else _jax_cloud_3d()
    tcfg = nt.SimConfig(n=jcfg.n, dim=jcfg.dim)
    ours = tmetrics.diagnostics(to_port(jstate), tcfg)
    ref = jmetrics.diagnostics(jstate, jcfg)
    for field in ref._fields:
        a, b = as_np(getattr(ours, field)), np.asarray(getattr(ref, field))
        assert a.shape == b.shape, field
        # Momentum and COM cancel between bodies: scale by the magnitudes.
        if field == "momentum":
            scale = np.abs(np.asarray(jstate.mass)[:, None]
                           * np.asarray(jstate.vel)).sum()
        elif field == "center_of_mass":
            scale = np.abs(np.asarray(jstate.pos)).max()
        elif field == "angular_momentum":
            p, v, m = (np.asarray(jstate.pos), np.asarray(jstate.vel),
                       np.asarray(jstate.mass))
            scale = (m * np.linalg.norm(p, axis=-1)
                     * np.linalg.norm(v, axis=-1)).sum()
        else:
            scale = np.abs(b).max()
        np.testing.assert_allclose(a, b, atol=REL * scale, err_msg=field)


@pytest.mark.parametrize("dt_scaled", [False, True])
def test_system_metrics_match_jax(dt_scaled):
    jstate, jcfg = _jax_disc_after(5)
    ours = tmetrics.system_metrics(to_port(jstate), nt.SimConfig(n=512),
                                   dt_scaled=dt_scaled)
    ref = jmetrics.system_metrics(jstate, jcfg, dt_scaled=dt_scaled)
    assert set(ours) == set(ref)
    assert int(ours["stable_bodies"]) == int(ref["stable_bodies"]) > 400
    for k, v in ref.items():
        np.testing.assert_allclose(as_np(ours[k]), np.asarray(v), rtol=REL,
                                   err_msg=k)


def test_simulation_metrics_and_energy_tracker():
    jstate, jcfg = _jax_disc_after(0, 256)
    sim = nt.Simulation(nt.SimConfig(n=256), state=to_port(jstate),
                        device=CPU)
    assert int(sim.system_metrics()["stable_bodies"]) > 0
    tracker = tmetrics.EnergyTracker(sim.config)
    jtracker = jmetrics.EnergyTracker(jcfg)
    assert tracker.max_drift == 0.0
    assert tracker.update(sim.state) == 0.0
    jtracker.update(jstate)
    sim.run(3)
    drift = tracker.update(sim.state)
    jdrift = jtracker.update(nb.Simulation(jcfg, state=jstate).run(3))
    assert drift == tracker.max_drift > 0
    assert abs(drift - jdrift) <= 1e-3 * jdrift + 1e-6
    assert float(sim.diagnostics().total_energy) == tracker.history[-1]


# -- scenes -------------------------------------------------------------------

def test_lorenz_track_matches_jax():
    np.testing.assert_allclose(_lorenz_positions(200),
                               np.asarray(jax_lorenz(200, jnp.float32)),
                               rtol=1e-4, atol=1e-4)


def test_uniform_disc_structure():
    state = uniform_disc(nt.SimConfig(n=2048), device=CPU)
    assert state.n == 2048 and state.pos.dtype == torch.float32
    assert float(state.mass[0]) == CENTRAL_MASS
    assert float(state.radius[0]) == CENTRAL_RADIUS
    np.testing.assert_array_equal(as_np(state.pos[0]), 0.0)
    r = np.linalg.norm(as_np(state.pos), axis=-1)
    assert np.all(np.diff(r) >= 0)
    assert r[-1] < np.sqrt(2048) * OUTER_RADIUS_COEF * 5


def test_uniform_disc_mass_buckets():
    state = uniform_disc(nt.SimConfig(n=20000), device=CPU)
    m = as_np(state.mass[1:])
    # The bucket weights {82.5%, 12.5%, 2.5%} sum to 0.975 and are
    # normalized (as in the JAX scene), so the expected fractions are
    # weight / 0.975; the bounds are ~4 standard errors at N=20k.
    assert abs(np.mean(m <= 0.8) - 0.825 / 0.975) < 0.01
    assert abs(np.mean((m >= 1.2) & (m <= 2.5)) - 0.125 / 0.975) < 0.01
    assert abs(np.mean(m >= 5.0) - 0.025 / 0.975) < 0.005
    assert m.min() >= 0.00005 and m.max() <= 50.0
    np.testing.assert_allclose(as_np(state.radius[1:]), np.cbrt(m), rtol=1e-5)


def test_uniform_disc_tangential_velocity():
    state = uniform_disc(nt.SimConfig(n=512), device=CPU)
    pos, vel = as_np(state.pos[1:]), as_np(state.vel[1:])
    mass = as_np(state.mass)
    r = np.linalg.norm(pos, axis=-1)
    dots = np.abs(np.sum(pos * vel, axis=-1))
    assert np.all(dots < 1e-2 * r * np.linalg.norm(vel, axis=-1) + 1e-5)
    expected = np.sqrt(np.cumsum(mass)[1:] / r)
    np.testing.assert_allclose(np.linalg.norm(vel, axis=-1), expected,
                               rtol=1e-3)


def test_uniform_disc_determinism_and_jax_geometry():
    cfg = nt.SimConfig(n=256, seed=7)
    a = uniform_disc(cfg, device=CPU)
    b = nt.init_scene("uniform_disc", cfg, device=CPU)
    np.testing.assert_array_equal(as_np(a.pos), as_np(b.pos))
    np.testing.assert_array_equal(as_np(a.mass), as_np(b.mass))
    c = uniform_disc(cfg.replace(seed=8), device=CPU)
    assert not np.array_equal(as_np(a.mass), as_np(c.mass))
    # Positions depend on the Lorenz track only: the same set as JAX's.
    jpos = np.asarray(nb.init_scene("uniform_disc", nb.SimConfig(n=128)).pos)
    np.testing.assert_allclose(
        as_np(uniform_disc(nt.SimConfig(n=128), device=CPU).pos), jpos,
        rtol=1e-4, atol=1e-2)
    bug = uniform_disc(cfg, ref_normalize_bug=True, device=CPU)
    assert not np.allclose(as_np(bug.vel), as_np(a.vel))
    with pytest.raises(ValueError):
        uniform_disc(nt.SimConfig(n=64, dim=3), device=CPU)


def test_uniform_square_is_the_throughput_input():
    """At N = 2^20 the square's positions and masses are the headline
    throughput input (`profiling.measure_force_throughput`: one generator
    seeded 0, positions uniform in +-3e4 first, then masses in [0.1, 10])
    bit for bit; only the velocities, uniform in +-5, follow the seed; the
    half-width keeps that density at any n."""
    from nbodysim_tpu_torch.core.state import cbrt
    from nbodysim_tpu_torch.scenes.square import square_half_width

    n = 1 << 20
    g = torch.Generator(device=CPU)
    g.manual_seed(0)
    pos = -30000.0 + 60000.0 * torch.rand((n, 2), generator=g, device=CPU)
    mass = 0.1 + 9.9 * torch.rand(n, generator=g, device=CPU)
    a = nt.init_scene("uniform_square", nt.SimConfig(n=n, seed=3),
                      device=CPU)
    assert torch.equal(a.pos, pos) and torch.equal(a.mass, mass)
    assert torch.equal(a.radius, cbrt(mass))
    assert float(a.vel.abs().max()) <= 5.0
    assert abs(float(a.vel.mean())) < 0.02
    assert square_half_width(n) == 30000.0
    b = nt.init_scene("uniform_square", nt.SimConfig(n=4096, seed=3),
                      device=CPU)
    c = nt.init_scene("uniform_square", nt.SimConfig(n=4096, seed=4),
                      device=CPU)
    assert torch.equal(b.pos, c.pos) and torch.equal(b.mass, c.mass)
    assert not torch.equal(b.vel, c.vel)
    assert float(b.pos.abs().max()) <= 30000.0 / 16
    # The velocities' generator is seeded 2 * seed + 1, never the layout's
    # 0: at seed 0 they are not the positions scaled.
    g = torch.Generator(device=CPU)
    g.manual_seed(7)
    assert torch.equal(b.vel, -5.0 + 10.0 * torch.rand(
        (4096, 2), generator=g, device=CPU))
    z = nt.init_scene("uniform_square", nt.SimConfig(n=4096, seed=0),
                      device=CPU)
    assert torch.equal(z.pos, b.pos)
    corr = torch.corrcoef(torch.stack([z.pos[:, 0], z.vel[:, 0]]))[0, 1]
    assert abs(float(corr)) < 0.1
    with pytest.raises(ValueError):
        nt.init_scene("uniform_square", nt.SimConfig(n=64, dim=3),
                      device=CPU)


@pytest.mark.parametrize("dim", [2, 3])
def test_kepler_scenes(dim):
    cfg = nt.SimConfig(n=64, dim=dim)
    orbit = nt.init_scene("kepler", cfg, device=CPU, eccentricity=0.5)
    jorbit = nb.init_scene("kepler", nb.SimConfig(n=64, dim=dim),
                           eccentricity=0.5)
    np.testing.assert_array_equal(as_np(orbit.pos), np.asarray(jorbit.pos))
    np.testing.assert_array_equal(as_np(orbit.vel), np.asarray(jorbit.vel))
    p = as_np((orbit.mass[:, None] * orbit.vel).sum(0))
    np.testing.assert_allclose(p, 0.0, atol=1e-3)
    assert kepler_period(cfg, 1e6, 1.0, 1000.0) == pytest.approx(
        2 * np.pi * np.sqrt(1000.0 ** 3 / (1e6 + 1.0)))

    system = nt.init_scene("kepler_system", cfg, device=CPU)
    assert system.pos.shape == (64, dim)
    r = np.linalg.norm(as_np(system.pos[1:]), axis=-1)
    np.testing.assert_allclose(r, np.linspace(500.0, 5000.0, 63), rtol=1e-5)
    speed = np.linalg.norm(as_np(system.vel[1:]), axis=-1)
    np.testing.assert_allclose(speed, np.sqrt(1e6 / r), rtol=1e-5)
    radial = np.sum(as_np(system.pos[1:]) * as_np(system.vel[1:]), -1)
    np.testing.assert_allclose(radial, 0.0, atol=1e-2 * r.max())
