"""PyTorch port, the rest of the product surface against the JAX package,
on the CPU: the spiral and Kuzmin scenes (their deterministic transforms
fed the JAX scenes' own `jax.random` draws; rtol 1e-5 plus atol 1e-5 of
each field's largest magnitude), the profiling meters and `trace`,
`Simulation.re_resolve_auto` (thresholds monkeypatched so N <= 4096
escalates, the escalated fields compared with the JAX package's on the
same state), the viewer's controls and animation (headless under Agg), and
the energy-drift gate at a small size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbodysim_tpu as nb
import nbodysim_tpu_torch as nt
from nbodysim_tpu.scenes.disc import sample_bucket_masses as jax_bucket_masses
from nbodysim_tpu_torch.scenes.kuzmin import (
    kuzmin_from_draws, kuzmin_scale_radius, kuzmin_u_max)
from nbodysim_tpu_torch.scenes.spiral import (
    spiral_from_draws, spiral_outer_radius)

from _torch_helpers import CPU, as_np, as_t


def _close(got, jstate, name):
    ref = np.asarray(getattr(jstate, name))
    got = as_np(got)
    assert got.shape == ref.shape, name
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max(), err_msg=name)


@pytest.mark.parametrize("dim", [2, 3])
def test_spiral_matches_jax_from_its_draws(dim):
    n, seed, m = 4096, 3, 4095
    jstate = nb.init_scene("spiral", nb.SimConfig(n=n, dim=dim, seed=seed))
    k = jax.random.split(jax.random.PRNGKey(seed), 6)

    def normal(key):
        return as_t(np.array(jax.random.normal(key, (m,), np.float32)))

    out = spiral_from_draws(
        as_t(np.array(jax.random.uniform(k[0], (m,), np.float32, 1e-6,
                                         1.0))),
        as_t(np.array(jax.random.randint(k[1], (m,), 0, 2))),
        normal(k[2]), normal(k[3]),
        as_t(np.array(jax_bucket_masses(k[4], m, np.float32))),
        normal(k[5]), dim=dim, g_const=1.0, n_arms=2, pitch=0.28,
        central_mass=1e9, outer_radius=spiral_outer_radius(n),
        arm_scatter=0.12, thickness=0.02)
    for name, got in zip(("pos", "vel", "mass", "radius"), out):
        _close(got, jstate, name)


@pytest.mark.parametrize("dim, dispersion", [(2, 0.0), (3, 0.1)])
def test_kuzmin_matches_jax_from_its_draws(dim, dispersion):
    n, seed = 4096, 3
    jstate = nb.init_scene("kuzmin", nb.SimConfig(n=n, dim=dim, seed=seed),
                           velocity_dispersion=dispersion)
    k_u, k_phi, k_v = jax.random.split(jax.random.PRNGKey(seed), 3)
    out = kuzmin_from_draws(
        as_t(np.array(jax.random.uniform(k_u, (n,), np.float32, 1e-6,
                                         kuzmin_u_max(20.0)))),
        as_t(np.array(jax.random.uniform(k_phi, (n,), np.float32, 0.0,
                                         2.0 * np.pi))),
        as_t(np.array(jax.random.normal(k_v, (n, 2), np.float32))),
        dim=dim, g_const=1.0, total_mass=1e4,
        scale_radius=kuzmin_scale_radius(n), velocity_dispersion=dispersion)
    for name, got in zip(("pos", "vel", "mass", "radius"), out):
        _close(got, jstate, name)


def test_spiral_structure():
    """Mirrors tests/test_scenes.py: the satellites sit on the arms, on
    tangential orbits, about a 1e9 central body of radius 200."""
    state = nt.init_scene("spiral", nt.SimConfig(n=4096), device=CPU,
                          arm_scatter=0.03)
    assert state.n == 4096
    assert float(state.mass[0]) == 1.0e9 and float(state.radius[0]) == 200.0
    pos, vel = as_np(state.pos[1:]), as_np(state.vel[1:])
    r = np.linalg.norm(pos, axis=-1)
    theta = np.log(r / (0.02 * np.sqrt(4096) * 300.7)) / 0.28
    resid = (np.arctan2(pos[:, 1], pos[:, 0]) - theta) % np.pi
    resid = np.minimum(resid, np.pi - resid)
    assert np.median(resid) < 0.3, "satellites not concentrated on arms"
    dots = np.abs(np.sum(pos * vel, axis=-1))
    assert np.all(dots < 1e-2 * r * np.linalg.norm(vel, axis=-1) + 1e-5)


def test_kuzmin_rotation_curve_and_profile():
    total_mass, a = 1.0e9, 500.0
    state = nt.init_scene("kuzmin", nt.SimConfig(n=8192, seed=3),
                          device=CPU, total_mass=total_mass, scale_radius=a)
    pos, vel = as_np(state.pos), as_np(state.vel)
    r = np.linalg.norm(pos, axis=-1)
    v_expected = np.sqrt(total_mass) * r / (r ** 2 + a ** 2) ** 0.75
    np.testing.assert_allclose(np.linalg.norm(vel, axis=-1), v_expected,
                               rtol=1e-4)
    u_med = 0.5 * (1.0 - 1.0 / np.sqrt(1.0 + 20.0 ** 2))
    r_med = a * np.sqrt(1.0 / (1.0 - u_med) ** 2 - 1.0)
    assert abs(np.median(r) - r_med) < 0.05 * r_med


def test_extension_scenes_3d_and_deterministic():
    for name in ("spiral", "kuzmin"):
        cfg = nt.SimConfig(n=256, dim=3)
        state = nt.init_scene(name, cfg, device=CPU)
        assert state.pos.shape == (256, 3) and state.device == CPU
        assert bool(torch.isfinite(state.pos).all()
                    and torch.isfinite(state.vel).all())
        again = nt.init_scene(name, cfg, device=CPU)
        other = nt.init_scene(name, cfg.replace(seed=1), device=CPU)
        assert torch.equal(again.pos, state.pos)
        assert not torch.equal(other.pos, state.pos)


def test_stopwatch_and_throughput_meters():
    from nbodysim_tpu_torch.diagnostics.profiling import (
        Stopwatch, measure_force_throughput, measure_step_throughput)

    sw = Stopwatch()
    with sw.lap():
        pass
    with sw.lap():
        sum(range(1000))
    assert len(sw.laps) == 2 and sw.best >= 0.0
    assert sw.total >= sw.best and sw.rate(10) > 0

    out = measure_force_throughput(256, backend="torch", reps=2, device=CPU)
    assert out["n"] == 256 and out["device"] == "cpu"
    assert out["pairs_per_second"] > 0
    with pytest.raises(ValueError, match="cuda"):
        measure_force_throughput(64, backend="cuda", reps=1, device=CPU)
    step = measure_step_throughput(256, reps=2, laps=1, scene="plummer",
                                   device=CPU, integrator="leapfrog_kdk")
    assert step["steps_per_second"] > 0 and step["device"] == "cpu"


def test_chain_evals_matches_the_loop():
    from nbodysim_tpu_torch.diagnostics.profiling import chain_evals

    x, a = torch.arange(6.0), torch.tensor(2.0)
    fn = lambda c, s: c * s          # noqa: E731
    want = x.clone()
    for _ in range(3):
        want = want + 1e-9 * fn(want, a)
    assert float(chain_evals(fn, 3)(x, a)) == float(want.sum())


def test_trace_writes_a_chrome_trace(tmp_path):
    import json

    from nbodysim_tpu_torch.diagnostics.profiling import trace

    sim = nt.Simulation(nt.SimConfig(n=64, force_backend="torch"),
                        scene="plummer", device=CPU)
    with trace(str(tmp_path / "tr")) as log_dir:
        sim.run(3)
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert log_dir == str(tmp_path / "tr") and len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def _uniform_state(n, seed, span):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-span, span, (n, 2)).astype(np.float32)
    mass = rng.uniform(0.1, 10.0, n).astype(np.float32)
    return pos, mass


def test_re_resolve_auto_enables_deep_midrun(monkeypatch):
    """A scene uniform at init overflows the buckets after 3/4 of it
    collapses into a nucleus: the capacity check trips and re_resolve_auto
    turns the deep chain on, once (monotonic, idempotent), as the JAX
    package's does on the same state (mirrors
    tests/test_misc_coverage.py; N = 4096 with the tree threshold and the
    residual cap lowered in both packages)."""
    import nbodysim_tpu.physics.barneshut as jbh
    import nbodysim_tpu.physics.forces as jforces
    from nbodysim_tpu_torch.physics import barneshut as tbh
    from nbodysim_tpu_torch.physics import forces

    n = 4096
    for mod in (forces, jforces):
        monkeypatch.setattr(mod, "BH_AUTO_THRESHOLD", 1024)
    for mod in (tbh, jbh):
        monkeypatch.setattr(mod, "_OVERFLOW_CAP", 256)
    cfg = nt.SimConfig(n=n, bh_levels=5, enable_collisions=False)
    pos, mass = _uniform_state(n, 0, 1000.0)
    sim = nt.Simulation(cfg, state=nt.ParticleState.create(
        as_t(pos), torch.zeros(n, 2), as_t(mass)), device=CPU)
    assert (sim.config.force_backend, sim.config.bh_deep_levels) == ("bh", 0)
    assert not sim.re_resolve_auto()

    blob = pos.copy()
    blob[: 3 * n // 4] *= 0.002
    sim.state = sim.state.replace(pos=as_t(blob))
    with pytest.warns(RuntimeWarning):
        assert sim.check_capacity(when="after migration")
    with pytest.warns(RuntimeWarning):
        assert sim.re_resolve_auto(when="after migration")
    jcfg = jforces.resolve_config_for_state(
        jnp.asarray(blob), jnp.asarray(mass),
        nb.SimConfig(n=n, bh_levels=5, enable_collisions=False))
    assert sim.config.bh_deep_levels == jcfg.bh_deep_levels == -1
    assert not sim.re_resolve_auto()
    sim.run(1)
    assert bool(torch.isfinite(sim.state.pos).all())


def test_re_resolve_auto_switches_collision_phase_midrun(monkeypatch):
    """The collision analogue: the 'auto' bucket grid overflows after
    mid-run clustering and re_resolve_auto adopts the block pass with
    radius-scaled cells, as the JAX probe does on the same state; a
    leapfrog state is re-primed."""
    from nbodysim_tpu.physics import collisions as jcoll
    from nbodysim_tpu_torch.physics import collisions as tcoll

    n = 4096
    for mod in (tcoll, jcoll):
        monkeypatch.setattr(mod, "DENSE_THRESHOLD", 1024)
        monkeypatch.setattr(mod, "_OVERFLOW_CAP", 256)
    cfg = nt.SimConfig(n=n, force_backend="torch", collision_grid_res=64,
                       integrator="leapfrog_kdk")
    pos, mass = _uniform_state(n, 1, 50000.0)
    sim = nt.Simulation(cfg, state=nt.ParticleState.create(
        as_t(pos), torch.zeros(n, 2), as_t(mass)), device=CPU)
    assert sim.config.collision_broad_phase == "auto"
    assert not sim.re_resolve_auto()

    blob = pos.copy()
    blob[: 3 * n // 4] *= 0.0002
    sim.state = sim.state.replace(pos=as_t(blob),
                                  acc=torch.zeros(n, 2))
    with pytest.warns(RuntimeWarning):
        assert sim.check_capacity(when="after migration")
    with pytest.warns(RuntimeWarning):
        assert sim.re_resolve_auto(when="after migration")
    jstate = nb.ParticleState.create(jnp.asarray(blob), jnp.zeros((n, 2)),
                                     jnp.asarray(mass))
    with pytest.warns(RuntimeWarning):
        jcfg = jcoll.resolve_collision_phase_for_state(
            jstate, nb.SimConfig(n=n, collision_grid_res=64))
    assert (sim.config.collision_broad_phase, sim.config.collision_cell_size
            ) == (jcfg.collision_broad_phase, jcfg.collision_cell_size) == (
        "block", 0.0)
    assert bool(sim.state.acc.abs().sum() > 0)   # re-primed
    assert not sim.re_resolve_auto()


def _viewer(n=64, size=64):
    from nbodysim_tpu_torch.app.viewer import Viewer
    from nbodysim_tpu_torch.render.splat import RenderConfig

    return Viewer(nt.SimConfig(n=n, force_backend="torch"),
                  render_config=RenderConfig(width=size, height=size,
                                             scale=0.01),
                  steps_per_frame=1, device=CPU)


def test_viewer_controls_headless():
    """The reference key map without a display (mirrors
    tests/test_viewer_drift.py); a paused frame equals the JAX renderer's
    frame of the same state, pixel for pixel."""
    from nbodysim_tpu.render.splat import RenderConfig, render_frame

    v = _viewer(n=128, size=96)
    f0 = v.frame()
    assert isinstance(f0, np.ndarray) and f0.shape == (96, 96, 3)
    assert f0.max() > 0
    before = v.sim.frame
    v.on_key(" ")
    paused = v.frame()
    assert v.sim.frame == before and "PAUSED" in v.hud_text()
    jstate = nb.ParticleState(**{k: jnp.asarray(a) for k, a in
                                 v.sim.state.to_numpy().items()})
    want = jax.jit(render_frame, static_argnums=1)(
        jstate, RenderConfig(width=96, height=96, scale=0.01))
    np.testing.assert_array_equal(paused, np.asarray(want))
    v.on_key(" ")
    v.frame()
    assert v.sim.frame == before + 1
    v.on_key("t")
    assert v.sim.dt == pytest.approx(0.015)
    v.on_key("y")
    assert v.sim.dt == pytest.approx(0.015 * 0.666)
    v.on_key("r")
    assert v.rc.scale == pytest.approx(0.0125)
    v.on_key("d")
    assert v.rc.center[0] != 0.0
    v.on_key("q")
    assert v.rc.show_quadtree
    v.on_key("c")
    assert v.rc.show_connections
    v.on_key("p")
    assert v.rc.performance_mode
    v.on_key("v")
    assert v.frame().max() == 0
    assert "PAUSED" not in v.hud_text()


def test_viewer_dt_keys_clamp_to_reference_range():
    from nbodysim_tpu_torch.api import DT_MAX, DT_MIN

    v = _viewer()
    for _ in range(10):
        v.on_key("t")
    assert v.sim.dt == pytest.approx(DT_MAX) and "[MAX]" in v.hud_text()
    for _ in range(20):
        v.on_key("y")
    assert v.sim.dt == pytest.approx(DT_MIN) and "[MAX]" not in v.hud_text()


def test_viewer_animation_runs_headless():
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    v = _viewer()
    fig, anim, update = v.build_animation(interval_ms=1)
    f0 = v.sim.frame
    update(0)
    artists = update(1)
    assert v.sim.frame == f0 + 2 and len(artists) == 2
    assert artists[0].get_array().shape[:2] == (64, 64)
    assert f"frame {f0 + 2}" in artists[1].get_text()
    plt.close(fig)


def test_energy_drift_gate_small():
    """|dE/E| <= 1e-4 over 1k leapfrog steps on a small Plummer sphere
    (the port bench's `drift_gate`; the 10k-step N=4096 gate runs on the
    card in chip_smoke.py)."""
    from nbodysim_tpu_torch.bench import drift_gate

    line = drift_gate(CPU, n=256, steps=1000, chunk=250)
    assert line["passed"] and line["value"] < 1e-4
    assert line["limit"] == 1e-4 and line["device"] == "cpu"
