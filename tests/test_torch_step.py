"""PyTorch port: the step, the rollout and the Simulation API against the
JAX package on the CPU, from JAX-generated disc states, and the Kepler
trajectory against the native C++ oracle.

Tolerances: one step from the same state at 1e-5 * max|x| and 1e-5 * max|v|;
free rollouts at 1e-4 * max|x| (tests/test_oracle_parity.py:72-75), since f32
rounding differences grow along a trajectory.
"""

import shutil

import numpy as np
import pytest

import nbodysim_tpu as nb
import nbodysim_tpu_torch as nt
from nbodysim_tpu.physics.integrators import make_rollout as jax_rollout
from nbodysim_tpu.physics.integrators import (
    prime_accelerations as jax_prime)
from nbodysim_tpu_torch.physics.integrators import (
    make_rollout, prime_accelerations)

from _torch_helpers import CPU, as_np, as_t, to_port

N_DISC = 1024


def _configs(**kw):
    return (nb.SimConfig(n=N_DISC, force_backend="xla", **kw),
            nt.SimConfig(n=N_DISC, **kw))


def _close(ours, ref, rel, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(as_np(ours), ref, atol=rel * np.abs(ref).max(),
                               err_msg=what)


@pytest.mark.parametrize("integrator", ["euler_symplectic", "leapfrog_kdk"])
@pytest.mark.parametrize("collisions", [True, False])
def test_step_parity_from_jax_states(integrator, collisions):
    """Ten steps: the JAX state at each step goes through one port step and
    one JAX step, and the two results agree."""
    jcfg, tcfg = _configs(integrator=integrator,
                          enable_collisions=collisions)
    state = nb.init_scene("uniform_disc", jcfg)
    if integrator == "leapfrog_kdk":
        state = jax_prime(state, jcfg)
        primed = prime_accelerations(to_port(state), tcfg)
        _close(primed.acc, state.acc, 1e-5, "primed acc")
    jstep = nb.make_step(jcfg)
    tstep = nt.make_step(tcfg)
    for k in range(10):
        nxt = jstep(state)
        ours = tstep(to_port(state))
        _close(ours.pos, nxt.pos, 1e-5, f"pos, step {k}")
        _close(ours.vel, nxt.vel, 1e-5, f"vel, step {k}")
        _close(ours.acc, nxt.acc, 1e-5, f"acc, step {k}")
        assert int(ours.frame) == int(nxt.frame)
        state = nxt


def test_free_rollout_matches_jax():
    jcfg, tcfg = _configs()
    state = nb.init_scene("uniform_disc", jcfg)
    ref = jax_rollout(jcfg, 20)(state)
    ours = make_rollout(tcfg, 20)(to_port(state))
    _close(ours.pos, ref.pos, 1e-4, "pos after 20 steps")
    assert int(ours.frame) == 20


@pytest.mark.parametrize("integrator", ["euler_symplectic", "leapfrog_kdk"])
def test_simulation_run_matches_jax(integrator):
    jcfg = nb.SimConfig(n=512, integrator=integrator)
    tcfg = nt.SimConfig(n=512, integrator=integrator)
    state = nb.init_scene("uniform_disc", jcfg)
    jsim = nb.Simulation(jcfg, state=state)
    sim = nt.Simulation(tcfg, state=to_port(state), device="cpu")
    assert (sim.config.force_backend, jsim.config.force_backend) == \
        ("torch", "xla")
    jsim.run(10)
    sim.run(6)
    sim.step()
    sim.run(3)
    assert sim.frame == jsim.frame == 10
    _close(sim.state.pos, jsim.state.pos, 1e-4, "pos")
    _close(sim.state.vel, jsim.state.vel, 1e-4, "vel")
    d, jd = sim.diagnostics(), jsim.diagnostics()
    for k in ("kinetic", "potential", "total_energy"):
        assert abs(float(getattr(d, k)) - float(getattr(jd, k))) <= \
            1e-4 * abs(float(getattr(jd, k))), k
    out = nt.simulate(to_port(state), tcfg, 10)
    np.testing.assert_array_equal(as_np(out.pos), as_np(sim.state.pos))


def test_simulate_leaves_the_state_probes_to_simulation(monkeypatch):
    """The JAX package's `simulate` primes leapfrog and rolls out; it never
    probes the state. Neither does the port's: with both probes made to
    raise, `simulate` still runs (and matches the rollout), while
    `Simulation` still probes."""
    from nbodysim_tpu_torch import api

    def probe(*args, **kwargs):
        raise AssertionError("the state was probed")

    monkeypatch.setattr(api, "resolve_config_for_state", probe)
    monkeypatch.setattr(api, "resolve_collision_phase_for_state", probe)
    tcfg = nt.SimConfig(n=512, integrator="leapfrog_kdk")
    state = to_port(nb.init_scene("uniform_disc", nb.SimConfig(n=512)))
    out = nt.simulate(state, tcfg, 3)
    ref = make_rollout(tcfg, 3)(prime_accelerations(state, tcfg))
    np.testing.assert_array_equal(as_np(out.pos), as_np(ref.pos))
    with pytest.raises(AssertionError, match="probed"):
        nt.Simulation(tcfg, state=state, device="cpu")


def test_simulate_matches_jax_with_auto_fields_unpinned():
    """`simulate` on the tree with bh_nf_sparse = -1 left unpinned, as the
    JAX package's `simulate` takes it (its force path reads -1 as off
    without the deep chain); leapfrog, collisions on."""
    kw = dict(n=1024, force_backend="bh", integrator="leapfrog_kdk")
    jcfg, tcfg = nb.SimConfig(**kw), nt.SimConfig(**kw)
    assert jcfg.bh_nf_sparse == tcfg.bh_nf_sparse == -1
    state = nb.init_scene("uniform_disc", jcfg)
    ref = nb.simulate(state, jcfg, 4)
    out = nt.simulate(to_port(state), tcfg, 4)
    assert int(out.frame) == int(ref.frame) == 4
    _close(out.pos, ref.pos, 1e-4, "pos")
    _close(out.vel, ref.vel, 1e-4, "vel")


def test_set_dt_and_clamp_dt():
    sim = nt.Simulation(nt.SimConfig(n=64), device=CPU)
    assert sim.dt == 0.01
    sim.set_dt(0.02)
    assert sim.dt == 0.02 and sim.config.dt == 0.02
    sim.run(2)
    assert sim.frame == 2
    assert nt.api.clamp_dt(0.5) == (0.1, True)
    assert nt.api.clamp_dt(0.05) == (0.05, False)
    assert nt.api.clamp_dt(1e-5) == (0.001, True)
    assert sim.check_capacity() is False


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ toolchain")
def test_kepler_trajectory_matches_oracle():
    """N=2 Kepler, unsoftened, 200 steps of the reference step: the port
    tracks the native oracle step for step."""
    from nbodysim_tpu_torch.oracle import oracle_step

    cfg = nt.SimConfig(n=2, dt=0.02, softening=0.0, enable_collisions=False)
    state = nt.init_scene("kepler", cfg, device=CPU, central_mass=1e6,
                          semi_major=1000.0, eccentricity=0.2)
    jstate = nb.init_scene("kepler", nb.SimConfig(n=2), central_mass=1e6,
                           semi_major=1000.0, eccentricity=0.2)
    np.testing.assert_array_equal(as_np(state.pos), np.asarray(jstate.pos))
    np.testing.assert_array_equal(as_np(state.vel), np.asarray(jstate.vel))
    np.testing.assert_allclose(as_np(state.radius), np.asarray(jstate.radius),
                               rtol=1e-6)
    step = nt.make_step(cfg)
    o_state = state
    for _ in range(200):
        state = step(state)
        o_pos, o_vel = oracle_step(o_state, cfg)
        o_state = o_state.replace(pos=as_t(o_pos), vel=as_t(o_vel))
    np.testing.assert_allclose(as_np(state.pos), as_np(o_state.pos),
                               atol=np.abs(as_np(o_state.pos)).max() * 1e-4)
