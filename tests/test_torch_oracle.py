"""PyTorch port: its physics against the native C++ oracle through the
port's own binding (`nbodysim_tpu_torch.oracle`), the North star's second
check: the cases of tests/test_oracle_parity.py (forces at D = 2 and 3, the
potential, the Kepler track, the small disc's full step, one collision
pair), on the port's functions and tensors."""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import nbodysim_tpu_torch as nt
from nbodysim_tpu_torch.core.state import ParticleState
from nbodysim_tpu_torch.physics.collisions import _dense_pass
from nbodysim_tpu_torch.physics.forces import (
    direct_accelerations, potential_energy)

from _torch_helpers import CPU, as_np, as_t, rand_system

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ toolchain")


def test_oracle_builds_into_build_dir():
    from nbodysim_tpu_torch.oracle import build_oracle

    path = Path(build_oracle())
    root = Path(nt.__file__).resolve().parent.parent
    assert path.name == "liboracle.so" and path.exists()
    assert path.parent == root / "build" / "oracle"


@pytest.mark.parametrize("dim", [2, 3])
def test_forces_match_oracle(dim):
    from nbodysim_tpu_torch.oracle import oracle_accelerations

    pos, mass = rand_system(256, dim=dim)
    ours = as_np(direct_accelerations(as_t(pos), as_t(mass), eps_sq=1.0))
    ref = oracle_accelerations(as_t(pos), as_t(mass), eps_sq=1.0)
    np.testing.assert_allclose(ours, ref, atol=np.abs(ref).max() * 1e-5)


def test_potential_matches_oracle():
    from nbodysim_tpu_torch.oracle import oracle_potential_energy

    pos, mass = rand_system(256)
    ours = float(potential_energy(as_t(pos), as_t(mass), 1.0))
    ref = oracle_potential_energy(as_t(pos), as_t(mass), 1.0)
    assert abs(ours - ref) / abs(ref) < 1e-5


def test_kepler_trajectory_matches_oracle():
    """N=2 Kepler, 200 steps of the full reference step (no collision
    fires, boundary and clamp inactive at these scales)."""
    from nbodysim_tpu_torch.oracle import oracle_step

    cfg = nt.SimConfig(n=2, dt=0.02, softening=0.0, enable_collisions=False)
    state = nt.init_scene("kepler", cfg, device=CPU, central_mass=1e6,
                          semi_major=1000.0, eccentricity=0.2)
    step = nt.make_step(cfg)
    o_state = state
    for _ in range(200):
        state = step(state)
        o_pos, o_vel = oracle_step(o_state, cfg)
        o_state = o_state.replace(pos=as_t(o_pos), vel=as_t(o_vel))
    np.testing.assert_allclose(as_np(state.pos), as_np(o_state.pos),
                               atol=np.abs(as_np(o_state.pos)).max() * 1e-4)


def test_full_step_matches_oracle_small_disc():
    """The full step (gravity, clamp, boundary, collisions) on isolated
    overlapping pairs, where the Jacobi and the sequential orders agree."""
    from nbodysim_tpu_torch.oracle import oracle_step

    f32 = np.float32
    state = ParticleState.create(
        as_t(np.array([[0.0, 0.0], [1.5, 0.0], [100.0, 0.0], [101.2, 0.5],
                       [200.0, 200.0]], f32)),
        as_t(np.array([[1.0, 0.0], [-1.0, 0.0], [0.5, 0.2], [-0.3, -0.1],
                       [0.0, 0.0]], f32)),
        as_t(np.array([1.0, 2.0, 1.5, 0.5, 3.0], f32)),
        as_t(np.array([1.0, 1.0, 0.8, 0.9, 1.0], f32)))
    cfg = nt.SimConfig(n=5, dt=0.01)
    ours = nt.make_step(cfg)(state)
    o_pos, o_vel = oracle_step(state, cfg)
    np.testing.assert_allclose(as_np(ours.pos), o_pos, atol=1e-4)
    np.testing.assert_allclose(as_np(ours.vel), o_vel, atol=1e-4)


def test_collision_pair_matches_oracle():
    from nbodysim_tpu_torch.oracle import oracle_resolve_pair

    p1, p2 = [0.0, 0.0], [1.0, 0.5]
    v1, v2 = [2.0, 0.3], [-1.0, -0.2]
    m1, m2, r1, r2 = 2.0, 5.0, 1.0, 0.8
    op1, op2, ov1, ov2, hit = oracle_resolve_pair(
        torch.tensor(p1), torch.tensor(p2), v1, v2, m1, m2, r1, r2)
    assert hit
    state = ParticleState.create(*(
        as_t(np.array(a, np.float32))
        for a in ([p1, p2], [v1, v2], [m1, m2], [r1, r2])))
    out = _dense_pass(state, nt.SimConfig(n=2))
    np.testing.assert_allclose(as_np(out.pos), [op1, op2], atol=1e-5)
    np.testing.assert_allclose(as_np(out.vel), [ov1, ov2], atol=1e-5)


def test_binding_agrees_with_the_jax_packages():
    """The same source behind both bindings: identical numbers."""
    from nbodysim_tpu import oracle as jax_oracle
    from nbodysim_tpu_torch import oracle

    pos, mass = rand_system(64, dim=3, seed=4)
    np.testing.assert_array_equal(
        oracle.oracle_accelerations(pos, mass, 0.5, 2.0),
        jax_oracle.oracle_accelerations(pos, mass, 0.5, 2.0))
    assert oracle.oracle_potential_energy(pos, mass, 0.5) == \
        jax_oracle.oracle_potential_energy(pos, mass, 0.5)
