"""PyTorch port, the Plummer scene (BASELINE config 2): the port's
deterministic transform fed the JAX scene's own `jax.random` draws (the
same split keys as nbodysim_tpu/scenes/plummer.py) against
`nbodysim_tpu.scenes.plummer_sphere`, in 2D and 3D at N = 4096, virialized.

Tolerance: rtol 1e-5 plus atol 1e-5 of each field's largest magnitude; XLA's
and torch's pow, sqrt and norm may differ in the last bit, and the
virializing potential is summed in another order.
"""

import jax
import numpy as np
import pytest
import torch

import nbodysim_tpu as nb
import nbodysim_tpu_torch as nt
from nbodysim_tpu.scenes import plummer_sphere as jax_plummer
from nbodysim_tpu_torch.scenes.plummer import (
    N_CAND, U_RANGE, Y_RANGE, plummer_from_draws)

from _torch_helpers import CPU, as_np, as_t


def _jax_draws(seed, n, dim):
    """The five draws of nbodysim_tpu/scenes/plummer.py, in its key order."""
    k_r, k_dir, k_q, k_vdir = jax.random.split(jax.random.PRNGKey(seed), 4)
    kq1, kq2 = jax.random.split(k_q)
    f32 = np.float32
    return tuple(as_t(np.array(a)) for a in (
        jax.random.uniform(k_r, (n,), f32, *U_RANGE),
        jax.random.normal(k_dir, (n, dim), f32),
        jax.random.uniform(kq1, (n, N_CAND), f32),
        jax.random.uniform(kq2, (n, N_CAND), f32, *Y_RANGE),
        jax.random.normal(k_vdir, (n, dim), f32)))


@pytest.mark.parametrize("dim", [2, 3])
def test_plummer_matches_jax_from_its_draws(dim):
    n, seed = 4096, 3
    jcfg = nb.SimConfig(n=n, dim=dim, seed=seed, force_backend="xla")
    jstate = jax_plummer(jcfg)
    pos, vel, mass = plummer_from_draws(
        *_jax_draws(seed, n, dim), total_mass=1.0e4, scale_radius=1000.0,
        g_const=jcfg.g_const, eps_sq=jcfg.eps_sq, virialize=True)
    state = nt.ParticleState.create(pos, vel, mass)
    for name in ("pos", "vel", "mass", "radius"):
        ref = np.asarray(getattr(jstate, name))
        got = as_np(getattr(state, name))
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)


def test_plummer_scene_on_the_port():
    """The scene as a user calls it: on the requested device, equal masses,
    centred with zero momentum, virialized (2K = -U), deterministic in the
    seed; virialize=False keeps the sampled speeds."""
    cfg = nt.SimConfig(n=1024, dim=3, seed=1)
    state = nt.init_scene("plummer", cfg, device=CPU)
    assert state.pos.shape == (1024, 3) and state.device == CPU
    assert bool(torch.isfinite(state.pos).all()
                and torch.isfinite(state.vel).all())
    assert torch.allclose(state.mass, torch.full((1024,), 1e4 / 1024))
    m = state.mass[:, None]
    assert float((m * state.pos).sum(0).abs().max()) < 1e-3 * float(
        (m * state.pos.abs()).sum())
    assert float((m * state.vel).sum(0).abs().max()) < 1e-3 * float(
        (m * state.vel.abs()).sum())
    kin = 0.5 * float((state.mass * (state.vel ** 2).sum(-1)).sum())
    pot = float(nt.physics.forces.potential_energy(state.pos, state.mass,
                                                   cfg.eps_sq))
    assert 2.0 * kin == pytest.approx(-pot, rel=1e-4)
    again = nt.init_scene("plummer", cfg, device=CPU)
    assert torch.equal(again.pos, state.pos)
    raw = nt.init_scene("plummer", cfg, device=CPU, virialize=False)
    assert torch.equal(raw.pos, state.pos)
    assert not torch.equal(raw.vel, state.vel)
    assert nt.init_scene("plummer", nt.SimConfig(n=64), device=CPU).dim == 2
