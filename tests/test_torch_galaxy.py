"""PyTorch port, the galaxy-merger scene (BASELINE config 5): the port's
deterministic transform fed the JAX scene's own `jax.random` draws (the
same split keys as nbodysim_tpu/scenes/galaxy.py) against
`nbodysim_tpu.scenes.galaxy_merger`, at N = 4096.

Tolerance: rtol 1e-5 plus atol 1e-5 of each field's largest magnitude; XLA's
and torch's log1p, sin, cos, sqrt and cbrt may differ in the last bit."""

import math

import jax
import numpy as np
import pytest
import torch

import nbodysim_tpu as nb
import nbodysim_tpu_torch as nt
from nbodysim_tpu.scenes import galaxy_merger as jax_merger
from nbodysim_tpu_torch.scenes.galaxy import (
    MASS_RANGE, PHI_RANGE, U_RANGE, merger_from_draws, merger_sizes)

from _torch_helpers import CPU, as_np, as_t


def _jax_draws(key, m):
    """The three uniform draws of one disc, as _single_disc takes them."""
    k_r, k_phi, k_m = jax.random.split(key, 3)
    return tuple(as_t(np.array(jax.random.uniform(k, (m,), np.float32,
                                                  *rng)))
                 for k, rng in ((k_r, U_RANGE), (k_phi, PHI_RANGE),
                                (k_m, MASS_RANGE)))


@pytest.mark.parametrize("dim", [2, 3])
def test_merger_matches_jax_from_its_draws(dim):
    n, seed = 4096, 3
    jstate = jax_merger(nb.SimConfig(n=n, dim=dim, seed=seed))
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    sizes = merger_sizes(n, 5.0e8, 1.0)
    pos, vel, mass = merger_from_draws(
        _jax_draws(k1, n // 2 - 1), _jax_draws(k2, n - n // 2 - 1), dim=dim,
        g_const=1.0, central_mass=5.0e8, disc_radius=sizes[0],
        separation=sizes[1], impact_parameter=sizes[2],
        approach_speed=sizes[3])
    state = nt.ParticleState.create(pos, vel, mass)
    for name in ("pos", "vel", "mass", "radius"):
        ref = np.asarray(getattr(jstate, name))
        got = as_np(getattr(state, name))
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)


def test_merger_scene_on_the_port():
    """The scene as a user calls it: two discs of n/2 with central masses,
    finite, on the requested device, deterministic in the seed."""
    cfg = nt.SimConfig(n=2048, seed=1)
    state = nt.init_scene("galaxy_merger", cfg, device=CPU)
    assert state.pos.shape == (2048, 2) and state.device == CPU
    assert bool(torch.isfinite(state.pos).all() and
                torch.isfinite(state.vel).all())
    assert float(state.mass[0]) == float(state.mass[1024]) == 5.0e8
    r_disc = merger_sizes(2048, 5.0e8, 1.0)[0]
    assert r_disc == pytest.approx(math.sqrt(1024) * 150.0, rel=1e-6)
    again = nt.init_scene("galaxy_merger", cfg, device=CPU)
    assert torch.equal(again.pos, state.pos)
    other = nt.init_scene("galaxy_merger", cfg.replace(seed=2), device=CPU)
    assert not torch.equal(other.pos, state.pos)
    # Disc 1 centred at (-1.5 R, -R/4), moving +x; disc 2 mirrored.
    np.testing.assert_allclose(as_np(state.pos[0]), [-1.5 * r_disc,
                                                     -0.25 * r_disc],
                               rtol=1e-6)
    assert float(state.vel[0, 0]) > 0 > float(state.vel[1024, 0])
