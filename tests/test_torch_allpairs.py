"""PyTorch port, K1: the plain version of the all-pairs gravity kernel (what
the wrapper runs on a CPU tensor) against the JAX Pallas kernel in interpret
mode and the JAX `direct_accelerations`, and the potential against JAX.

Tolerance: 1e-5 * max|a|, as tests/test_allpairs_kernel.py holds the Pallas
kernel; f32 sums taken in another order differ by far less.
"""

import numpy as np
import pytest

import jax.numpy as jnp
from nbodysim_tpu.kernels.allpairs import allpairs_accelerations as jax_k1
from nbodysim_tpu.kernels.allpairs import (
    allpairs_accelerations_wide as jax_k4)
from nbodysim_tpu.physics import forces as jforces
from nbodysim_tpu_torch.kernels.allpairs import (
    allpairs_accelerations, allpairs_accelerations_plain,
    allpairs_accelerations_wide)
from nbodysim_tpu_torch.physics import forces as tforces

from _torch_helpers import as_np, rand_system, as_t


def _check(pos, mass, eps_sq=1.0, g=1.0, src=None, pallas_kw=None, **tol):
    src_pos, src_mass = src if src is not None else (None, None)
    jkw = dict(eps_sq=eps_sq, g_const=g)
    tkw = dict(jkw)
    if src is not None:
        jkw.update(src_pos=jnp.asarray(src_pos), src_mass=jnp.asarray(src_mass))
        tkw.update(src_pos=as_t(src_pos), src_mass=as_t(src_mass))
    jm = None if mass is None else jnp.asarray(mass)
    tm = None if mass is None else as_t(mass)
    ref = np.asarray(jforces.direct_accelerations(jnp.asarray(pos), jm, **jkw))
    pal = np.asarray(jax_k1(jnp.asarray(pos), jm, interpret=True,
                            **(pallas_kw or {}), **jkw))
    wrapped = as_np(allpairs_accelerations(as_t(pos), tm, **tkw))
    plain = as_np(allpairs_accelerations_plain(as_t(pos), tm, **tkw))
    direct = as_np(tforces.direct_accelerations(as_t(pos), tm, **tkw))
    np.testing.assert_array_equal(wrapped, plain)  # CPU tensor: plain path
    np.testing.assert_array_equal(direct, plain)
    assert np.all(np.isfinite(plain))
    if not tol:
        tol = {"atol": 1e-5 * np.abs(ref).max()}
    np.testing.assert_allclose(plain, ref, **tol)
    np.testing.assert_allclose(plain, pal, **tol)
    return plain


@pytest.mark.parametrize("n_bodies", [4, 100])
def test_plain_matches_jax(n_bodies):
    _check(*rand_system(n_bodies))


def test_plain_matches_jax_multi_tile():
    """Pallas with a 5x3 tile grid; the plain version with 64x128 blocks."""
    pos, mass = rand_system(300, seed=1)
    _check(pos, mass, pallas_kw=dict(block_targets=64, block_sources=128))
    small = as_np(allpairs_accelerations_plain(
        as_t(pos), as_t(mass), eps_sq=1.0, block_size=64))
    ref = np.asarray(jforces.direct_accelerations(pos, mass, eps_sq=1.0))
    np.testing.assert_allclose(small, ref, atol=1e-5 * np.abs(ref).max())


def test_plain_matches_jax_3d():
    _check(*rand_system(64, dim=3, seed=2))


def test_far_from_origin():
    """Broadcast subtraction keeps the near field exact at |x| ~ 1e5 (the
    |x|^2 - 2x.y expansion would not)."""
    base = np.array([50000.0, -70000.0], np.float32)
    pos = np.stack([base, base + np.array([3.0, 4.0], np.float32)])
    _check(pos, np.array([2.0, 8.0], np.float32), rtol=1e-5)


def test_zero_mass_sources_are_inert():
    pos = np.array([[0.0, 0.0], [10.0, 0.0], [0.0, 5.0]], np.float32)
    acc = _check(pos, np.array([1.0, 0.0, 2.0], np.float32), atol=1e-7)
    two = as_np(allpairs_accelerations_plain(
        as_t(pos[[0, 2]]), as_t(np.array([1.0, 2.0], np.float32)), eps_sq=1.0))
    np.testing.assert_allclose(acc[[0, 2]], two, atol=1e-7)


def test_unsoftened_coincident_pair_is_finite():
    pos, mass = rand_system(40, seed=3)
    pos[17] = pos[5]
    acc = _check(pos, mass, eps_sq=0.0)
    assert np.all(np.isfinite(acc))


def test_separate_sources_with_g():
    pos, _ = rand_system(50, seed=4)
    src_pos, src_mass = rand_system(70, seed=5)
    _check(pos, None, g=2.5, src=(src_pos, src_mass))


def test_potential_matches_jax():
    pos, mass = rand_system(300, seed=6)
    ref = float(jforces.potential_energy(jnp.asarray(pos), jnp.asarray(mass),
                                         1.0, 2.0))
    ours = float(tforces.potential_energy(as_t(pos), as_t(mass), 1.0, 2.0))
    blocked = float(tforces.potential_energy(as_t(pos), as_t(mass), 1.0, 2.0,
                                             block_size=64))
    assert abs(ours - ref) / abs(ref) < 1e-5
    assert abs(blocked - ref) / abs(ref) < 1e-5
    part = float(tforces._partial_potential(as_t(pos[:100]), as_t(mass[:100]),
                                            as_t(pos), as_t(mass), 1.0))
    jpart = float(jforces._partial_potential(pos[:100], mass[:100], pos,
                                             mass, 1.0))
    assert abs(part - jpart) / abs(jpart) < 1e-5


@pytest.mark.parametrize("dim", [2, 3])
def test_wide_matches_jax(dim):
    """K4's wrapper on a CPU tensor (the plain version with separate
    sources) against the JAX wide Pallas kernel in interpret mode: many
    targets, few sources, one of them massless."""
    pos, _ = rand_system(1000, dim=dim, seed=4)
    src, src_m = rand_system(37, dim=dim, seed=5)
    src_m[3] = 0.0
    got = as_np(allpairs_accelerations_wide(
        as_t(pos), as_t(src), as_t(src_m), eps_sq=1.0, g_const=2.0))
    ref = np.asarray(jax_k4(jnp.asarray(pos), jnp.asarray(src),
                            jnp.asarray(src_m), eps_sq=1.0, g_const=2.0,
                            interpret=True))
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())
    plain = as_np(allpairs_accelerations_plain(
        as_t(pos), None, eps_sq=1.0, g_const=2.0, src_pos=as_t(src),
        src_mass=as_t(src_m)))
    np.testing.assert_array_equal(got, plain)

