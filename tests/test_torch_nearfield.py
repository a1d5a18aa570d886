"""PyTorch port, K3: the plain version of the near-field bucket kernel (what
the wrapper runs on a CPU tensor) against both JAX routes, the XLA stencil
`barneshut._bucket_stencil` and the Pallas kernel `bucket_stencil_pallas`
in interpret mode, as tests/test_barneshut.py holds them to each other.

Tolerance: 1e-5 * max|a|, the JAX test's; f32 sums in another order differ
by far less.
"""

import numpy as np
import pytest

import jax.numpy as jnp
from nbodysim_tpu.kernels.nearfield import bucket_stencil_pallas
from nbodysim_tpu.physics.barneshut import _bucket_stencil as jax_stencil
from nbodysim_tpu_torch.kernels.nearfield import (
    bucket_stencil, bucket_stencil_plain)

from _torch_helpers import as_np, as_t


def _grid(rows, res, cap, rr, seed, fill=0.4):
    """The JAX test's random, partially filled bucket grid, from numpy."""
    rng = np.random.default_rng(seed)
    shape = (rows + 2 * rr, res, cap)
    bx = rng.uniform(-5.0, 5.0, shape).astype(np.float32)
    by = rng.uniform(-5.0, 5.0, shape).astype(np.float32)
    bm = rng.uniform(0.0, 2.0, shape).astype(np.float32)
    bm = np.where(rng.random(shape) < fill, bm, 0.0).astype(np.float32)
    return bx, by, bm


def _port(bx, by, bm, rr, eps_sq, rows):
    plain = bucket_stencil_plain(as_t(bx), as_t(by), as_t(bm), rr, eps_sq,
                                 rows)
    wrapped = bucket_stencil(as_t(bx), as_t(by), as_t(bm), rr=rr,
                             eps_sq=eps_sq, center_rows=rows)
    for p, w in zip(plain, wrapped):   # CPU tensor: the plain path
        np.testing.assert_array_equal(as_np(w), as_np(p))
    return tuple(as_np(a) for a in plain)


@pytest.mark.parametrize("rows,res,cap,rr,seed", [
    (12, 32, 8, 2, 2),     # the JAX test's shape
    (12, 32, 16, 2, 3),    # NEAR_CAP slots
    (8, 24, 8, 1, 4),      # R = 2
])
def test_plain_matches_both_jax_routes(rows, res, cap, rr, seed):
    bx, by, bm = _grid(rows, res, cap, rr, seed)
    ax, ay = _port(bx, by, bm, rr, 1.0, rows)
    jx, jy = (np.asarray(a) for a in jax_stencil(
        jnp.asarray(bx), jnp.asarray(by), jnp.asarray(bm), rr, 1.0, rows))
    px, py = (np.asarray(a) for a in bucket_stencil_pallas(
        jnp.asarray(bx), jnp.asarray(by), jnp.asarray(bm), rr=rr, eps_sq=1.0,
        center_rows=rows, interpret=True))
    assert ax.shape == (rows, res, cap)
    tol = 1e-5 * (np.abs(jx).max() + 1e-9)
    for got, ref_xla, ref_pallas in ((ax, jx, px), (ay, jy, py)):
        np.testing.assert_allclose(got, ref_xla, atol=tol)
        np.testing.assert_allclose(got, ref_pallas, atol=tol)


def test_eps_zero_masks_coincident_pairs():
    """eps = 0: empty slots sit at (0, 0) and a coincident pair must add
    nothing (the d^2 > 0 mask), so the result stays finite."""
    bx, by, bm = _grid(6, 10, 4, 2, 5)
    bx[3, 4, 1], by[3, 4, 1] = bx[3, 4, 0], by[3, 4, 0]
    bm[3, 4, :2] = 1.0
    ax, ay = _port(bx, by, bm, 2, 0.0, 6)
    jx, jy = (np.asarray(a) for a in jax_stencil(
        jnp.asarray(bx), jnp.asarray(by), jnp.asarray(bm), 2, 0.0, 6))
    assert np.isfinite(ax).all() and np.isfinite(ay).all()
    tol = 1e-5 * np.abs(jx).max()
    np.testing.assert_allclose(ax, jx, atol=tol)
    np.testing.assert_allclose(ay, jy, atol=tol)


def test_halo_rows_are_sources_only_and_empty_grid_is_zero():
    bx, by, bm = _grid(4, 8, 4, 2, 6)
    ax, ay = _port(bx, by, np.zeros_like(bm), 2, 1.0, 4)
    assert not ax.any() and not ay.any()
    # Mass only in the halo rows: targets in the edge rows still feel it.
    bm_halo = np.zeros_like(bm)
    bm_halo[:2] = bm[:2]
    ax, _ = _port(bx, by, bm_halo, 2, 1.0, 4)
    assert np.abs(ax[:2]).max() > 0.0 and not ax[2:].any()
