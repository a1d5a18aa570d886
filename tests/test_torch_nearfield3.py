"""PyTorch port, K7: the plain version of the 3D near-field bucket kernel (what
the wrapper runs on a CPU tensor) against both JAX routes, the XLA stencil
`barneshut3d._bucket_stencil3` and the Pallas kernel
`bucket_stencil3_pallas_flat` in interpret mode, on random partially filled
grids at every halo the config allows (rr = 1..4) and at eps = 0.

Tolerance: 1e-5 * max|a|, the JAX tests' for the near field; f32 sums in
another order differ by far less.
"""

import numpy as np
import pytest

import jax.numpy as jnp
from nbodysim_tpu.kernels.nearfield import (
    _FlatLayout3, bucket_stencil3_pallas_flat)
from nbodysim_tpu.physics.barneshut3d import _bucket_stencil3 as jax_stencil
from nbodysim_tpu_torch.kernels.nearfield import (
    bucket_stencil3, bucket_stencil3_plain)

from _torch_helpers import as_np, as_t


def _grid3(rows, res, cap, rr, seed, fill=0.4):
    """A random, partially filled [rows + 2rr, res, res, cap] bucket grid."""
    rng = np.random.default_rng(seed)
    shape = (rows + 2 * rr, res, res, cap)
    b = [rng.uniform(-5.0, 5.0, shape).astype(np.float32) for _ in range(3)]
    bm = rng.uniform(0.0, 2.0, shape).astype(np.float32)
    bm = np.where(rng.random(shape) < fill, bm, 0.0).astype(np.float32)
    return (*b, bm)


def _port(grid, rr, eps_sq, rows):
    plain = bucket_stencil3_plain(*(as_t(a) for a in grid), rr, eps_sq, rows)
    wrapped = bucket_stencil3(*(as_t(a) for a in grid), rr=rr, eps_sq=eps_sq,
                              center_rows=rows)
    for p, w in zip(plain, wrapped):   # CPU tensor: the plain path
        np.testing.assert_array_equal(as_np(w), as_np(p))
    return tuple(as_np(a) for a in plain)


def _jax(grid, rr, eps_sq, rows):
    return tuple(np.asarray(a) for a in jax_stencil(
        *(jnp.asarray(a) for a in grid), rr, eps_sq, rows))


def _pallas(grid, rr, eps_sq, rows):
    """The TPU kernel in interpret mode, the grid scattered into its
    slot-major flat layout and the outputs read back from it."""
    _, res, _, cap = grid[0].shape
    layout = _FlatLayout3(rows, res, cap, rr, 512)
    xw, y, z = np.meshgrid(np.arange(rows + 2 * rr), np.arange(res),
                           np.arange(res), indexing="ij")
    fi = layout.flat_index(xw, y, z).reshape(-1)

    def flat(a):
        f = np.zeros((cap, layout.f_len), np.float32)
        f[:, fi] = a.reshape(-1, cap).T
        return jnp.asarray(f)

    outs = bucket_stencil3_pallas_flat(*(flat(a) for a in grid), layout,
                                       eps_sq=eps_sq, interpret=True)
    xc, y, z = np.meshgrid(np.arange(rows), np.arange(res), np.arange(res),
                           indexing="ij")
    oi = layout.out_index(xc, y, z).reshape(-1)
    return tuple(np.asarray(o)[:, oi].T.reshape(rows, res, res, cap)
                 for o in outs)


def _close(got, ref):
    tol = 1e-5 * max(np.abs(r).max() for r in ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=tol)


@pytest.mark.parametrize("rows,res,cap,rr,seed", [
    (6, 8, 8, 1, 2),       # R = 2, the octree's default
    (4, 6, 16, 2, 3),      # NEAR_CAP slots, R = 3
    (3, 5, 4, 3, 4),       # R = 4
    (2, 4, 4, 4, 5),       # R = 5, the largest radius the config allows
])
def test_plain_matches_the_jax_stencil(rows, res, cap, rr, seed):
    grid = _grid3(rows, res, cap, rr, seed)
    got = _port(grid, rr, 1.0, rows)
    assert got[0].shape == (rows, res, res, cap)
    _close(got, _jax(grid, rr, 1.0, rows))


@pytest.mark.parametrize("rr", [1, 2])
def test_plain_matches_the_pallas_kernel(rr):
    grid = _grid3(4, 6, 8, rr, 6 + rr)
    _close(_port(grid, rr, 1.0, 4), _pallas(grid, rr, 1.0, 4))


def test_eps_zero_masks_coincident_pairs():
    """eps = 0: empty slots sit at the origin and a coincident pair must add
    nothing (the d^2 > 0 mask), so the result stays finite."""
    grid = _grid3(4, 5, 4, 1, 8)
    bx, by, bz, bm = grid
    for b in (bx, by, bz):
        b[2, 1, 3, 1] = b[2, 1, 3, 0]
    bm[2, 1, 3, :2] = 1.0
    got = _port(grid, 1, 0.0, 4)
    assert all(np.isfinite(a).all() for a in got)
    _close(got, _jax(grid, 1, 0.0, 4))


def test_halo_slabs_are_sources_only_and_empty_grid_is_zero():
    grid = _grid3(3, 4, 4, 2, 9)
    empty = _port(grid[:3] + (np.zeros_like(grid[3]),), 2, 1.0, 3)
    assert not any(a.any() for a in empty)
    # Mass only in the first halo slabs: targets in the first target slabs
    # still feel it, the last one does not (it is 3 slabs away).
    bm_halo = np.zeros_like(grid[3])
    bm_halo[:2] = grid[3][:2]
    ax = _port(grid[:3] + (bm_halo,), 2, 1.0, 3)[0]
    assert np.abs(ax[:2]).max() > 0.0 and not ax[2:].any()
