"""PyTorch port, K3: the plain version of the near-field bucket kernel (what
the wrapper runs on a CPU tensor) against both JAX routes, the XLA stencil
`barneshut._bucket_stencil` and the Pallas kernel `bucket_stencil_pallas`
in interpret mode, as tests/test_barneshut.py holds them to each other.

Also the bucket grid's occupancy (`_Buckets.counts`, the kernels' count of
each cell's occupied slots) against a numpy count, in 2D and 3D, and the
tree with its counts against the JAX package.

Tolerance: 1e-5 * max|a|, the JAX test's; f32 sums in another order differ
by far less.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import nbodysim_tpu as nb
from nbodysim_tpu.kernels.nearfield import bucket_stencil_pallas
from nbodysim_tpu.physics import barneshut as jb
from nbodysim_tpu.physics.barneshut import _bucket_stencil as jax_stencil
import nbodysim_tpu_torch as nt
from nbodysim_tpu_torch.kernels.nearfield import (
    bucket_stencil, bucket_stencil3, bucket_stencil_plain)
from nbodysim_tpu_torch.physics import barneshut as tb
from nbodysim_tpu_torch.physics import barneshut3d as tb3

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
    # Random slot masks: every slot counts as occupied.
    counts = torch.full(bx.shape[:-1], bx.shape[-1], dtype=torch.int32)
    wrapped = bucket_stencil(as_t(bx), as_t(by), as_t(bm), counts=counts,
                             rr=rr, eps_sq=eps_sq, center_rows=rows)
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


def _occupancy_scene(n, dim, seed):
    """Uniform bodies in +-1000 with a cluster of 40 in one small spot (its
    cell overflows the 16 slots), and a heavy body (the tree zeroes its
    mass) as the last particle, inside an otherwise sparse cell: it sits in
    its cell's last occupied slot with mass 0 in the grid."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1000.0, 1000.0, (n, dim))
    pos[:40] = rng.uniform(100.0, 101.0, (40, dim))
    mass = rng.uniform(0.1, 10.0, n)
    mass[-1] = 1e9
    return pos.astype(np.float32), mass.astype(np.float32)


def _scene_buckets(dim, levels, rr, n=2048, seed=21):
    """The force path's bucket grid for `_occupancy_scene`, and the flat
    ids that went into it (outliers past res^D)."""
    pos, mass = _occupancy_scene(n, dim, seed)
    ext = tb._extract_heavy_outliers(as_t(pos), as_t(mass))
    build = tb._build_pyramid if dim == 2 else tb3._build_pyramid3
    _, _, _, ci, flat = build(ext["bulk_pos"], ext["tree_mass"], levels)
    res = 1 << levels
    flat_nf = tb._outlier_flat_ids(flat, ext["is_out"], res ** dim)
    b = tb._bucket_grid(as_t(pos), ext["tree_mass"], ci, flat_nf, res,
                        tb.NEAR_CAP, rr)
    return b, as_np(flat_nf), res


@pytest.mark.parametrize("dim,levels,rr", [(2, 4, 2), (3, 3, 1)])
def test_bucket_counts_match_a_numpy_count(dim, levels, rr):
    b, flat, res = _scene_buckets(dim, levels, rr)
    cap, n_cells = tb.NEAR_CAP, res ** dim
    in_grid = flat[flat < n_cells]
    ref = np.minimum(np.bincount(in_grid, minlength=n_cells), cap)
    # The grid's cell layout with its halo slabs, which hold 0.
    assert b.counts.dtype == torch.int32
    assert b.counts.shape == b.grid[0].shape[:-1]
    counts = as_np(b.counts)
    np.testing.assert_array_equal(counts[rr:rr + res].reshape(-1), ref)
    assert not counts[:rr].any() and not counts[rr + res:].any()
    # The scene has outliers, an overflowing cell and particles past it.
    assert (flat >= n_cells).sum() == max(len(flat) // 16, 1)
    assert ref.max() == cap and int(b.overflow) > 0
    # The heavy body keeps its slot with mass 0, in its cell's last
    # occupied slot: the mass grid alone would miss it.
    heavy = len(flat) - 1
    cell = flat[heavy]
    assert cell < n_cells and 0 < ref[cell] < cap
    bm = as_np(b.grid[-1])[rr:rr + res].reshape(n_cells, cap)
    assert bm[cell, ref[cell] - 1] == 0.0
    assert (bm[cell] != 0).sum() == ref[cell] - 1
    assert not bm[np.arange(cap)[None, :] >= ref[:, None]].any()


@pytest.mark.parametrize("dim,levels,rr", [(2, 4, 2), (3, 3, 1)])
def test_zeros_past_the_counts_leave_the_gathered_near_field(dim, levels,
                                                              rr):
    """The kernels write 0 at every slot at or above a cell's count; the
    plain versions compute those slots too. `_bucket_gather` reads only
    occupied slots, so the near field per particle is the same."""
    b, _, res = _scene_buckets(dim, levels, rr)
    cap = tb.NEAR_CAP
    plain = tb._bucket_stencil_dispatch(b, rr, 1.0, res, use_kernels=False)
    empty = torch.arange(cap) >= b.counts[rr:rr + res, ..., None]
    zeroed = tuple(torch.where(empty, 0.0, a) for a in plain)
    assert any(bool((a != z).any()) for a, z in zip(plain, zeroed))
    np.testing.assert_array_equal(as_np(tb._bucket_gather(b, zeroed, res,
                                                          cap)),
                                  as_np(tb._bucket_gather(b, plain, res,
                                                          cap)))


@pytest.mark.parametrize("dim", [2, 3])
def test_tree_on_the_occupancy_scene_matches_jax(dim):
    """The tree with its counts, through the wrappers (the plain versions
    on the CPU) and with use_kernels=False, against the JAX package."""
    pos, mass = _occupancy_scene(2048, dim, 21)
    cfg = nt.SimConfig(n=2048, dim=dim, force_backend="bh")
    got = tb.bh_accelerations(as_t(pos), as_t(mass), cfg)
    plain = tb.bh_accelerations(as_t(pos), as_t(mass), cfg,
                                use_kernels=False)
    ref = np.asarray(jb.bh_accelerations(
        jnp.asarray(pos), jnp.asarray(mass),
        nb.SimConfig(n=2048, dim=dim, force_backend="bh")))
    np.testing.assert_array_equal(as_np(got), as_np(plain))
    np.testing.assert_allclose(as_np(plain), ref,
                               atol=1e-5 * np.abs(ref).max())


def test_wrappers_check_the_counts():
    bx, by, bm = (as_t(a) for a in _grid(4, 8, 4, 2, 7))
    good = torch.full((8, 8), 4, dtype=torch.int32)
    ax, _ = bucket_stencil(bx, by, bm, counts=good, rr=2, eps_sq=1.0,
                           center_rows=4)
    assert ax.shape == (4, 8, 4)
    for bad in (good.to(torch.int64), good[:6], good.reshape(-1)):
        with pytest.raises(ValueError, match="counts"):
            bucket_stencil(bx, by, bm, counts=bad, rr=2, eps_sq=1.0,
                           center_rows=4)
    grid3 = torch.zeros(4, 3, 3, 2)
    with pytest.raises(ValueError, match="counts"):
        bucket_stencil3(grid3, grid3, grid3, grid3,
                        counts=torch.zeros(4, 3, 3), rr=1, eps_sq=1.0,
                        center_rows=2)
    with pytest.raises(TypeError):
        bucket_stencil(bx, by, bm, rr=2, eps_sq=1.0, center_rows=4)
