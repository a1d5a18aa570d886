"""The tree code: one force-evaluation pipeline for the quadtree (2D) and
the octree (3D), and the quadtree's stages: a stencil-based multilevel FMM
(port of `nbodysim_tpu.physics.barneshut`).

The pipeline (`bh_accelerations` -> `_bh_accelerations` -> `_deep_chain`
-> `_tile_refine` -> `_tile_eval`) is written once. It takes each stage
from the tree of the state's dimension (`_stages`): the quadtree's from
this module, the octree's from `physics/barneshut3d.py`. The same module
holds what both trees share outright: the exact couplings, the bucket grid
and its residual, the assembly and the row compactions
(`_compact_rows`). The state probes (`bh_near_overflow`,
`resolve_tree_for_state`, `check_tree_capacity`) serve both dimensions.

A kernel-independent FMM over the complete quadtree of a 2^L x 2^L grid;
the JAX module's docstring gives the design at length:

  upward (M2M):  scatter particle mass and raw first/second moments into the
                 finest grid (`index_add_`), 2 x 2 sum-pool up the pyramid.
  M2L:           per level, the V-list (Chebyshev distance R..2R-1, parity-
                 gated on the outer ring) into p=2 local terms (F, J, H):
                 on the card ONE launch of the M2L kernel
                 (`kernels/m2l2.py`, `csrc/m2l2.cu`), on the CPU ONE
                 parent-level convolution (`_m2l_conv`, `F.conv2d`);
                 `_m2l_stencil` is their plain reference.
  L2L / L2P:     local expansions re-centred down the pyramid, then one
                 gather per particle and a second-order Taylor evaluation.
  near field:    the (2R-1)^2 finest-cell neighbourhood particle-particle on
                 a dense bucket grid [r, r, K] (`NEAR_CAP` slots per cell):
                 K3 (`kernels/nearfield.py`) on the card. Cells holding more
                 than K particles spill into an exact near-masked residual.
  extraction:    the heaviest bodies (>= 0.1% of the mass) and the
                 `_OUTLIER_CAP` most distant ones leave the tree and get
                 exact forces: outliers <- all through K1 with separate
                 sources, bulk <- outliers through K4.
  deep chain:    with `bh_deep_levels != 0` (switched on by
                 `resolve_tree_for_state` where the buckets overflow past
                 the residual's cap) the pyramid and the downward pass
                 continue past the bucket level; targets near an overflowing
                 cell take the deep level's local expansion plus smoothed
                 3 x 3 cell aggregates (the outer ring folded into the local
                 terms), and inside the T hottest tiles the chain continues
                 k sub-levels finer (`_tile_refine`). It skips the residual.

Differences from the JAX package, each deliberate:
  * the M2L runs in full f32 at every level: on the card in the M2L
    kernel's FMA, and the convolution with cuDNN's TF32 switched off around
    the call (the JAX package pins HIGHEST, and drops to HIGH, bf16x3, at
    r >= 1024; full f32 is at least as exact);
  * the residual tiers, and the deep chain's row compactions, are Python
    branches on a count read from the device: one host sync each
    (`profiling.host_read`), where the JAX package uses `lax.cond`;
  * on the card the residual's pair blocks are 32768 wide instead of 2048
    (the same function in ~16x fewer launches);
  * the per-tile chain runs the T tiles as one batch where the JAX package
    vmaps; the deep aggregates are always the per-offset gathers
    (`_aggregate_window_eval`): the JAX package's packed variants sum the
    same terms in the same order for the TPU's gather row rate.

Scatter order: `index_add_` on CUDA uses atomics, so the pyramid's sums
differ in the last bits from run to run; tolerances state that as their
reason.
"""

from __future__ import annotations

import contextlib
import functools
import warnings
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.core.blocking import (
    pairwise_blocked, sorted_first_occurrence)
from nbodysim_tpu_torch.diagnostics import profiling
from nbodysim_tpu_torch.kernels.allpairs import (
    allpairs_accelerations, allpairs_accelerations_plain,
    allpairs_accelerations_wide)
from nbodysim_tpu_torch.kernels.m2l2 import m2l2
from nbodysim_tpu_torch.kernels.nearfield import (
    bucket_stencil, bucket_stencil3, bucket_stencil3_plain,
    bucket_stencil_plain)

NEAR_CAP = 16           # bucket slots per finest cell
_OVERFLOW_CAP = 16384   # compact-residual set size for overflowing cells
_OVERFLOW_SMALL = 1024  # cheap residual tier for mild overflow
_OUTLIER_CAP = 4096     # most-distant particles extracted for exact handling
_HEAVY_K = 64           # max heavy bodies handled by exact direct interaction


def _iota(shape, dim: int, device) -> torch.Tensor:
    """int64 index along `dim`, broadcast to `shape` (lax.broadcasted_iota)."""
    view = [1] * len(shape)
    view[dim] = shape[dim]
    return torch.arange(shape[dim], device=device).view(view).expand(shape)


def _bounding_box(pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(corner, size) of a square (a cube in 3D) containing all particles,
    slightly padded."""
    mn = pos.min(0).values
    mx = pos.max(0).values
    center = 0.5 * (mn + mx)
    size = (mx - mn).max() * 1.0001 + 1e-6
    return center - 0.5 * size, size


def _cell_ids(pos, corner, size, res: int):
    """Cell indices [N, D] (int64) on the res^D grid over the bounding box,
    and their row-major flat ids [N]."""
    u = (pos - corner) / size
    ci = torch.clamp((u * res).to(torch.int64), 0, res - 1)
    return ci, _flat_ids(ci, res)


def _flat_ids(ci, res: int):
    """Row-major flat ids [N] of cell indices [N, D] on the res^D grid."""
    flat = ci[:, 0]
    for a in range(1, ci.shape[1]):
        flat = flat * res + ci[:, a]
    return flat


def _moment_payload(pos, mass):
    """[N, 6] raw-moment rows: monopole + first + second moments."""
    px, py = pos[:, 0], pos[:, 1]
    return torch.stack(
        (mass, mass * px, mass * py,
         mass * px * px, mass * px * py, mass * py * py), -1)


def _synth_quad_channels(g3):
    """(m, sx, sy) -> 6 raw-moment channels with point-at-COM quadrupoles
    (rxx = sx^2/m, ...; exact for single-particle cells)."""
    m, sx, sy = g3[..., 0], g3[..., 1], g3[..., 2]
    inv = torch.where(m > 0, 1.0 / torch.where(m > 0, m, 1.0), 0.0)
    return torch.stack((m, sx, sy, sx * sx * inv, sx * sy * inv,
                        sy * sy * inv), -1)


def _pool_synth(g):
    """2 x 2 sum-pool of [..., 2h, 2w, C] grids in the fixed order
    ((a00 + a01) + a10) + a11, the JAX package's on the CPU. Used for the
    grids whose quadrupoles are synthesized (sx^2/m at absolute
    coordinates): `_center_channels` centres them by subtracting ~m c^2,
    which turns the pooled sums' last bits into ~1e-4 of the deep local
    terms, so the order must be the reference's. Row bands of a grid (the
    banded tree's) pool as the grid does."""
    h, w = g.shape[-3] // 2, g.shape[-2] // 2
    a = g.reshape(g.shape[:-3] + (h, 2, w, 2, g.shape[-1]))
    return ((a[..., 0, :, 0, :] + a[..., 0, :, 1, :])
            + a[..., 1, :, 0, :]) + a[..., 1, :, 1, :]


def _build_pyramid(pos, mass, levels: int, synth_quad: bool = False):
    """Six moment grids per level, levels L..0 (fine to coarse), from ONE
    [N, 6]-payload `index_add_` and one 2 x 2 pooling per level.

    synth_quad=True scatters only (m, sx, sy), synthesizes the quadrupole
    channels as point-at-COM raw moments (the JAX package's deep mode) and
    pools in `_pool_synth`'s order. Returns (grids, corner, size, ci [N, 2]
    int64, flat [N])."""
    corner, size = _bounding_box(pos)
    res = 1 << levels
    ci, flat = _cell_ids(pos, corner, size, res)
    payload = _moment_payload(pos, mass)
    if synth_quad:
        g3 = torch.zeros((res * res, 3), dtype=pos.dtype, device=pos.device)
        g3.index_add_(0, flat, payload[:, :3])
        g6 = _synth_quad_channels(g3.reshape(res, res, 3))
    else:
        g6 = torch.zeros((res * res, 6), dtype=pos.dtype, device=pos.device)
        g6.index_add_(0, flat, payload)
        g6 = g6.reshape(res, res, 6)
    grids = {levels: tuple(g6[:, :, i] for i in range(6))}
    for lv in range(levels - 1, -1, -1):
        r = 1 << lv
        g6 = (_pool_synth(g6) if synth_quad
              else g6.reshape(r, 2, r, 2, 6).sum((1, 3)))
        grids[lv] = tuple(g6[:, :, i] for i in range(6))
    return grids, corner, size, ci, flat


def _channel_stack(grids):
    """The moment grids as one [..., C] tensor: a view where they are the
    channels of one channel-last tensor (as the pyramid and the tile chain
    make them), else a stack."""
    a = grids[0]
    step, rem = divmod(grids[1].data_ptr() - a.data_ptr(), a.element_size())
    base = a.untyped_storage().data_ptr()
    if step > 0 and not rem and all(
            c.shape == a.shape and c.stride() == a.stride()
            and c.dtype == a.dtype
            and c.untyped_storage().data_ptr() == base
            and c.data_ptr() == a.data_ptr() + i * step * a.element_size()
            for i, c in enumerate(grids)):
        return a.as_strided(a.shape + (len(grids),), a.stride() + (step,))
    return torch.stack(grids, -1)


def _m2l_level(grids_l, corner, size, eps_sq, radius: int):
    """V-list pass at one full level -> p=2 local terms (F, J, H).

    Even grids (every real level) run through `kernels.m2l2.m2l2`: the
    kernel on the card, the parent-level convolution (`_m2l_conv`) on the
    CPU; the stencil is the reference and the odd-size path. Even grids may
    carry leading batch axes (the deep chain's tiles), with one corner per
    grid. Every call is the span `tree.m2l`, inside the stage that makes it
    (`tree.downward`, `tree.deep`, `tree.tiles`)."""
    r = grids_l[0].shape[-1]
    with profiling.span("tree.m2l"):
        if r % 2 == 0 and r >= 2:
            return m2l2(_channel_stack(grids_l), corner, size, r, eps_sq,
                        radius, row0=0, rows=r, x0=0)
        p = 2 * radius - 1
        window = tuple(F.pad(g, (p, p, p, p)) for g in grids_l)
        return _m2l_stencil(window, corner, size, r, eps_sq, radius,
                            row0=0, rows=r)


def _m2l_stencil(window, corner, size, r_full: int, eps_sq, radius: int,
                 row0: int, rows: int, offsets=None, gate_parity: bool = True,
                 pad: Optional[int] = None):
    """V-list stencil over a row window -> p=2 local terms (F, J, H) with
    quadrupole source moments folded into F.

    `window`: the 6 raw moment grids, [rows + 2p, r_full + 2p] each
    (p = 2*radius - 1, or `pad`), holding the `rows` target rows plus p halo
    rows on each side and p zero columns; `row0` is the global row of the
    first target row. `offsets`/`gate_parity`/`pad` generalize it beyond
    the V-list (the deep chain's ring fold). Offsets are summed in order,
    as the JAX package's scan does. The grids may carry leading batch axes,
    with `corner` [..., 2] one corner per grid."""
    m_w, wx_w, wy_w, rxx_w, rxy_w, ryy_w = window
    s_l = size / r_full
    safe_m = torch.where(m_w > 0, m_w, 1.0)
    comx = wx_w / safe_m
    comy = wy_w / safe_m
    # Quadrupole about the COM (the dipole vanishes by construction).
    qxx = rxx_w - m_w * comx * comx
    qxy = rxy_w - m_w * comx * comy
    qyy = ryy_w - m_w * comy * comy

    dtype, device = m_w.dtype, m_w.device
    shape = (rows, r_full)
    gx_i = _iota(shape, 0, device) + row0
    gy_i = _iota(shape, 1, device)
    cx = corner[..., 0, None, None] + (gx_i.to(dtype) + 0.5) * s_l
    cy = corner[..., 1, None, None] + (gy_i.to(dtype) + 0.5) * s_l
    parx = gx_i & 1
    pary = gy_i & 1

    R = radius
    if offsets is None:
        offsets = [(ox, oy)
                   for ox in range(-(2 * R - 1), 2 * R)
                   for oy in range(-(2 * R - 1), 2 * R)
                   if max(abs(ox), abs(oy)) >= R]
    p = 2 * R - 1 if pad is None else pad
    out = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(9)]
    for ox, oy in offsets:
        def sl(a):
            return a[..., p + ox:p + ox + rows, p + oy:p + oy + r_full]

        ms, sx, sy = sl(m_w), sl(comx), sl(comy)
        sqxx, sqxy, sqyy = sl(qxx), sl(qxy), sl(qyy)
        if gate_parity:
            # Boundary ring (cheb == 2R-1): only when the source's parent
            # lies in the parent's near set (exactly-once coverage).
            cheb = max(abs(ox), abs(oy))
            pxo = (ox + parx) >> 1
            pyo = (oy + pary) >> 1
            pm_ok = (pxo.abs() <= R - 1) & (pyo.abs() <= R - 1)
            keep = pm_ok | (cheb < 2 * R - 1)
            ms = torch.where(keep, ms, 0.0)
            sqxx = torch.where(keep, sqxx, 0.0)
            sqxy = torch.where(keep, sqxy, 0.0)
            sqyy = torch.where(keep, sqyy, 0.0)

        dx = sx - cx
        dy = sy - cy
        q = dx * dx + dy * dy + eps_sq
        inv = torch.rsqrt(q)
        inv3 = inv * inv * inv
        inv5 = inv3 * inv * inv
        inv7 = inv5 * inv * inv
        w3 = ms * inv3
        w5 = 3.0 * ms * inv5
        # Unit-mass third-derivative tensors, shared by the H accumulation
        # and the quadrupole contraction (see the JAX module).
        u7 = 15.0 * inv7
        u5 = 3.0 * inv5
        txxx = u7 * dx * dx * dx - 3.0 * u5 * dx
        txxy = u7 * dx * dx * dy - u5 * dy
        txyy = u7 * dx * dy * dy - u5 * dx
        tyyy = u7 * dy * dy * dy - 3.0 * u5 * dy
        fq_x = 0.5 * (sqxx * txxx + 2.0 * sqxy * txxy + sqyy * txyy)
        fq_y = 0.5 * (sqxx * txxy + 2.0 * sqxy * txyy + sqyy * tyyy)
        terms = (w3 * dx + fq_x, w3 * dy + fq_y,
                 w5 * dx * dx - w3, w5 * dx * dy, w5 * dy * dy - w3,
                 ms * txxx, ms * txxy, ms * txyy, ms * tyyy)
        out = [o + t for o, t in zip(out, terms)]
    return tuple(out)


# ---------------------------------------------------------------------------
# M2L as one convolution at the parent level: cell-centre moments make the
# V-list translation-invariant, and the space-to-depth (parent-level) view
# makes the parity-gated ring exact with taps at |PO|_inf <= R_parent - 1.
# 6 moment channels (m, d_x, d_y, Q_xx, Q_xy, Q_yy) x 4 children = 24 in,
# 9 local terms x 4 children = 36 out, (2Rp-1)^2 taps.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _m2l_conv_taps(radius: int, r_parent: int, dim: int):
    """Static tap table for the parent-level M2L contraction (a copy of
    `nbodysim_tpu.physics.barneshut3d._m2l_conv_taps`, numpy only).

    Returns (po_lin, e_lin, f_lin, o) numpy int arrays over every kept tap:
    parent offset PO (linearized over the (2*r_parent-1)^dim kernel),
    target child parity e, source child position f, and the child-level
    offset o = 2*PO + f - e with cheb(o) >= radius. r_parent is the
    acceptance radius the parent level ran with (its taps live at
    |PO|_inf <= r_parent - 1)."""
    import itertools

    q = r_parent - 1
    k = 2 * r_parent - 1
    po_l, e_l, f_l, os_ = [], [], [], []
    for po in itertools.product(range(-q, q + 1), repeat=dim):
        for ei, e in enumerate(itertools.product((0, 1), repeat=dim)):
            for fi, f in enumerate(itertools.product((0, 1), repeat=dim)):
                o = tuple(2 * po[a] + f[a] - e[a] for a in range(dim))
                if max(abs(c) for c in o) < radius:
                    continue          # near field, not M2L
                lin = 0
                for a in range(dim):
                    lin = lin * k + po[a] + q
                po_l.append(lin)
                e_l.append(ei)
                f_l.append(fi)
                os_.append(o)
    return (np.asarray(po_l, np.int32), np.asarray(e_l, np.int32),
            np.asarray(f_l, np.int32), np.asarray(os_, np.int32))


def _m2l_conv_weights(radius: int, r_parent: int, eps_sq_hat, dtype, device):
    """[(2Rp-1)^2, 24, 36] tap weights W[PO, f*6+c_in, e*9+t_out].

    Scale-free: offsets in cell units, eps_sq_hat = eps_sq / s_l^2 (a
    tensor: the bounding square depends on the positions); the caller
    scales outputs by s_l^-(2,3,4) per term class. Includes the rank-4
    couplings (dipole -> H, quadrupole -> J)."""
    po, el, fl, offs = _m2l_conv_taps(radius, r_parent, 2)
    r = torch.as_tensor(offs, device=device).to(dtype)        # [T, 2]
    rx, ry = r[:, 0], r[:, 1]
    q = rx * rx + ry * ry + eps_sq_hat
    inv = torch.rsqrt(q)
    inv3 = inv * inv * inv
    inv5 = inv3 * inv * inv
    inv7 = inv5 * inv * inv
    inv9 = inv7 * inv * inv
    x2, y2 = rx * rx, ry * ry

    txxx = 15.0 * x2 * rx * inv7 - 9.0 * rx * inv5
    txxy = 15.0 * x2 * ry * inv7 - 3.0 * ry * inv5
    txyy = 15.0 * rx * y2 * inv7 - 3.0 * rx * inv5
    tyyy = 15.0 * y2 * ry * inv7 - 9.0 * ry * inv5
    uxxxx = -105.0 * x2 * x2 * inv9 + 90.0 * x2 * inv7 - 9.0 * inv5
    uyyyy = -105.0 * y2 * y2 * inv9 + 90.0 * y2 * inv7 - 9.0 * inv5
    uxxxy = -105.0 * x2 * rx * ry * inv9 + 45.0 * rx * ry * inv7
    uxyyy = -105.0 * y2 * rx * ry * inv9 + 45.0 * rx * ry * inv7
    uxxyy = -105.0 * x2 * y2 * inv9 + 15.0 * (x2 + y2) * inv7 - 3.0 * inv5

    def row(f2, j3, h4):
        return torch.stack(tuple(f2) + tuple(j3) + tuple(h4), -1)

    row_m = row(
        (inv3 * rx, inv3 * ry),
        (3.0 * x2 * inv5 - inv3, 3.0 * rx * ry * inv5,
         3.0 * y2 * inv5 - inv3),
        (txxx, txxy, txyy, tyyy))
    row_dx = row(
        (inv3 - 3.0 * x2 * inv5, -3.0 * rx * ry * inv5),
        (-txxx, -txxy, -txyy),
        (uxxxx, uxxxy, uxxyy, uxyyy))
    row_dy = row(
        (-3.0 * rx * ry * inv5, inv3 - 3.0 * y2 * inv5),
        (-txxy, -txyy, -tyyy),
        (uxxxy, uxxyy, uxyyy, uyyyy))
    zeros4 = (torch.zeros_like(rx),) * 4

    def qrow(mult, t2, u3):
        h = 0.5 * mult
        return row((h * t2[0], h * t2[1]), tuple(-h * u for u in u3), zeros4)

    row_qxx = qrow(1.0, (txxx, txxy), (uxxxx, uxxxy, uxxyy))
    row_qxy = qrow(2.0, (txxy, txyy), (uxxxy, uxxyy, uxyyy))
    row_qyy = qrow(1.0, (txyy, tyyy), (uxxyy, uxyyy, uyyyy))

    B = torch.stack((row_m, row_dx, row_dy, row_qxx, row_qxy, row_qyy),
                    1)                                          # [T, 6, 9]
    k2 = (2 * r_parent - 1) ** 2
    ci = fl[:, None, None] * 6 + np.arange(6)[None, :, None]
    ti = el[:, None, None] * 9 + np.arange(9)[None, None, :]
    pb = np.broadcast_to(po[:, None, None], ci.shape)

    def idx(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64,
                               device=device).expand(B.shape)

    W = torch.zeros((k2, 24, 36), dtype=dtype, device=device)
    W[idx(pb), idx(ci), idx(ti)] = B
    return W


def _center_channels(g6, corner, size, r_full: int, x0: int):
    """Raw origin moments [..., X, r, 6] -> moments about each cell's own
    centre in CELL UNITS: (m, d/s_l, Q/s_l^2). x0 = global row of row 0;
    `corner` [..., 2] holds one corner per leading index."""
    dtype, device = g6.dtype, g6.device
    s_l = size / r_full
    inv_s = 1.0 / s_l
    shape = g6.shape[-3:-1]
    cx = corner[..., 0, None, None] \
        + (_iota(shape, 0, device) + x0).to(dtype) * s_l + 0.5 * s_l
    cy = corner[..., 1, None, None] \
        + _iota(shape, 1, device).to(dtype) * s_l + 0.5 * s_l
    m = g6[..., 0]
    sx, sy = g6[..., 1], g6[..., 2]
    inv2 = inv_s * inv_s
    return torch.stack(
        (m,
         (sx - m * cx) * inv_s,
         (sy - m * cy) * inv_s,
         (g6[..., 3] - 2.0 * cx * sx + m * cx * cx) * inv2,
         (g6[..., 4] - cx * sy - cy * sx + m * cx * cy) * inv2,
         (g6[..., 5] - 2.0 * cy * sy + m * cy * cy) * inv2), -1)


@contextlib.contextmanager
def _full_f32_conv():
    """cuDNN's TF32 off for the M2L convolution (fault F1): PyTorch runs f32
    convolutions in TF32 by default, ~3 decimal digits, which breaks the
    far field; the JAX package pins HIGHEST precision here."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _m2l_conv(gx, corner, size, r_full: int, eps_sq, radius: int,
              row0: int, rows: int, r_parent: Optional[int] = None):
    """One 2D M2L level as the parent-level convolution: the plain route of
    `kernels.m2l2` (the CPU's, and the reference the kernel is held to on
    the card).

    gx: [..., rows + 4(Rp-1), r_full, 6] raw-moment row window whose first
    and last 2(Rp-1) rows are halo (zeros beyond the grid); its row 0 is
    global row row0 - 2(Rp-1). row0 and rows must be even. Leading axes
    are a batch of grids (`corner` [..., 2], one corner each) run as one
    convolution batch. Returns the 9 local terms, [..., rows, r_full] each.

    XLA's NHWC/HWIO `conv_general_dilated` becomes `F.conv2d` on NCHW/OIHW;
    both are cross-correlations, so the taps need no flip. It runs in full
    f32 at every level (`_full_f32_conv`); the JAX package uses HIGH
    (bf16x3) at r >= 1024, which this is at least as exact as."""
    Rp = radius if r_parent is None else r_parent
    qh = Rp - 1
    h = r_full // 2
    hb = rows // 2
    dtype = gx.dtype
    lead = gx.shape[:-3]

    ch = _center_channels(gx, corner, size, r_full, row0 - 2 * qh)
    X = rows + 4 * qh
    m4 = (ch.reshape(-1, X // 2, 2, h, 2, 6)
          .permute(0, 1, 3, 2, 4, 5)
          .reshape(-1, X // 2, h, 24))
    m4 = F.pad(m4, (0, 0, qh, qh))                   # [B, X/2, h + 2qh, 24]
    s_l = size / r_full
    W = _m2l_conv_weights(radius, Rp, eps_sq / (s_l * s_l), dtype, gx.device)
    k = 2 * Rp - 1
    weight = W.reshape(k, k, 24, 36).permute(3, 2, 0, 1).contiguous()
    with _full_f32_conv():
        out = F.conv2d(m4.permute(0, 3, 1, 2).contiguous(), weight)
    inv_s = 1.0 / s_l
    s2 = inv_s * inv_s
    scales = (s2, s2, s2 * inv_s, s2 * inv_s, s2 * inv_s,
              s2 * s2, s2 * s2, s2 * s2, s2 * s2)
    # Channel (2c + d) * 9 + t of parent cell (i, j) is term t of child
    # (2i + c, 2j + d): de-space-to-depth to [9, B, rows, r_full].
    terms = (out.reshape(-1, 2, 2, 9, hb, h).permute(3, 0, 4, 1, 5, 2)
             .reshape((9,) + lead + (rows, r_full)))
    return tuple(terms[t] * scales[t] for t in range(9))


def _l2l_upsample(local, s_child):
    """Shift parent local expansions to the 4 child centres and upsample:
    F' = F + J d + (1/2) d^T H d, J' = J + H d, H' = H (rectangular grids
    too, with leading batch axes; the first row must be even)."""
    fx, fy, jxx, jxy, jyy, hxxx, hxxy, hxyy, hyyy = local
    r0, r1 = fx.shape[-2:]

    def up(a):
        return a.repeat_interleave(2, -2).repeat_interleave(2, -1)

    fxu, fyu = up(fx), up(fy)
    jxxu, jxyu, jyyu = up(jxx), up(jxy), up(jyy)
    hxxxu, hxxyu, hxyyu, hyyyu = up(hxxx), up(hxxy), up(hxyy), up(hyyy)
    # Child-centre offset from the parent centre: (+-1/2) s_child by parity.
    shape2 = (2 * r0, 2 * r1)
    ex = ((_iota(shape2, 0, fx.device) & 1).to(fx.dtype) - 0.5) * s_child
    ey = ((_iota(shape2, 1, fx.device) & 1).to(fx.dtype) - 0.5) * s_child
    fxc = (fxu + jxxu * ex + jxyu * ey
           + 0.5 * (hxxxu * ex * ex + 2 * hxxyu * ex * ey + hxyyu * ey * ey))
    fyc = (fyu + jxyu * ex + jyyu * ey
           + 0.5 * (hxxyu * ex * ex + 2 * hxyyu * ex * ey + hyyyu * ey * ey))
    jxxc = jxxu + hxxxu * ex + hxxyu * ey
    jxyc = jxyu + hxxyu * ex + hxyyu * ey
    jyyc = jyyu + hxyyu * ex + hyyyu * ey
    return fxc, fyc, jxxc, jxyc, jyyc, hxxxu, hxxyu, hxyyu, hyyyu


def _taylor_eval(g9, dxp, dyp):
    """p=2 Taylor evaluation of the 9 local terms (F, J, H) at in-cell
    offsets (dxp, dyp): a = F + J d + (1/2) d^T H d per component."""
    fx, fy, jxx, jxy, jyy, hxxx, hxxy, hxyy, hyyy = g9
    ax = (fx + jxx * dxp + jxy * dyp
          + 0.5 * (hxxx * dxp * dxp + 2 * hxxy * dxp * dyp
                   + hxyy * dyp * dyp))
    ay = (fy + jxy * dxp + jyy * dyp
          + 0.5 * (hxxy * dxp * dxp + 2 * hxyy * dxp * dyp
                   + hyyy * dyp * dyp))
    return ax, ay


def _l2p_eval(local, ci, pos, corner, size, level: int):
    """Second-order local-expansion evaluation at each particle (L2P), one
    fused [9, N] gather. Returns [N, 2], unscaled by g_const."""
    res = 1 << level
    s_l = size / res
    cellx, celly = ci[:, 0], ci[:, 1]
    centx = corner[0] + (cellx.to(pos.dtype) + 0.5) * s_l
    centy = corner[1] + (celly.to(pos.dtype) + 0.5) * s_l
    dxp = pos[:, 0] - centx
    dyp = pos[:, 1] - centy
    loc9 = torch.stack(local, 0).reshape(9, res * res)
    g = loc9[:, cellx * res + celly]                   # [9, N]
    far_x, far_y = _taylor_eval(tuple(g[i] for i in range(9)), dxp, dyp)
    return torch.stack([far_x, far_y], -1)


def _near_masked_blocked(tgt_pos, tgt_cell, src_pos, src_mass, src_cell,
                         eps_sq, rr1: int, block: int = 2048):
    """Near-cell-masked pairwise accelerations (cheb(cells) <= rr1), blocked
    over BOTH axes so the pair temp stays [<= block, <= block]."""

    def kernel(tgt, src):
        tpb, tcb = tgt
        spb, smb, scb = src
        d = spb[None, :, :] - tpb[:, None, :]
        d_sq = (d * d).sum(-1)
        cheb = (scb[None, :, :] - tcb[:, None, :]).abs().amax(-1)
        inv = torch.rsqrt(d_sq + eps_sq)
        w = smb[None, :] * (inv * inv * inv)
        # Zero-mass source rows are inert.
        w = torch.where((cheb <= rr1) & (d_sq > 0.0), w, 0.0)
        return ((w[:, :, None] * d).sum(1),)

    (acc,) = pairwise_blocked(
        kernel, (tgt_pos, tgt_cell), (src_pos, src_mass, src_cell),
        out_dims=((tgt_pos.shape[1],),), dtype=tgt_pos.dtype,
        bs_t=block, bs_s=block)
    return acc


def _bucket_stencil_dispatch(b: _Buckets, rr, eps_sq, center_rows,
                             use_kernels: bool):
    """K3 on a 2D bucket grid (bx, by, bm), K7 on a 3D one (bx, by, bz,
    bm), given the cells' occupied-slot counts -- the wrappers launch the
    kernel on a CUDA tensor and run the plain version on a CPU one -- or,
    with use_kernels=False, the plain version anywhere."""
    grid = b.grid
    dim = len(grid) - 1
    if not use_kernels:
        plain = bucket_stencil_plain if dim == 2 else bucket_stencil3_plain
        return plain(*grid, rr, eps_sq, center_rows)
    kernel = bucket_stencil if dim == 2 else bucket_stencil3
    return kernel(*grid, counts=b.counts, rr=rr, eps_sq=eps_sq,
                  center_rows=center_rows)


class _Buckets(NamedTuple):
    """The particles sorted by cell and scattered into the bucket grid."""
    order: torch.Tensor     # [N] sort permutation (stable)
    flat_s: torch.Tensor    # [N] sorted flat cell ids
    slot: torch.Tensor      # [N] rank inside the cell
    in_cap: torch.Tensor    # [N] slot < cap
    pos_s: torch.Tensor     # [N, D]
    mass_s: torch.Tensor    # [N]
    ci_s: torch.Tensor      # [N, D] cell indices
    overflow: torch.Tensor  # [] particles past the cap
    grid: Tuple[torch.Tensor, ...]
    # (b_x, b_y[, b_z], b_m), [res + 2rr, res(, res), cap] each: rr zero
    # halo rows (x-slabs) per side
    counts: torch.Tensor
    # [res + 2rr, res(, res)] int32, the grid's cells with its halo:
    # min(in-grid particles, cap), 0 in the halo


def _bucket_grid(pos, mass, ci, flat, res: int, cap: int,
                 rr: int) -> _Buckets:
    """Sort particles by cell, rank them inside it, and scatter the first
    `cap` of each cell into the bucket grid, in 2D or 3D (D = pos.shape[1]
    grid axes). Particles with a flat id >= res^D (the extracted outliers)
    and overflow go to one extra dump entry that is cut off (JAX:
    mode="drop"). `counts` holds each cell's occupied slots, massless
    particles (heavy bodies, zeroed in `mass`) included, in the grid's
    cell layout with its halo: what K3 and K7 take."""
    n, dim = pos.shape
    device = pos.device
    # Stable, as jnp.argsort is: which particles land in the in-cap slots
    # must match the JAX package when a cell overflows.
    order = torch.argsort(flat, stable=True)
    flat_s = flat[order]
    # Slot of each particle inside its cell = rank - first rank of the cell.
    slot = torch.arange(n, device=device) - sorted_first_occurrence(flat_s)
    in_cap = slot < cap
    pos_s = pos[order]
    mass_s = mass[order]

    n_cells = res ** dim
    size = n_cells * cap
    live = in_cap & (flat_s < n_cells)
    dest = torch.where(live, flat_s * cap + slot, size)
    halo = (0, 0) * dim + (rr, rr)     # zero x-slabs on both sides

    def scat(v):
        g = torch.zeros(size + 1, dtype=pos.dtype, device=device)
        g[dest] = v
        return F.pad(g[:size].reshape((res,) * dim + (cap,)), halo)

    grid = tuple(scat(pos_s[:, a]) for a in range(dim)) + (
        scat(torch.where(in_cap, mass_s, 0.0)),)
    counts = torch.zeros(n_cells + 1, dtype=torch.int32, device=device)
    counts.index_add_(0, torch.where(live, flat_s, n_cells),
                      torch.ones(n, dtype=torch.int32, device=device))
    counts = F.pad(counts[:n_cells].reshape((res,) * dim), halo[2:])
    return _Buckets(order, flat_s, slot, in_cap, pos_s, mass_s, ci[order],
                    (slot >= cap).sum(), grid, counts)


def _bucket_gather(b: _Buckets, acc, res: int, cap: int):
    """Per-slot stencil outputs (one grid per axis) -> [N, D] in sorted
    order (0 past the cap). Gathers clamp out-of-grid ids, as JAX's do;
    those rows are garbage."""
    n_cells = res ** len(acc)
    gidx = (torch.clamp(b.flat_s, max=n_cells - 1) * cap
            + torch.clamp(b.slot, max=cap - 1))
    return torch.stack([torch.where(b.in_cap, a.reshape(-1)[gidx], 0.0)
                        for a in acc], -1)


def _residual_blocks(b: _Buckets, rr: int, block: int):
    """Which `block`-row slices of the sorted particles hold a particle
    within rr cells, along the grid's first axis, of an overflow particle:
    [ceil(N / block)] bool, on the device, with no host read. The residual's
    mask is a Chebyshev one, so each pair across any other slice is masked
    to an exact zero."""
    x = b.ci_s[:, 0]
    res = b.counts.shape[1]
    n = x.shape[0]
    # over_x[k + rr]: overflow particles in column k, rr zero columns on
    # each side.
    over_x = torch.zeros(res + 2 * rr, dtype=torch.int32, device=x.device)
    over_x.index_add_(0, x + rr, (~b.in_cap).to(torch.int32))
    cs = torch.cumsum(over_x, 0)
    near = cs[2 * rr:] - F.pad(cs, (1, 0))[:res]     # columns k-rr..k+rr
    hit = F.pad(near[x] > 0, (0, -n % block))
    return hit.view(-1, block).any(1)


def _overflow_residual(b: _Buckets, acc_s, eps_sq, rr: int):
    """Exact residual for bucket overflow (clustered cells), in sorted order,
    in 2D or 3D.

    The bucket pass used only in-cap particles as sources and targets.
    Gather the overflow set O compactly (a fixed cap) and add
      (b) all targets <- O sources, near-cell-masked,
      (c) O targets <- in-cap sources, near-cell-masked.
    O's far field is already exact (the pyramid holds every particle). Two
    tiers: the masked pass costs O(N * cap), so a mild overflow (a few
    clustered cells) takes the 1024-wide tier. Both passes run in slices of
    `block` sorted rows and take only the slices that `_residual_blocks`
    marks: every pair across the others is masked to zero, and the slices
    taken are the full pass's own, so the sums are the full pass's. The tier
    and the slices are Python branches on the overflow count and the marks:
    one host sync (`host_read`), counted as `tree.near_overflow`."""
    n = acc_s.shape[0]
    block = 32768 if acc_s.device.type == "cuda" else 2048
    read = profiling.host_read(
        torch.cat([b.overflow.view(1),
                   _residual_blocks(b, rr, block).to(b.overflow.dtype)]),
        "near_overflow")
    over, marked = read[0], [i * block for i, m in enumerate(read[1:]) if m]
    profiling.count("tree.near_overflow", over)
    m_cap = min(n, _OVERFLOW_CAP)
    m_small = min(n, _OVERFLOW_SMALL)
    if over == 0:
        return acc_s
    cap_k = m_cap if over > m_small or m_small >= m_cap else m_small
    o_idx = torch.argsort(b.in_cap.to(torch.int32), stable=True)[:cap_k]
    o_valid = ~b.in_cap[o_idx]
    o_pos = b.pos_s[o_idx]
    o_mass = torch.where(o_valid, b.mass_s[o_idx], 0.0)
    o_cell = b.ci_s[o_idx]
    cap_mass = torch.where(b.in_cap, b.mass_s, 0.0)
    near = torch.zeros_like(acc_s)
    o_acc = None
    for i in marked:
        rows = slice(i, i + block)
        near[rows] = _near_masked_blocked(
            b.pos_s[rows], b.ci_s[rows], o_pos, o_mass, o_cell, eps_sq, rr,
            block)
        part = _near_masked_blocked(
            o_pos, o_cell, b.pos_s[rows], cap_mass[rows], b.ci_s[rows],
            eps_sq, rr, block)
        o_acc = part if o_acc is None else o_acc + part
    acc_s = acc_s + near
    return acc_s.index_add(0, o_idx, torch.where(o_valid[:, None], o_acc, 0.0))


def _near_field_buckets(pos, mass, ci, flat, levels: int, eps_sq, g_const,
                        cap: int, radius: int, use_kernels: bool = False,
                        skip_residual: bool = False):
    """Particle-particle near field on a dense [r, r, cap] bucket grid
    ([r, r, r, cap] in 3D: the JAX package's `_near_field_buckets` and
    `barneshut3d._near_field_buckets3`), with the exact residual for
    overflowing cells; skip_residual=True drops the residual (the deep
    chain replaces those targets' near field). Particles with a flat id
    >= r^D (the extracted outliers) stay out of the grid; their rows are
    garbage and the caller discards them. Returns (acc [N, D],
    overflow_count tensor)."""
    res = 1 << levels
    rr = radius - 1
    b = _bucket_grid(pos, mass, ci, flat, res, cap, rr)
    acc = _bucket_stencil_dispatch(b, rr, eps_sq, res, use_kernels)
    acc_s = _bucket_gather(b, acc, res, cap)
    if not skip_residual:
        acc_s = _overflow_residual(b, acc_s, eps_sq, rr)
    acc = torch.empty_like(acc_s)
    acc[b.order] = g_const * acc_s
    return acc, b.overflow


def _extract_heavy_outliers(pos, mass):
    """Heavy-hitter and outlier extraction, shared by the force path and the
    occupancy probe (see the JAX module for the reasoning).

    Returns a dict with: is_heavy [N], h_pos [K,2], h_mass [K] (zeroed
    where unselected), field_mass [N] (heavies zeroed), is_out [N], out_i
    [k_out], out_sel [k_out], com [2], tree_mass [N] (heavies and outliers
    zeroed: what the pyramid sees), bulk_pos [N,2] (outliers parked at the
    COM). `torch.topk` stands for `lax.top_k`; with tied values the two may
    pick different indices."""
    n = pos.shape[0]
    device = pos.device
    k = min(_HEAVY_K, n)
    top_m, top_i = torch.topk(mass, k)
    heavy_sel = top_m >= 1e-3 * mass.sum()
    h_mass = torch.where(heavy_sel, top_m, 0.0)
    h_pos = pos[top_i]
    is_heavy = torch.zeros(n, dtype=torch.bool, device=device)
    is_heavy[top_i] = heavy_sel
    field_mass = torch.where(is_heavy, 0.0, mass)

    k_out = min(_OUTLIER_CAP, max(n // 16, 1))
    total_fm = torch.clamp_min(field_mass.sum(), 1e-30)
    com = (field_mass[:, None] * pos).sum(0) / total_fm
    cheb_dist = (pos - com).abs().amax(1)
    _, out_i = torch.topk(cheb_dist, k_out)
    is_out = torch.zeros(n, dtype=torch.bool, device=device)
    is_out[out_i] = True
    out_sel = is_out[out_i]

    tree_mass = torch.where(is_out, 0.0, field_mass)
    bulk_pos = torch.where(is_out[:, None], com[None, :], pos)
    return dict(
        is_heavy=is_heavy, h_pos=h_pos, h_mass=h_mass,
        field_mass=field_mass, is_out=is_out, out_i=out_i, out_sel=out_sel,
        com=com, tree_mass=tree_mass, bulk_pos=bulk_pos,
    )


def heavy_coupling(tgt_pos, h_pos, h_mass, eps_sq, g_const):
    """Exact [T, K] direct interaction of targets with the extracted heavy
    bodies (self pairs vanish via the d_sq > 0 guard). Plain torch: its
    [T, K, 2] temps are ~0.5 GB at N=1M, K=64."""
    d_h = h_pos[None, :, :] - tgt_pos[:, None, :]          # [T, K, 2]
    d_sq_h = (d_h * d_h).sum(-1)
    inv_h = torch.rsqrt(d_sq_h + eps_sq)
    w_h = h_mass[None, :] * (inv_h * inv_h * inv_h)
    w_h = torch.where(d_sq_h > 0.0, w_h, 0.0)
    return g_const * (w_h[:, :, None] * d_h).sum(1)


def _exact_couplings(pos, mass, eps_sq: float, g_const: float,
                     use_kernels: bool):
    """Heavy/outlier extraction and the exact couplings around the tree, in
    2D and 3D: targets <- heavy bodies (plain), outliers <- all (K1) and
    bulk <- outliers (K4); with use_kernels=False both through K1's plain
    version. Returns (ext, acc_heavy, acc_out, acc_from_out)."""
    ext = _extract_heavy_outliers(pos, mass)
    is_heavy, out_i, out_sel = ext["is_heavy"], ext["out_i"], ext["out_sel"]
    acc_heavy = heavy_coupling(pos, ext["h_pos"], ext["h_mass"], eps_sq,
                               g_const)

    if use_kernels:
        def _direct(tp, sp, sm):
            return allpairs_accelerations(
                tp, None, eps_sq=eps_sq, g_const=g_const, src_pos=sp,
                src_mass=sm)

        def _direct_wide(tp, sp, sm):
            return allpairs_accelerations_wide(
                tp, sp, sm, eps_sq=eps_sq, g_const=g_const)
    else:
        def _direct(tp, sp, sm):
            return allpairs_accelerations_plain(
                tp, None, eps_sq=eps_sq, g_const=g_const, src_pos=sp,
                src_mass=sm)

        _direct_wide = _direct

    # Exact forces ON outliers from all non-heavy sources (heavy forces on
    # them come from acc_heavy; other outliers are included here).
    acc_out = _direct(pos[out_i], pos, torch.where(is_heavy, 0.0, mass))
    # As sources toward the bulk, outliers must not re-contribute heavy mass;
    # bulk targets feel the outliers by exact [N, k_out] pairs (outlier rows
    # of this term are discarded by `_assemble`).
    out_src_mass = torch.where(out_sel & ~is_heavy[out_i], mass[out_i], 0.0)
    acc_from_out = _direct_wide(pos, pos[out_i], out_src_mass)
    return ext, acc_heavy, acc_out, acc_from_out


def _assemble(ext, far, near, acc_heavy, acc_out, acc_from_out):
    """Bulk rows: tree far + near field + outlier pairs; outlier rows: their
    exact forces; every row: the heavy coupling."""
    acc = torch.where(ext["is_out"][:, None], 0.0,
                      far + near + acc_from_out) + acc_heavy
    return acc.index_add(0, ext["out_i"],
                         torch.where(ext["out_sel"][:, None], acc_out, 0.0))


def _outlier_flat_ids(flat, is_out, n_cells: int):
    """Outliers must not enter the buckets: each gets a unique out-of-range
    flat id, so the scatter drops them and no probe matches them."""
    return torch.where(
        is_out, n_cells + torch.arange(flat.shape[0], device=flat.device),
        flat)


# ---------------------------------------------------------------------------
# The deep-overflow chain and its hot-zone tiles (the JAX package's
# barneshut.py:803-1384). Names and signatures are the JAX package's, so the
# banded multi-GPU tree can call the tile stages on their own.
# ---------------------------------------------------------------------------

_DEEP_SMOOTH = 0.09   # (0.3 s_d)^2: near-window cells act as Plummer clouds
                      # of width ~0.3 cell (see `_deep_near_aggregates`)
_HALO_MIN = 65536     # least halo-source capacity of `_tile_scatter`


def _compact_indices(mask, cap: int):
    """Fixed-capacity compaction of the True rows of `mask`: (sidx [cap],
    count). sidx holds the indices of the first `cap` True rows in order,
    the sentinel n beyond; count is the true total (a 0-dim tensor), and
    callers take the full-length pass when it exceeds cap."""
    n = mask.shape[0]
    rank = torch.cumsum(mask, 0) - 1
    sidx = torch.full((cap + 1,), n, dtype=torch.int64, device=mask.device)
    sidx[torch.where(mask & (rank < cap), rank, cap)] = torch.arange(
        n, device=mask.device)
    return sidx[:cap], mask.sum()


def _count_rows(what: str, need: int, cap: int, n: int) -> None:
    """The counters of a compacted pass: the rows it needs, and the rows it
    computes (its capacity where the count fits, else all n)."""
    profiling.count("tree.rows_needed." + what, need)
    profiling.count("tree.rows_computed." + what, cap if need <= cap else n)


def _deep_rows_cap(n: int) -> int:
    """Row capacity of the compacted deep L2P + aggregate pass when tiles
    are on (the rows the tiles do not refine)."""
    return max((3 * n) // 4, 4096)


def _refined_cap(n: int) -> int:
    """Row capacity of the compacted tile apply (the refined targets)."""
    return max(n // 4, 4096)


def _scatter_cap(n: int) -> int:
    """Row capacity of the compacted tile-scatter sources (the selected
    tiles' members and their selected-adjacent edge bands)."""
    return max((3 * n) // 8, 4096)


def _halo_cap(m: int) -> int:
    """Halo sources `_tile_scatter` keeps of its `m` input rows; past it,
    halo sources drop in index order. Unlike the other caps this one
    changes results, so it is the JAX package's exactly."""
    return min(m, max(m // 4, _HALO_MIN))


def _tile_candidates(ci_f, tile_slot, t: int, T: int, radius: int,
                     nt: int):
    """Each row's four candidate tile windows at the deep level: its home
    tile, and the x, y and corner neighbours when it lies within `radius`
    cells of that tile edge. Returns [(ok, slot)] in the order home,
    (1, 0), (0, 1), (1, 1); ok is True where that tile is selected."""
    H = radius
    tx, ty = ci_f[:, 0] // t, ci_f[:, 1] // t
    mx, my = ci_f[:, 0] % t, ci_f[:, 1] % t
    sx = torch.where(mx < H, -1, torch.where(mx >= t - H, 1, 0))
    sy = torch.where(my < H, -1, torch.where(my >= t - H, 1, 0))
    out = []
    for cx, cy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        ctx = tx + sx if cx else tx
        cty = ty + sy if cy else ty
        ok = (ctx >= 0) & (ctx < nt) & (cty >= 0) & (cty < nt)
        if cx:
            ok = ok & (sx != 0)
        if cy:
            ok = ok & (sy != 0)
        slot = tile_slot[torch.where(ok, ctx * nt + cty, nt * nt)]
        out.append((ok & (slot < T), slot))
    return out


def _tile_src_mask(ci_f, tile_slot, deep: int, radius: int, t: int,
                   T: int):
    """Rows that can contribute moments to any selected tile window: the
    selected tiles' members and the rows within `radius` of an edge whose
    neighbour tile is selected."""
    cands = _tile_candidates(ci_f, tile_slot, t, T, radius, (1 << deep) // t)
    return cands[0][0] | cands[1][0] | cands[2][0] | cands[3][0]


def _aggregate_window_eval(gp_flat, base, stride, payload, pos, eps_sq,
                           rr: int):
    """(2rr+1)^2 smoothed cell-aggregate kick, shared by the full-grid deep
    path and the tile path. gp_flat: [M, 6] flattened padded raw-moment
    cells (monopole at the COM plus quadrupole), or [M, 3] (m, sx, sy)
    rows, each cell then a monopole at its COM. base: [N] flat index of
    each particle's home cell in that layout; stride: its row stride;
    payload (the particle's own row, subtracted from its home cell) has
    gp_flat's channels. eps_sq arrives already widened by the Plummer-cloud
    term. Offsets summed in (ox, oy) order. Returns [N, 2], unscaled by
    g_const."""
    mono = gp_flat.shape[1] == 3
    px, py = pos[:, 0], pos[:, 1]
    ax = torch.zeros_like(px)
    ay = torch.zeros_like(py)
    for ox in range(-rr, rr + 1):
        for oy in range(-rr, rr + 1):
            ch = gp_flat[base + (ox * stride + oy)]          # [N, 6 or 3]
            if ox == 0 and oy == 0:
                ch = ch - payload
            m = ch[:, 0]
            safe_m = torch.where(m > 0, m, 1.0)
            comx = ch[:, 1] / safe_m
            comy = ch[:, 2] / safe_m
            dx = comx - px
            dy = comy - py
            q = dx * dx + dy * dy + eps_sq
            inv = torch.rsqrt(q)
            inv3 = inv * inv * inv
            w3 = m * inv3
            ax = ax + w3 * dx
            ay = ay + w3 * dy
            if mono:
                continue
            qxx = ch[:, 3] - m * comx * comx
            qxy = ch[:, 4] - m * comx * comy
            qyy = ch[:, 5] - m * comy * comy
            inv5 = inv3 * inv * inv
            inv7 = inv5 * inv * inv
            u7 = 15.0 * inv7
            u5 = 3.0 * inv5
            txxx = u7 * dx * dx * dx - 3.0 * u5 * dx
            txxy = u7 * dx * dx * dy - u5 * dy
            txyy = u7 * dx * dy * dy - u5 * dx
            tyyy = u7 * dy * dy * dy - 3.0 * u5 * dy
            ax = ax + 0.5 * (qxx * txxx + 2.0 * qxy * txxy + qyy * txyy)
            ay = ay + 0.5 * (qxx * txxy + 2.0 * qxy * txyy + qyy * tyyy)
    return torch.stack([ax, ay], -1)


def _deep_near_aggregates(pos, payload, gp, ci_deep, eps_sq, s_d,
                          rr: int, row0=0):
    """Smoothed-aggregate near field of the deep path: the (2rr+1)^2
    deepest-level cell aggregates evaluated at each particle.

    gp: [rows + 2rr, cols + 2rr, C] raw-moment window at the deep level,
    PRE-PADDED (rr zeros on one device; a row band with real halo rows in
    a banded tree); `row0` is the global deep row of its first real row,
    and out-of-window targets gather clipped rows (callers mask them).
    payload: [N, C] each particle's own row. Each cell acts as a Plummer
    cloud: the softening is widened to eps^2 + (0.3 s_d)^2 (s_d the deep
    cell size), so the kernel is smooth through a dense cell's interior
    (see the JAX module). Returns [N, 2], unscaled by g_const."""
    eps_sq = eps_sq + _DEEP_SMOOTH * s_d * s_d
    rows = gp.shape[0] - 2 * rr
    stride = gp.shape[1]
    gp = gp.reshape(-1, gp.shape[-1])
    row = torch.clamp(ci_deep[:, 0] - row0, 0, rows - 1) + rr
    col = ci_deep[:, 1] + rr
    return _aggregate_window_eval(gp, row * stride + col, stride, payload,
                                  pos, eps_sq, rr)


def _fold_aggregate_ring(local, window, corner, size, r_full: int, eps_sq,
                         radius: int, row0, rows: int):
    """Fold the OUTER ring (Chebyshev >= 2) of the smoothed aggregate window
    into the local expansion as a dense stencil, so the per-particle pass
    keeps only the inner 3 x 3. The folded cells are evaluated by the p=2
    Taylor of the widened (Plummer-cloud) kernel about the cell centre.
    `window`: 6 moment grids pre-padded by rr = radius - 1 (leading batch
    axes allowed, `corner` [..., 2]). No-op when rr < 2."""
    rr = radius - 1
    if rr < 2:
        return local
    s_d = size / r_full
    eps_w = eps_sq + _DEEP_SMOOTH * s_d * s_d
    ring = [(ox, oy)
            for ox in range(-rr, rr + 1)
            for oy in range(-rr, rr + 1)
            if max(abs(ox), abs(oy)) >= 2]
    terms = _m2l_stencil(window, corner, size, r_full, eps_w, radius,
                         row0=row0, rows=rows, offsets=ring,
                         gate_parity=False, pad=rr)
    return tuple(a + b for a, b in zip(local, terms))


def _tile_select(ci_f, b_par, deep: int, t: int, T: int, radius: int):
    """Top-T tiles by deep-path-target count. Returns (tid [N] home-tile
    id, tile_slot [nt^2 + 1] tile id -> slot (T = unselected; the last
    entry is the sentinel), orig [T, 2] window origin in deep cells = tile
    corner - radius).

    `lax.top_k` puts the lower index first among equal scores, and the
    scores are integer counts, so ties are common: a stable descending
    sort picks the same tiles in the same slots."""
    nt = (1 << deep) // t
    device = ci_f.device
    tid = (ci_f[:, 0] // t) * nt + ci_f[:, 1] // t
    scores = torch.zeros(nt * nt, dtype=torch.int64, device=device)
    scores.index_add_(0, tid, b_par.to(torch.int64))
    top_s, top_i = torch.sort(scores, descending=True, stable=True)
    top_s, top_i = top_s[:T], top_i[:T]
    # Score-0 tiles are not selected: they write to a dump entry past the
    # sentinel, which stays T.
    tile_slot = torch.full((nt * nt + 2,), T, dtype=torch.int64,
                           device=device)
    tile_slot[torch.where(top_s > 0, top_i, nt * nt + 1)] = torch.arange(
        T, device=device)
    orig = torch.stack([top_i // nt, top_i % nt], -1) * t - radius
    return tid, tile_slot[:nt * nt + 1], orig


def _tile_scatter(payload, bulk_pos, ci_f, tile_slot, orig, corner, size,
                  deep: int, radius: int, k: int, t: int, T: int,
                  src_mask=None):
    """Moment scatter into the selected tile windows at 2^k x the deep
    resolution -> g3k [T, Wf, Wf, 3] (m, sx, sy). Every row scatters into
    its home tile; the halo candidates (x, y, corner neighbours, `radius`
    cells from an edge) take only the first `_halo_cap(m)` rows, in index
    order, of the rows on an edge whose neighbour tile is selected (and,
    with `src_mask`, only those rows). The quadrupole channels are
    synthesized per level in `_tile_chain`."""
    m = bulk_pos.shape[0]
    f = 1 << k
    Wf = (t + 2 * radius) * f
    drop = T * Wf * Wf
    ci_sub, _ = _cell_ids(bulk_pos, corner, size, (1 << deep) * f)
    pay3 = payload[:, :3]
    cands = _tile_candidates(ci_f, tile_slot, t, T, radius, (1 << deep) // t)

    def dest(ok, slot, sub):
        rel = sub - orig[torch.clamp(slot, max=T - 1)] * f
        return torch.where(ok, (slot * Wf + rel[:, 0]) * Wf + rel[:, 1],
                           drop)

    g3t = torch.zeros((drop + 1, 3), dtype=bulk_pos.dtype,
                      device=bulk_pos.device)
    g3t.index_add_(0, dest(*cands[0], ci_sub), pay3)
    on_edge = cands[1][0] | cands[2][0] | cands[3][0]
    if src_mask is not None:
        on_edge = on_edge & src_mask
    bidx = torch.argsort((~on_edge).to(torch.int32), stable=True)[
        :_halo_cap(m)]
    pay_b = torch.where(on_edge[bidx, None], pay3[bidx], 0.0)
    for ok, slot in cands[1:]:
        g3t.index_add_(0, dest(ok[bidx], slot[bidx], ci_sub[bidx]), pay_b)
    return g3t[:drop].reshape(T, Wf, Wf, 3)


def _tile_chain(local_w, g3k, orig, corner, size, deep: int, radius: int,
                eps_sq, k: int, t: int, T: int):
    """Per-tile sub-level chain, the T tiles as one batch: upsample the
    window locals and add each sub-level's M2L terms (the tile grids'
    parity stays aligned with the global hierarchy: window origins are even
    at every sub-level), then fold the tile aggregate ring. Returns
    local_w [T, Wf, Wf, 9]."""
    W = t + 2 * radius
    s_D = size / (1 << deep)
    corner_t = corner[None, :] + orig.to(g3k.dtype) * s_D        # [T, 2]
    size_w = W * s_D
    pooled3 = {k: g3k}
    for j in range(k - 1, 0, -1):
        pooled3[j] = _pool_synth(pooled3[j + 1])
    for j in range(1, k + 1):
        g6 = _synth_quad_channels(pooled3[j])
        up = _l2l_upsample(tuple(local_w[..., c] for c in range(9)),
                           s_D / (1 << j))
        terms = _m2l_level(tuple(g6[..., c] for c in range(6)), corner_t,
                           size_w, eps_sq, radius)
        local_w = torch.stack([a + b for a, b in zip(up, terms)], -1)
    rr = radius - 1
    if rr >= 2:
        g6k = _synth_quad_channels(g3k)
        window = tuple(F.pad(g6k[..., c], (rr, rr, rr, rr)) for c in range(6))
        Wf = W << k
        local_w = torch.stack(_fold_aggregate_ring(
            tuple(local_w[..., c] for c in range(9)), window, corner_t,
            size_w, Wf, eps_sq, radius, 0, Wf), -1)
    return local_w


def _tile_apply(pos, payload, bulk_pos, ci_f, b_par, local_w, g3k,
                tile_slot, orig, corner, size, deep: int, radius: int,
                eps_sq, k: int, t: int, T: int):
    """Refined per-particle evaluation against the chained tile locals and
    the tile aggregates (inner 3 x 3; the ring is folded into local_w).
    Returns (refined [N] bool, far_ref [N, 2], near_ref [N, 2]); the
    outputs are unscaled by g_const and garbage where ~refined."""
    dtype = pos.dtype
    rD = 1 << deep
    f = 1 << k
    Wf = (t + 2 * radius) * f
    nt = rD // t
    tid = (ci_f[:, 0] // t) * nt + ci_f[:, 1] // t
    ci_sub, _ = _cell_ids(bulk_pos, corner, size, rD * f)
    slot_home = tile_slot[tid]
    refined = (slot_home < T) & b_par
    sc = torch.clamp(slot_home, max=T - 1)
    rel = torch.clamp(ci_sub - orig[sc] * f, 0, Wf - 1)

    s_k = size / rD / f
    centx = corner[0] + (ci_sub[:, 0].to(dtype) + 0.5) * s_k
    centy = corner[1] + (ci_sub[:, 1].to(dtype) + 0.5) * s_k
    g9 = local_w.reshape(T * Wf * Wf, 9)[(sc * Wf + rel[:, 0]) * Wf
                                         + rel[:, 1]]
    far_x, far_y = _taylor_eval(tuple(g9[:, i] for i in range(9)),
                                pos[:, 0] - centx, pos[:, 1] - centy)

    rin = min(radius - 1, 1)
    g3kp = F.pad(g3k, (0, 0, rin, rin, rin, rin))
    stride = Wf + 2 * rin
    base = (sc * stride + rel[:, 0] + rin) * stride + rel[:, 1] + rin
    near_ref = _aggregate_window_eval(
        g3kp.reshape(-1, 3), base, stride, payload[:, :3], pos,
        eps_sq + _DEEP_SMOOTH * s_k * s_k, rin)
    return refined, torch.stack([far_x, far_y], -1), near_ref


def _scatter_rows(n, idx, *rows):
    """Rows computed for the compacted indices `idx` (the sentinel n where
    invalid) back to length n, zero elsewhere."""
    out = []
    for r in rows:
        full = torch.zeros((n + 1,) + r.shape[1:], dtype=r.dtype,
                           device=r.device)
        full[idx] = r
        out.append(full[:n])
    return out


def _compact_rows(mask, cap: int, what: str):
    """The True rows of `mask` compacted to `cap`, for a pass that runs on
    them alone: the count is one host sync (`host_read.<what>_rows`) and
    the counters `tree.rows_needed.<what>` / `.rows_computed.<what>` keep
    it. Returns (idx [cap] clamped into range, valid [cap]) where the count
    fits the cap, else None: the pass then takes every row (both give the
    same result)."""
    n = mask.shape[0]
    sidx, count = _compact_indices(mask, cap)
    count = profiling.host_read(count, what + "_rows")
    _count_rows(what, count, cap, n)
    if count > cap:
        return None
    return torch.clamp(sidx, max=n - 1), sidx < n


def _tile_windows(local_deep, orig, t: int, radius: int):
    """Each tile's window [T, W, W, 9] of the level-D locals, zero beyond
    the grid: one stacked gather, no host sync for the origins."""
    H = radius
    locDp = F.pad(torch.stack(local_deep, -1), (0, 0, H, H, H, H))
    span = torch.arange(t + 2 * H, device=orig.device)
    rows = orig[:, 0, None] + H + span                       # [T, W]
    cols = orig[:, 1, None] + H + span
    return locDp[rows[:, :, None], cols[:, None, :]]


def _tile_eval(tree, pos, payload, bulk_pos, ci_f, b_par, local_w,
               tid, tile_slot, orig, corner, size, deep: int, radius: int,
               eps_sq, k: int, t: int, T: int):
    """Per-tile chain and refined per-particle evaluation, given the window
    slice of the level-D locals, with `tree`'s stages (`_stages`). The
    scatter takes only the rows that can reach a selected window, and the
    apply only the refined targets, each compacted to its cap when the
    count fits it (`_compact_rows`: `scatter`, `apply`), else over all
    rows; both give the same result."""
    n = pos.shape[0]
    geo = (corner, size, deep, radius, k, t, T)
    g = None
    s_cap = tree.scatter_cap(n)
    if s_cap < n:
        rows = _compact_rows(
            tree.tile_src_mask(ci_f, tile_slot, deep, radius, t, T), s_cap,
            "scatter")
        if rows is not None:
            ss, valid_s = rows
            g = tree.tile_scatter(
                torch.where(valid_s[:, None], payload[ss], 0.0),
                bulk_pos[ss], ci_f[ss], tile_slot, orig, *geo,
                src_mask=valid_s)
    if g is None:
        g = tree.tile_scatter(payload, bulk_pos, ci_f, tile_slot, orig, *geo)
    local_w = tree.tile_chain(local_w, g, orig, corner, size, deep,
                              radius, eps_sq, k, t, T)

    cap = tree.refined_cap(n)
    if cap < n:
        rows = _compact_rows((tile_slot[tid] < T) & b_par, cap, "apply")
        if rows is not None:
            si, valid = rows
            r_s, far_s, near_s = tree.tile_apply(
                pos[si], payload[si], bulk_pos[si], ci_f[si],
                b_par[si] & valid, local_w, g, tile_slot, orig,
                corner, size, deep, radius, eps_sq, k, t, T)
            return tuple(_scatter_rows(
                n, torch.where(valid & r_s, si, n), r_s, far_s, near_s))
    return tree.tile_apply(pos, payload, bulk_pos, ci_f, b_par, local_w, g,
                           tile_slot, orig, corner, size, deep, radius,
                           eps_sq, k, t, T)


def _tile_refine(pos, payload, bulk_pos, ci_f, b_par, local_deep,
                 corner, size, deep: int, radius: int, eps_sq,
                 k: int, t: int, T: int):
    """Hot-zone sub-box refinement, in 2D and 3D: continue the deep chain k
    more levels inside the T hottest tiles (t cells a side) of the deepest
    level, so the aggregates' smoothing scale drops 2^k where the targets
    crowd (see the JAX module). Targets whose home tile is not selected
    keep the deep path. Returns (refined [N] bool, far_ref [N, D],
    near_ref [N, D]), unscaled by g_const and garbage where ~refined."""
    tree = _stages(pos.shape[1])
    tid, tile_slot, orig = tree.tile_select(ci_f, b_par, deep, t, T, radius)
    local_w = tree.tile_windows(local_deep, orig, t, radius)
    return _tile_eval(tree, pos, payload, bulk_pos, ci_f, b_par, local_w,
                      tid, tile_slot, orig, corner, size, deep, radius,
                      eps_sq, k=k, t=t, T=T)


def _deep_targets(flat_nf, flat, is_out, res: int, near_cap: int,
                  radius: int):
    """b_par [N]: the deep path's targets, the bulk rows whose bucket
    stencil window (Chebyshev radius - 1) holds an overflowing cell.
    Outliers never take it (and must not inflate the tile scores)."""
    occ = torch.zeros(res * res + 1, dtype=torch.int32, device=flat.device)
    occ.index_add_(0, torch.clamp(flat_nf, max=res * res),
                   torch.ones_like(flat_nf, dtype=torch.int32))
    hot = (occ[:res * res] > near_cap).to(torch.float32).reshape(
        1, 1, res, res)
    rr = radius - 1
    bmask = F.max_pool2d(hot, 2 * rr + 1, stride=1, padding=rr)[0, 0] > 0
    return bmask.reshape(-1)[flat] & ~is_out


def _deep_chain(tree, pos, bulk_pos, tree_mass, grids, local, corner, size,
                ci_f, b_par, far, near, levels: int, deep: int,
                eps_sq: float, g_const: float, radius: int, tile_levels: int,
                tile_size: int, tile_count: int):
    """The deep branch of `_bh_accelerations`, with `tree`'s stages:
    continue the downward pass from the bucket level's locals to `deep`,
    and give the deep-path targets (b_par) the deep L2P against the
    ring-folded locals plus the inner 3^D smoothed aggregates (the span
    `tree.deep`), then the tile refinement (`tree.tiles`). Returns the
    overridden (far, near), scaled by g_const. The octree first reads
    whether any target takes the deep path (`host_read.deep_targets`), and
    without one nothing changes and nothing runs."""
    n, dim = pos.shape
    with profiling.span("tree.deep"):
        if tree.reads_deep_targets and not profiling.host_read(
                b_par.any(), "deep_targets"):
            return far, near
        for lv in range(levels + 1, deep + 1):
            terms = tree.m2l_level(grids[lv], corner, size, eps_sq, radius)
            up = tree.l2l_upsample(local, size / (1 << lv))
            local = tuple(u + t for u, t in zip(up, terms))
        local_deep = local

        payload = tree.moment_payload(pos, tree_mass)
        rrd = radius - 1
        rin = min(rrd, 1)    # inner aggregate window; the ring folds into L2P
        # The tiles must see the UN-folded local_deep: their sub-level chain
        # re-decomposes the window the fold covers. Below R = 3 the fold is
        # a no-op: its padded window (7 GB at the octree's 256^3) is not
        # built.
        local_agg = local_deep
        if rrd >= 2:
            local_agg = tree.fold_ring(
                local_deep,
                tuple(F.pad(g, (rrd,) * (2 * dim)) for g in grids[deep]),
                corner, size, 1 << deep, eps_sq, radius, row0=0,
                rows=1 << deep)
        g_pad = F.pad(torch.stack(grids[deep][:dim + 1], -1),
                      (0, 0) + (rin,) * (2 * dim))
        s_d = size / (1 << deep)

        def deep_rows(pos_r, ci_r, pay_r):
            far_r = g_const * tree.l2p_eval(local_agg, ci_r, pos_r, corner,
                                            size, deep)
            near_r = g_const * tree.deep_near_aggregates(
                pos_r, pay_r, g_pad, ci_r, eps_sq, s_d, rr=rin)
            return far_r, near_r

        rows_d = None
        dcap = tree.deep_rows_cap(n)
        if tile_levels and dcap < n:
            # Rows the tiles refine discard the deep rows' output, so only
            # b_par & ~refined rows run them (refined equals this cand).
            tid_d, tile_slot_d, _ = tree.tile_select(
                ci_f, b_par, deep, tile_size, tile_count, radius)
            cand = (tile_slot_d[tid_d] < tile_count) & b_par
            rows = _compact_rows(b_par & ~cand, dcap, "deep")
            if rows is not None:
                sd, valid = rows
                rows_d = _scatter_rows(n, torch.where(valid, sd, n),
                                       *deep_rows(pos[sd], ci_f[sd],
                                                  payload[sd, :dim + 1]))
        if rows_d is None:
            rows_d = deep_rows(pos, ci_f, payload[:, :dim + 1])
        far = torch.where(b_par[:, None], rows_d[0], far)
        near = torch.where(b_par[:, None], rows_d[1], near)
    if tile_levels:
        with profiling.span("tree.tiles"):
            refined, far_ref, near_ref = _tile_refine(
                pos, payload, bulk_pos, ci_f, b_par, local_deep, corner, size,
                deep, radius, eps_sq, k=tile_levels, t=tile_size, T=tile_count)
            sel = refined[:, None]
            far = torch.where(sel, g_const * far_ref, far)
            near = torch.where(sel, g_const * near_ref, near)
    return far, near


def _bh_accelerations(pos, mass, levels: int, eps_sq: float, g_const: float,
                      near_cap: int, radius: int, use_kernels: bool = False,
                      deep_levels: int = 0, tile_levels: int = 0,
                      tile_size: int = 32, tile_count: int = 8,
                      nf_sparse: bool = False):
    """The tree-code force evaluation, the quadtree's for a 2D `pos` and the
    octree's for a 3D one (the JAX package's `_bh_accelerations` and
    `_bh3_accelerations`): each stage is that tree's (`_stages`). With
    use_kernels, the near field is K3 (K7 in 3D) and the outlier couplings
    are K1 (outliers <- all) and K4 (bulk <- outliers); on a CPU tensor
    those wrappers run their plain versions. use_kernels=False runs the
    plain versions on any device; the M2L takes its kernel on any CUDA
    tensor. deep_levels > levels turns on the deep-overflow chain
    (`_deep_chain`), tile_levels > 0 its hot-zone tiles, and nf_sparse
    (3D, with the deep chain) the sparse near field in place of the bucket
    grid.

    Its stages are the spans `tree.couplings`, `tree.pyramid`,
    `tree.downward`, `tree.near` (with the deep path's targets and the
    sparse near field), `tree.deep`, `tree.tiles` and `tree.assemble`;
    each M2L level is `tree.m2l` inside its stage."""
    dim = pos.shape[1]
    tree = _stages(dim)
    with profiling.span("tree.couplings"):
        ext, acc_heavy, acc_out, acc_from_out = _exact_couplings(
            pos, mass, eps_sq, g_const, use_kernels)

    tree_mass = ext["tree_mass"]          # the tree sees only the bulk
    bulk_pos = ext["bulk_pos"]
    deep = deep_levels if deep_levels > levels else 0
    res = 1 << levels
    with profiling.span("tree.pyramid"):
        grids, corner, size, ci_f, flat_f = tree.build_pyramid(
            bulk_pos, tree_mass, deep or levels, synth_quad=bool(deep))
        if deep:
            ci = ci_f >> (deep - levels)           # bucket-level cell indices
            flat = _flat_ids(ci, res)
        else:
            ci, flat = ci_f, flat_f

    # Downward pass: M2L at each level + L2L to the next.
    with profiling.span("tree.downward"):
        local = None
        for lv in range(2, levels + 1):
            terms = tree.m2l_level(grids[lv], corner, size, eps_sq, radius)
            if local is None:
                local = terms
            else:
                up = tree.l2l_upsample(local, size / (1 << lv))
                local = tuple(u + t for u, t in zip(up, terms))
        far = g_const * tree.l2p_eval(local, ci, pos, corner, size, levels)
    with profiling.span("tree.near"):
        flat_nf = _outlier_flat_ids(flat, ext["is_out"], res ** dim)
        if deep:
            b_par, hot = tree.deep_targets(flat_nf, flat, ext["is_out"], res,
                                           near_cap, radius)
        if deep and nf_sparse:
            near, b_par = tree.sparse_near_field(
                pos, bulk_pos, tree_mass, ci, flat, hot, b_par,
                ext["is_out"], eps_sq, g_const, radius)
        else:
            near, _ = _near_field_buckets(
                pos, tree_mass, ci, flat_nf, levels, eps_sq, g_const,
                near_cap, radius, use_kernels=use_kernels,
                skip_residual=bool(deep))
    if deep:
        far, near = _deep_chain(
            tree, pos, bulk_pos, tree_mass, grids, local, corner, size, ci_f,
            b_par, far, near, levels, deep, eps_sq, g_const, radius,
            tile_levels, tile_size, tile_count)
    with profiling.span("tree.assemble"):
        return _assemble(ext, far, near, acc_heavy, acc_out, acc_from_out)


def _near_overflow(pos: torch.Tensor, mass: torch.Tensor,
                   levels: int) -> int:
    """Bulk particles beyond the bucket cap on the res^D finest grid, after
    the same heavy/outlier extraction the force path applies (no forces;
    2D and 3D)."""
    n, dim = pos.shape
    res = 1 << levels
    ext = _extract_heavy_outliers(pos, mass)
    corner, size = _bounding_box(ext["bulk_pos"])
    _, flat = _cell_ids(ext["bulk_pos"], corner, size, res)
    flat_s = torch.sort(
        _outlier_flat_ids(flat, ext["is_out"], res ** dim)).values
    slot = torch.arange(n, device=pos.device) - sorted_first_occurrence(flat_s)
    in_bulk = flat_s < res ** dim
    return int(((slot >= NEAR_CAP) & in_bulk).sum())


def bh_near_overflow(pos: torch.Tensor, mass: torch.Tensor,
                     config: SimConfig) -> int:
    """Bulk particles beyond the near-field bucket cap of the tree for
    `pos`'s dimension (see `_near_overflow`)."""
    levels = _stages(pos.shape[1]).resolve_levels(config, pos.shape[0])
    return _near_overflow(pos, mass, levels)


def resolve_tree_for_state(pos, mass, config: SimConfig) -> SimConfig:
    """Pin the tree's 'auto' choices from the state, as the JAX package's
    `resolve_config_for_state` does once it has picked the tree: where the
    near-field overflow (`bh_near_overflow`) exceeds the exact residual's
    capacity, the scene is too clustered for the buckets alone, so this
    warns (RuntimeWarning) and turns on the deep-overflow chain and its
    tiles (bh_deep_levels=-1); then it pins bh_nf_sparse
    (`_resolve_nf_sparse`)."""
    over = bh_near_overflow(pos, mass, config)
    if over > _OVERFLOW_CAP and config.bh_deep_levels == 0:
        warnings.warn(
            f"auto force backend: near-field overflow {over} exceeds the "
            f"exact-residual capacity {_OVERFLOW_CAP}; enabling the "
            f"deep-overflow multipole chain + tile refinement (tree-PM "
            f"regime: forces inside ultra-dense cells are smoothed at the "
            f"deep/tile-grid scale). Set force_backend explicitly to "
            f"override.", RuntimeWarning)
        # bh_tile_levels defaults to -1 (on with the deep chain); an
        # explicit 0 keeps tiles off.
        config = config.replace(bh_deep_levels=-1)
    return _resolve_nf_sparse(pos, mass, config)


def check_tree_capacity(pos, mass, config: SimConfig, when: str) -> bool:
    """With the deep chain off: whether the near-field overflow exceeds the
    exact residual's capacity (excess particles get no near-field force) on
    `when` (the state's name in the warning); warns (RuntimeWarning) where
    it does."""
    over = bh_near_overflow(pos, mass, config)
    if over <= _OVERFLOW_CAP:
        return False
    warnings.warn(
        f"BH near-field overflow {over} exceeds the residual "
        f"capacity {_OVERFLOW_CAP} on {when}; excess particles "
        f"get no near-field force. Set bh_deep_levels=-1 (the "
        f"deep-overflow chain), or use force_backend='cuda' for "
        f"this scene.", RuntimeWarning)
    return True


def _resolve_nf_sparse(pos, mass, config: SimConfig) -> SimConfig:
    """Pin bh_nf_sparse = -1 (auto) to 0 or 1, as the JAX package's
    `_resolve_nf_sparse` does: 0 in 2D, and 0 in 3D whenever the deep chain
    is off; with the 3D deep chain on, 1 when the bucket-tier targets
    (`bh3_bucket_tier_count`) fit half the sparse pass's capacity."""
    if config.bh_nf_sparse != -1:
        return config
    tree = _stages(pos.shape[1])
    if tree.sparse_near_field is None or not tree.resolve_deep_levels(
            config, tree.resolve_levels(config, pos.shape[0])):
        return config.replace(bh_nf_sparse=0)
    count = tree.bucket_tier_count(pos, mass, config)
    return config.replace(
        bh_nf_sparse=1 if count <= tree.nf_sparse_cap // 2 else 0)


def _resolve_levels(config: SimConfig, n: int) -> int:
    """Finest grid level: config.bh_levels, or ~4 particles per cell
    (r ~ sqrt(N/4)), clamped to 3..10 (the JAX package's rule)."""
    levels = config.bh_levels
    if levels <= 0:
        levels = max(3, min(10, ((max(n, 16)) - 1).bit_length() - 2 >> 1))
    return levels


_MAX_DEEP_2D = 13


def _resolve_deep_levels(config: SimConfig, levels: int) -> int:
    """Deep-overflow chain depth: 0 disables; > 0 is explicit; -1 (auto)
    descends 2 levels past the buckets (16x the per-cell resolution),
    capped at `_MAX_DEEP_2D` (an 8192^2 moment grid). A depth at or above
    the bucket level disables it. `resolve_tree_for_state` turns auto on
    only for scenes whose overflow exceeds the residual's cap."""
    d = config.bh_deep_levels
    if d == 0:
        return 0
    if d < 0:
        d = levels + 2
    return max(levels + 1, min(d, _MAX_DEEP_2D)) if d > levels else 0


def _resolve_tile_params(config: SimConfig, deep: int,
                         radius: int) -> Tuple[int, int, int]:
    """(k sub-levels, tile side t, tile count T) of the hot-zone tiles;
    (0, 0, 0) disables. Tiles exist only with the deep chain."""
    k = config.bh_tile_levels
    if deep == 0 or k == 0:
        return 0, 0, 0
    if k < 0:
        k = 3
    t = config.bh_tile_size or 32
    r_d = 1 << deep
    count = config.bh_tile_count
    while t > 2 and (r_d // max(t, 1)) ** 2 < max(count, 4):
        t //= 2
    if t < 2 * radius or t <= 0 or r_d % t:
        return 0, 0, 0
    return k, t, count


def _resolve_radius(config: SimConfig) -> int:
    """Acceptance radius; bh_accept_radius=0 derives it from theta
    (R ~ 1 + 1/theta), floored at 3, clamped to 2..5."""
    r = config.bh_accept_radius
    if r <= 0:
        r = max(3, int(round(1.0 + 1.0 / max(config.theta, 0.25))))
    return max(2, min(5, r))


class _Stages(NamedTuple):
    """One tree's stage math, row caps and resolvers: what the pipeline
    (`_bh_accelerations`, `_deep_chain`, `_tile_eval`, `bh_accelerations`
    and the state probes) calls for one dimension."""
    build_pyramid: Callable
    m2l_level: Callable
    l2l_upsample: Callable
    l2p_eval: Callable
    moment_payload: Callable
    deep_targets: Callable            # -> (b_par, hot cells; None in 2D)
    fold_ring: Callable
    deep_near_aggregates: Callable
    tile_select: Callable
    tile_src_mask: Callable
    tile_scatter: Callable
    tile_chain: Callable
    tile_apply: Callable
    tile_windows: Callable
    deep_rows_cap: Callable
    scatter_cap: Callable
    refined_cap: Callable
    resolve_levels: Callable
    resolve_radius: Callable
    resolve_deep_levels: Callable
    resolve_tile_params: Callable
    # Whether the deep chain first reads if any target takes it.
    reads_deep_targets: bool
    # The sparse near field (3D only; None in 2D), its pin's count and cap.
    sparse_near_field: Optional[Callable]
    bucket_tier_count: Optional[Callable]
    nf_sparse_cap: int


def _stages(dim: int) -> _Stages:
    """The `dim`-D tree's stages: the quadtree's from this module, the
    octree's from `physics/barneshut3d.py`. Built at each call from the
    modules' globals, so a patched stage or cap takes effect."""
    if dim == 2:
        return _Stages(
            _build_pyramid, _m2l_level, _l2l_upsample, _l2p_eval,
            _moment_payload, lambda *a: (_deep_targets(*a), None),
            _fold_aggregate_ring, _deep_near_aggregates, _tile_select,
            _tile_src_mask, _tile_scatter, _tile_chain, _tile_apply,
            _tile_windows, _deep_rows_cap, _scatter_cap, _refined_cap,
            _resolve_levels, _resolve_radius, _resolve_deep_levels,
            _resolve_tile_params, reads_deep_targets=False,
            sparse_near_field=None, bucket_tier_count=None, nf_sparse_cap=0)
    from nbodysim_tpu_torch.physics import barneshut3d as b3

    return _Stages(
        b3._build_pyramid3, b3._m2l_level3, b3._l2l_upsample3, b3._l2p_eval3,
        b3._moment_payload3, b3._deep_targets3, b3._fold_aggregate_ring3,
        b3._deep_near_aggregates3, b3._tile_select3, b3._tile_src_mask3,
        b3._tile_scatter3, b3._tile_chain3, b3._tile_apply3,
        b3._tile_windows3, b3._deep_rows_cap3, b3._scatter_cap3,
        b3._refined_cap3, b3._resolve_levels3, b3._resolve_radius3,
        b3._resolve_deep_levels3, b3._resolve_tile_params3,
        reads_deep_targets=True, sparse_near_field=b3._sparse_near_field3,
        bucket_tier_count=b3.bh3_bucket_tier_count,
        nf_sparse_cap=b3._NF_SPARSE_CAP)


def bh_accelerations(pos: torch.Tensor, mass: torch.Tensor,
                     config: SimConfig, *,
                     use_kernels: Optional[bool] = None) -> torch.Tensor:
    """Approximate softened accelerations via the stencil FMM tree code:
    the quadtree for a 2D `pos`, the octree for a 3D one, as the JAX
    package dispatches. use_kernels (default: the tensors lie on a CUDA
    device) routes the near field and the outlier couplings to K3 (K7 in
    3D), K1 and K4; False runs the same tree code through their plain
    versions (the reference on the card). It is an internal switch, not a
    configuration field."""
    tree = _stages(pos.shape[1])
    levels = tree.resolve_levels(config, pos.shape[0])
    deep = tree.resolve_deep_levels(config, levels)
    radius = tree.resolve_radius(config)
    tk, tt, tc = tree.resolve_tile_params(config, deep, radius)
    if use_kernels is None:
        # The JAX package's `_nf_use_pallas` (Pallas on the TPU).
        use_kernels = pos.device.type == "cuda"
    return _bh_accelerations(
        pos, mass, levels=levels, eps_sq=float(config.eps_sq),
        g_const=float(config.g_const), near_cap=NEAR_CAP, radius=radius,
        use_kernels=use_kernels, deep_levels=deep, tile_levels=tk,
        tile_size=tt, tile_count=tc,
        nf_sparse=(bool(deep) and config.bh_nf_sparse == 1
                   and tree.sparse_near_field is not None))
