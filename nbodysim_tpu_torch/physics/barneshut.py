"""The 2D tree code: a stencil-based multilevel FMM (port of
`nbodysim_tpu.physics.barneshut`, without its deep-overflow chain).

A kernel-independent FMM over the complete quadtree of a 2^L x 2^L grid;
the JAX module's docstring gives the design at length:

  upward (M2M):  scatter particle mass and raw first/second moments into the
                 finest grid (`index_add_`), 2 x 2 sum-pool up the pyramid.
  M2L:           per level, the V-list (Chebyshev distance R..2R-1, parity-
                 gated on the outer ring) as ONE parent-level convolution
                 (`_m2l_conv`, `F.conv2d`) into p=2 local terms (F, J, H);
                 `_m2l_stencil` is its plain reference.
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

Differences from the JAX package, each deliberate:
  * the M2L convolution runs in full f32 at every level, with cuDNN's TF32
    switched off around the call (the JAX package pins HIGHEST, and drops to
    HIGH, bf16x3, at r >= 1024; full f32 is at least as exact);
  * the residual tiers are a Python branch on `int(overflow)`: one host
    sync per force evaluation, where the JAX package uses `lax.cond`;
  * on the card the residual's pair blocks are 32768 wide instead of 2048
    (the same function in ~16x fewer launches);
  * the deep-overflow chain and hot-zone tiles (`bh_deep_levels != 0`,
    barneshut.py:803-1392 of the JAX package) are ROADMAP item 10: asking
    for them raises NotImplementedError, and `forces.resolve_config_for_state`
    raises where the JAX package would switch them on.

The bucket grid, its gather and the overflow residual take 2D and 3D
alike; `physics/barneshut3d.py` (the octree) shares them.

Scatter order: `index_add_` on CUDA uses atomics, so the pyramid's sums
differ in the last bits from run to run; tolerances state that as their
reason.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.core.blocking import (
    pairwise_blocked, sorted_first_occurrence)
from nbodysim_tpu_torch.kernels.allpairs import (
    allpairs_accelerations, allpairs_accelerations_plain,
    allpairs_accelerations_wide)
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
    flat = ci[:, 0]
    for a in range(1, pos.shape[1]):
        flat = flat * res + ci[:, a]
    return ci, flat


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


def _build_pyramid(pos, mass, levels: int, synth_quad: bool = False):
    """Six moment grids per level, levels L..0 (fine to coarse), from ONE
    [N, 6]-payload `index_add_` and one 2 x 2 pooling per level.

    synth_quad=True scatters only (m, sx, sy) and synthesizes the
    quadrupole channels as point-at-COM raw moments (the JAX package's deep
    mode). Returns (grids, corner, size, ci [N, 2] int64, flat [N])."""
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
        g6 = g6.reshape(r, 2, r, 2, 6).sum((1, 3))
        grids[lv] = tuple(g6[:, :, i] for i in range(6))
    return grids, corner, size, ci, flat


def _m2l_level(grids_l, corner, size, eps_sq, radius: int):
    """V-list pass at one full level -> p=2 local terms (F, J, H).

    Even grids (every real level) run as the parent-level convolution
    (`_m2l_conv`); the stencil is the reference and the odd-size path."""
    r = grids_l[0].shape[0]
    if r % 2 == 0 and r >= 2:
        qh = radius - 1
        gx = F.pad(torch.stack(grids_l, -1), (0, 0, 0, 0, 2 * qh, 2 * qh))
        return _m2l_conv(gx, corner, size, r, eps_sq, radius, row0=0, rows=r)
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
    the V-list (the deep chain's ring fold, ROADMAP item 10). Offsets are
    summed in order, as the JAX package's scan does."""
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
    cx = corner[0] + (gx_i.to(dtype) + 0.5) * s_l
    cy = corner[1] + (gy_i.to(dtype) + 0.5) * s_l
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
            return a[p + ox:p + ox + rows, p + oy:p + oy + r_full]

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
    """Raw origin moments [X, r, 6] -> moments about each cell's own centre
    in CELL UNITS: (m, d/s_l, Q/s_l^2). x0 = global row of row 0."""
    dtype, device = g6.dtype, g6.device
    s_l = size / r_full
    inv_s = 1.0 / s_l
    shape = g6.shape[:2]
    cx = corner[0] + (_iota(shape, 0, device) + x0).to(dtype) * s_l \
        + 0.5 * s_l
    cy = corner[1] + _iota(shape, 1, device).to(dtype) * s_l + 0.5 * s_l
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
    """One 2D M2L level as the parent-level convolution.

    gx: [rows + 4(Rp-1), r_full, 6] raw-moment row window whose first and
    last 2(Rp-1) rows are halo (zeros beyond the grid); its row 0 is global
    row row0 - 2(Rp-1). row0 and rows must be even. Returns the 9 local
    terms, [rows, r_full] each.

    XLA's NHWC/HWIO `conv_general_dilated` becomes `F.conv2d` on NCHW/OIHW;
    both are cross-correlations, so the taps need no flip. It runs in full
    f32 at every level (`_full_f32_conv`); the JAX package uses HIGH
    (bf16x3) at r >= 1024, which this is at least as exact as."""
    Rp = radius if r_parent is None else r_parent
    qh = Rp - 1
    h = r_full // 2
    hb = rows // 2
    dtype = gx.dtype

    ch = _center_channels(gx, corner, size, r_full, row0 - 2 * qh)
    X = rows + 4 * qh
    m4 = (ch.reshape(X // 2, 2, h, 2, 6)
          .permute(0, 2, 1, 3, 4)
          .reshape(X // 2, h, 24))
    m4 = F.pad(m4, (0, 0, qh, qh))                      # [X/2, h + 2qh, 24]
    s_l = size / r_full
    W = _m2l_conv_weights(radius, Rp, eps_sq / (s_l * s_l), dtype, gx.device)
    k = 2 * Rp - 1
    weight = W.reshape(k, k, 24, 36).permute(3, 2, 0, 1).contiguous()
    with _full_f32_conv():
        out = F.conv2d(m4.permute(2, 0, 1)[None].contiguous(), weight)[0]
    inv_s = 1.0 / s_l
    s2 = inv_s * inv_s
    scales = (s2, s2, s2 * inv_s, s2 * inv_s, s2 * inv_s,
              s2 * s2, s2 * s2, s2 * s2, s2 * s2)
    # Channel (2c + d) * 9 + t of parent cell (i, j) is term t of child
    # (2i + c, 2j + d): de-space-to-depth to [9, rows, r_full].
    terms = (out.reshape(2, 2, 9, hb, h).permute(2, 3, 0, 4, 1)
             .reshape(9, rows, r_full))
    return tuple(terms[t] * scales[t] for t in range(9))


def _l2l_upsample(local, s_child):
    """Shift parent local expansions to the 4 child centres and upsample:
    F' = F + J d + (1/2) d^T H d, J' = J + H d, H' = H (rectangular grids
    too; the first row must be even)."""
    fx, fy, jxx, jxy, jyy, hxxx, hxxy, hxyy, hyyy = local
    r0, r1 = fx.shape

    def up(a):
        return a.repeat_interleave(2, 0).repeat_interleave(2, 1)

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


def _bucket_stencil_dispatch(grid, rr, eps_sq, center_rows,
                             use_kernels: bool):
    """K3 on a 2D grid (bx, by, bm), K7 on a 3D one (bx, by, bz, bm) -- the
    wrappers launch the kernel on a CUDA tensor and run the plain version
    on a CPU one -- or, with use_kernels=False, the plain version
    anywhere."""
    if len(grid) == 3:
        if use_kernels:
            return bucket_stencil(*grid, rr=rr, eps_sq=eps_sq,
                                  center_rows=center_rows)
        return bucket_stencil_plain(*grid, rr, eps_sq, center_rows)
    if use_kernels:
        return bucket_stencil3(*grid, rr=rr, eps_sq=eps_sq,
                               center_rows=center_rows)
    return bucket_stencil3_plain(*grid, rr, eps_sq, center_rows)


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


def _bucket_grid(pos, mass, ci, flat, res: int, cap: int,
                 rr: int) -> _Buckets:
    """Sort particles by cell, rank them inside it, and scatter the first
    `cap` of each cell into the bucket grid, in 2D or 3D (D = pos.shape[1]
    grid axes). Particles with a flat id >= res^D (the extracted outliers)
    and overflow go to one extra dump entry that is cut off (JAX:
    mode="drop")."""
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
    dest = torch.where(in_cap & (flat_s < n_cells), flat_s * cap + slot,
                       size)
    halo = (0, 0) * dim + (rr, rr)     # zero x-slabs on both sides

    def scat(v):
        g = torch.zeros(size + 1, dtype=pos.dtype, device=device)
        g[dest] = v
        return F.pad(g[:size].reshape((res,) * dim + (cap,)), halo)

    grid = tuple(scat(pos_s[:, a]) for a in range(dim)) + (
        scat(torch.where(in_cap, mass_s, 0.0)),)
    return _Buckets(order, flat_s, slot, in_cap, pos_s, mass_s, ci[order],
                    (slot >= cap).sum(), grid)


def _bucket_gather(b: _Buckets, acc, res: int, cap: int):
    """Per-slot stencil outputs (one grid per axis) -> [N, D] in sorted
    order (0 past the cap). Gathers clamp out-of-grid ids, as JAX's do;
    those rows are garbage."""
    n_cells = res ** len(acc)
    gidx = (torch.clamp(b.flat_s, max=n_cells - 1) * cap
            + torch.clamp(b.slot, max=cap - 1))
    return torch.stack([torch.where(b.in_cap, a.reshape(-1)[gidx], 0.0)
                        for a in acc], -1)


def _overflow_residual(b: _Buckets, acc_s, eps_sq, rr: int):
    """Exact residual for bucket overflow (clustered cells), in sorted order,
    in 2D or 3D.

    The bucket pass used only in-cap particles as sources and targets.
    Gather the overflow set O compactly (a fixed cap) and add
      (b) all targets <- O sources, near-cell-masked,
      (c) O targets <- in-cap sources, near-cell-masked.
    O's far field is already exact (the pyramid holds every particle). Two
    tiers: the masked pass costs O(N * cap), so a mild overflow (a few
    clustered cells) takes the 1024-wide tier. The tier is a Python branch
    on `int(overflow)`: one host sync."""
    n = acc_s.shape[0]
    over = int(b.overflow)
    m_cap = min(n, _OVERFLOW_CAP)
    m_small = min(n, _OVERFLOW_SMALL)
    if over == 0:
        return acc_s
    cap_k = m_cap if over > m_small or m_small >= m_cap else m_small
    block = 32768 if acc_s.device.type == "cuda" else 2048
    o_idx = torch.argsort(b.in_cap.to(torch.int32), stable=True)[:cap_k]
    o_valid = ~b.in_cap[o_idx]
    o_pos = b.pos_s[o_idx]
    o_mass = torch.where(o_valid, b.mass_s[o_idx], 0.0)
    o_cell = b.ci_s[o_idx]
    acc_s = acc_s + _near_masked_blocked(
        b.pos_s, b.ci_s, o_pos, o_mass, o_cell, eps_sq, rr, block)
    cap_mass = torch.where(b.in_cap, b.mass_s, 0.0)
    o_acc = _near_masked_blocked(
        o_pos, o_cell, b.pos_s, cap_mass, b.ci_s, eps_sq, rr, block)
    return acc_s.index_add(0, o_idx, torch.where(o_valid[:, None], o_acc, 0.0))


def _near_field_buckets(pos, mass, ci, flat, levels: int, eps_sq, g_const,
                        cap: int, radius: int, use_kernels: bool = False):
    """Particle-particle near field on a dense [r, r, cap] bucket grid
    ([r, r, r, cap] in 3D: the JAX package's `_near_field_buckets` and
    `barneshut3d._near_field_buckets3`), with the exact residual for
    overflowing cells. Particles with a flat id >= r^D (the extracted
    outliers) stay out of the grid; their rows are garbage and the caller
    discards them. Returns (acc [N, D], overflow_count tensor)."""
    res = 1 << levels
    rr = radius - 1
    b = _bucket_grid(pos, mass, ci, flat, res, cap, rr)
    acc = _bucket_stencil_dispatch(b.grid, rr, eps_sq, res, use_kernels)
    acc_s = _overflow_residual(b, _bucket_gather(b, acc, res, cap), eps_sq,
                               rr)
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


def _bh_accelerations(pos, mass, levels: int, eps_sq: float, g_const: float,
                      near_cap: int, radius: int, use_kernels: bool):
    """The tree-code force evaluation (the JAX package's `_bh_accelerations`
    without its deep branch). With use_kernels, the near field is K3 and
    the outlier couplings are K1 (outliers <- all) and K4 (bulk <-
    outliers); on a CPU tensor those wrappers run their plain versions.
    use_kernels=False runs the plain versions on any device."""
    ext, acc_heavy, acc_out, acc_from_out = _exact_couplings(
        pos, mass, eps_sq, g_const, use_kernels)

    tree_mass = ext["tree_mass"]          # the tree sees only the bulk
    grids, corner, size, ci, flat = _build_pyramid(
        ext["bulk_pos"], tree_mass, levels)
    res = 1 << levels

    # Downward pass: M2L at each level + L2L to the next.
    local = None
    for lv in range(2, levels + 1):
        terms = _m2l_level(grids[lv], corner, size, eps_sq, radius)
        if local is None:
            local = terms
        else:
            up = _l2l_upsample(local, size / (1 << lv))
            local = tuple(u + t for u, t in zip(up, terms))

    far = g_const * _l2p_eval(local, ci, pos, corner, size, levels)
    near, _ = _near_field_buckets(
        pos, tree_mass, ci, _outlier_flat_ids(flat, ext["is_out"], res * res),
        levels, eps_sq, g_const, near_cap, radius, use_kernels=use_kernels)
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
    """Bulk particles beyond the 2D near-field bucket cap (see
    `_near_overflow`)."""
    return _near_overflow(pos, mass, _resolve_levels(config, pos.shape[0]))


def _resolve_levels(config: SimConfig, n: int) -> int:
    """Finest grid level: config.bh_levels, or ~4 particles per cell
    (r ~ sqrt(N/4)), clamped to 3..10 (the JAX package's rule)."""
    levels = config.bh_levels
    if levels <= 0:
        levels = max(3, min(10, ((max(n, 16)) - 1).bit_length() - 2 >> 1))
    return levels


_MAX_DEEP_2D = 13


def _resolve_deep_levels(config: SimConfig, levels: int) -> int:
    """Deep-overflow chain depth (0 = off; -1 = auto, levels + 2; capped).
    Any nonzero result needs ROADMAP item 10."""
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


def bh_accelerations(pos: torch.Tensor, mass: torch.Tensor,
                     config: SimConfig, *,
                     use_kernels: Optional[bool] = None) -> torch.Tensor:
    """Approximate softened accelerations via the stencil FMM tree code.

    dim=2 runs this quadtree pyramid; dim=3 dispatches to the octree FMM
    (`physics/barneshut3d.py`), as the JAX package does.
    use_kernels (default: the tensors lie on a CUDA device) routes the
    near field and the outlier couplings to K3 (K7 in 3D), K1 and K4;
    False runs the same tree code through their plain versions (the
    reference on the card). It is an internal switch, not a configuration
    field."""
    if pos.shape[1] == 3:
        from nbodysim_tpu_torch.physics.barneshut3d import bh3_accelerations

        return bh3_accelerations(pos, mass, config, use_kernels=use_kernels)
    n = pos.shape[0]
    levels = _resolve_levels(config, n)
    deep = _resolve_deep_levels(config, levels)
    radius = _resolve_radius(config)
    if deep:
        raise NotImplementedError(
            "the deep-overflow chain and hot-zone tiles (bh_deep_levels != "
            "0) are ROADMAP item 10 and not ported yet")
    if use_kernels is None:
        # The JAX package's `_nf_use_pallas` (Pallas on the TPU).
        use_kernels = pos.device.type == "cuda"
    return _bh_accelerations(
        pos, mass, levels=levels, eps_sq=float(config.eps_sq),
        g_const=float(config.g_const), near_cap=NEAR_CAP, radius=radius,
        use_kernels=use_kernels)
