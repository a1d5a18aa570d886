"""The 3D tree code: the octree FMM (port of
`nbodysim_tpu.physics.barneshut3d`, without its deep-overflow chain).

The quadtree code of `physics/barneshut.py` taken to dim=3; the JAX module's
docstring gives the design and the derivative formulas:

  upward (M2M):  one [N, 10]-payload `index_add_` of the raw moments
                 (m, m r_i, m r_i r_j) into the finest 2^L x 2^L x 2^L grid,
                 2 x 2 x 2 sum-pooling up the pyramid.
  M2L:           per level, the V-list (Chebyshev distance R..2R-1, parity-
                 gated on the outer ring) as ONE parent-level convolution
                 (`_m2l_conv3`, `F.conv3d`, 80 -> 152 channels) into p=2
                 local terms: F [3], J [6 sym], H [10 sym];
                 `_m2l_stencil3` is its plain reference.
  L2L / L2P:     local expansions re-centred down the pyramid, then one
                 [19, N] gather per particle and a second-order Taylor
                 evaluation.
  near field:    the (2R-1)^3 finest-cell neighbourhood particle-particle on
                 a dense bucket grid [r, r, r, K] (`NEAR_CAP` slots): K7
                 (`kernels/nearfield.py`) on the card; cells holding more
                 than K particles spill into the exact near-masked residual.
                 The bucket grid, gather and residual are the 2D module's,
                 generic over dim.
  extraction:    heavy bodies and the most distant outliers leave the tree
                 and get exact forces (outliers <- all through K1, bulk <-
                 outliers through K4), shared with 2D.

Differences from the JAX package, each deliberate:
  * the M2L convolution runs in full f32 at every level, with cuDNN's TF32
    off around the call (the JAX package pins HIGHEST, HIGH from r = 256,
    which the non-deep path never reaches: levels stop at 7);
  * the space-to-depth and its inverse are a reshape and a permute; the
    JAX package's permutation-matrix products, identity contraction and
    per-term interleaves are TPU layout workarounds. The channel order is
    the same: (4a + 2b + d) * 10 + c in, (4c + 2d + e) * 19 + t out;
  * the pyramid pools by reshape-sum (the strided-slice form is a TPU
    tiling workaround);
  * the residual tiers are a Python branch on `int(overflow)`, one host sync
    per evaluation;
  * the deep-overflow chain, hot-zone tiles and the sparse near field
    (`bh_deep_levels != 0`, barneshut3d.py:867-1022, 1041-1491 of the JAX
    package) are ROADMAP Queue A item 1 (3D): asking for them raises
    NotImplementedError, and `forces.resolve_config_for_state` raises where
    the JAX package would switch them on.

Scatter order: `index_add_` on CUDA uses atomics, so the pyramid's sums
differ in the last bits from run to run; tolerances state that as their
reason.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.physics.barneshut import (
    NEAR_CAP, _assemble, _bounding_box, _cell_ids, _exact_couplings,
    _full_f32_conv, _iota, _m2l_conv_taps, _near_field_buckets,
    _near_overflow, _outlier_flat_ids)

_MAX_LEVELS_3D = 7   # 128^3 cells; the JAX package's cap
_MAX_DEEP_3D = 8     # the 3D deep chain's cap (ROADMAP Queue A item 1 (3D))


def _moment_payload3(pos, mass):
    """[N, 10] raw-moment rows: m, m x, m y, m z, m xx, m xy, m xz, m yy,
    m yz, m zz (raw moments pool additively)."""
    px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]
    return torch.stack(
        (mass, mass * px, mass * py, mass * pz,
         mass * px * px, mass * px * py, mass * px * pz,
         mass * py * py, mass * py * pz, mass * pz * pz), -1)


def _build_pyramid3(pos, mass, levels: int):
    """Ten moment grids per level, levels L..0 (fine to coarse), each a
    tuple of [r, r, r] channels, from ONE [N, 10]-payload `index_add_` and
    one 2 x 2 x 2 pooling per level. Returns (grids, corner, size, ci
    [N, 3] int64, flat [N])."""
    corner, size = _bounding_box(pos)
    res = 1 << levels
    ci, flat = _cell_ids(pos, corner, size, res)
    g = torch.zeros((res ** 3, 10), dtype=pos.dtype, device=pos.device)
    g.index_add_(0, flat, _moment_payload3(pos, mass))
    g = g.reshape(res, res, res, 10)
    grids = {levels: tuple(g[..., i] for i in range(10))}
    for lv in range(levels - 1, -1, -1):
        r = 1 << lv
        g = g.reshape(r, 2, r, 2, r, 2, 10).sum((1, 3, 5))
        grids[lv] = tuple(g[..., i] for i in range(10))
    return grids, corner, size, ci, flat


def _m2l_level3(g10, corner, size, eps_sq, radius: int):
    """V-list pass at one full level -> p=2 local terms (19 x [r, r, r]).

    Even grids (every real level) run as the parent-level convolution
    (`_m2l_conv3`); the stencil is the reference and the odd-size path."""
    r = g10[0].shape[0]
    if r % 2 == 0 and r >= 2:
        qh = radius - 1
        gx = F.pad(torch.stack(g10, -1), (0, 0) * 3 + (2 * qh, 2 * qh))
        return _m2l_conv3(gx, corner, size, r, eps_sq, radius, row0=0,
                          rows=r)
    p = 2 * radius - 1
    window = tuple(F.pad(g, (p,) * 6) for g in g10)
    return _m2l_stencil3(window, corner, size, r, eps_sq, radius, row0=0,
                         rows=r)


def _m2l_stencil3(window, corner, size, r_full: int, eps_sq, radius: int,
                  row0: int, rows: int):
    """V-list stencil over an x-window -> p=2 local terms (F, J, H) with the
    quadrupole source moments folded into F.

    `window`: the 10 raw moment grids, [rows + 2p, r_full + 2p, r_full + 2p]
    each (p = 2*radius - 1): the `rows` target x-slabs plus p halo slabs on
    each side and p zero faces in y and z; `row0` is the global x index of
    the first target slab. Offsets are summed in order, as the JAX
    package's scan does."""
    R = radius
    p = 2 * R - 1
    m_w = window[0]
    safe_m = torch.where(m_w > 0, m_w, 1.0)
    com = [window[1 + a] / safe_m for a in range(3)]
    cx_, cy_, cz_ = com
    raw = window[4:10]
    # Quadrupole about the COM (the dipole vanishes by construction).
    q_w = (raw[0] - m_w * cx_ * cx_, raw[1] - m_w * cx_ * cy_,
           raw[2] - m_w * cx_ * cz_, raw[3] - m_w * cy_ * cy_,
           raw[4] - m_w * cy_ * cz_, raw[5] - m_w * cz_ * cz_)

    dtype, device = m_w.dtype, m_w.device
    s_l = size / r_full
    shape = (rows, r_full, r_full)
    ii = _iota(shape, 0, device) + row0
    jj = _iota(shape, 1, device)
    kk = _iota(shape, 2, device)
    cx = corner[0] + (ii.to(dtype) + 0.5) * s_l
    cy = corner[1] + (jj.to(dtype) + 0.5) * s_l
    cz = corner[2] + (kk.to(dtype) + 0.5) * s_l
    parx, pary, parz = ii & 1, jj & 1, kk & 1

    out = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(19)]
    for ox in range(-p, p + 1):
        for oy in range(-p, p + 1):
            for oz in range(-p, p + 1):
                cheb = max(abs(ox), abs(oy), abs(oz))
                if cheb < R:
                    continue

                def sl(a):
                    return a[p + ox:p + ox + rows, p + oy:p + oy + r_full,
                             p + oz:p + oz + r_full]

                ms = sl(m_w)
                sx, sy, sz = sl(cx_), sl(cy_), sl(cz_)
                sq = [sl(q) for q in q_w]
                # Boundary ring (cheb == 2R-1): only when the source's
                # parent lies in the parent's near set (exactly-once
                # coverage).
                pm_ok = ((((ox + parx) >> 1).abs() <= R - 1)
                         & (((oy + pary) >> 1).abs() <= R - 1)
                         & (((oz + parz) >> 1).abs() <= R - 1))
                keep = pm_ok | (cheb < 2 * R - 1)
                ms = torch.where(keep, ms, 0.0)
                sqxx, sqxy, sqxz, sqyy, sqyz, sqzz = (
                    torch.where(keep, s, 0.0) for s in sq)

                dx, dy, dz = sx - cx, sy - cy, sz - cz
                q = dx * dx + dy * dy + dz * dz + eps_sq
                inv = torch.rsqrt(q)
                inv3 = inv * inv * inv
                inv5 = inv3 * inv * inv
                inv7 = inv5 * inv * inv
                w3 = ms * inv3
                w5 = 3.0 * ms * inv5
                u7 = 15.0 * inv7
                u5 = 3.0 * inv5
                # Unit-mass third-derivative tensor components (10).
                txxx = u7 * dx * dx * dx - 3.0 * u5 * dx
                txxy = u7 * dx * dx * dy - u5 * dy
                txxz = u7 * dx * dx * dz - u5 * dz
                txyy = u7 * dx * dy * dy - u5 * dx
                txyz = u7 * dx * dy * dz
                txzz = u7 * dx * dz * dz - u5 * dx
                tyyy = u7 * dy * dy * dy - 3.0 * u5 * dy
                tyyz = u7 * dy * dy * dz - u5 * dz
                tyzz = u7 * dy * dz * dz - u5 * dy
                tzzz = u7 * dz * dz * dz - 3.0 * u5 * dz
                # Quadrupole source term: F_i += 1/2 Q_jk T_ijk.
                fq_x = 0.5 * (sqxx * txxx + sqyy * txyy + sqzz * txzz
                              + 2.0 * (sqxy * txxy + sqxz * txxz
                                       + sqyz * txyz))
                fq_y = 0.5 * (sqxx * txxy + sqyy * tyyy + sqzz * tyzz
                              + 2.0 * (sqxy * txyy + sqxz * txyz
                                       + sqyz * tyyz))
                fq_z = 0.5 * (sqxx * txxz + sqyy * tyyz + sqzz * tzzz
                              + 2.0 * (sqxy * txyz + sqxz * txzz
                                       + sqyz * tyzz))
                terms = (w3 * dx + fq_x, w3 * dy + fq_y, w3 * dz + fq_z,
                         w5 * dx * dx - w3, w5 * dx * dy, w5 * dx * dz,
                         w5 * dy * dy - w3, w5 * dy * dz, w5 * dz * dz - w3,
                         ms * txxx, ms * txxy, ms * txxz, ms * txyy,
                         ms * txyz, ms * txzz, ms * tyyy, ms * tyyz,
                         ms * tyzz, ms * tzzz)
                out = [o + t for o, t in zip(out, terms)]
    return tuple(out)


# ---------------------------------------------------------------------------
# M2L as one convolution at the parent level (see the 2D module): cell-centre
# moments make the V-list translation-invariant, and the space-to-depth view
# makes the parity-gated ring exact with taps at |PO|_inf <= R - 1.
# 10 moment channels (m, d_x, d_y, d_z, Q_xx, Q_xy, Q_xz, Q_yy, Q_yz, Q_zz)
# x 8 children = 80 in, 19 local terms x 8 children = 152 out, (2R-1)^3 taps.
# ---------------------------------------------------------------------------


def _m2l_conv_weights3(radius: int, eps_sq_hat, dtype, device):
    """[(2R-1)^3, 80, 152] tap weights W[PO, f*10+c_in, e*19+t_out].

    Scale-free: offsets in cell units, eps_sq_hat = eps_sq / s_l^2 (a
    tensor: the bounding cube depends on the positions); the caller scales
    outputs by s_l^-(2,3,4) per term class (at physical scale inv9
    underflows f32). Includes the rank-4 couplings (dipole -> H,
    quadrupole -> J)."""
    po, el, fl, offs = _m2l_conv_taps(radius, radius, 3)
    r = torch.as_tensor(offs, device=device).to(dtype)        # [T, 3]
    rx, ry, rz = r[:, 0], r[:, 1], r[:, 2]
    q = rx * rx + ry * ry + rz * rz + eps_sq_hat
    inv = torch.rsqrt(q)
    inv3 = inv * inv * inv
    inv5 = inv3 * inv * inv
    inv7 = inv5 * inv * inv
    inv9 = inv7 * inv * inv

    txxx = 15.0 * rx * rx * rx * inv7 - 9.0 * rx * inv5
    txxy = 15.0 * rx * rx * ry * inv7 - 3.0 * ry * inv5
    txxz = 15.0 * rx * rx * rz * inv7 - 3.0 * rz * inv5
    txyy = 15.0 * rx * ry * ry * inv7 - 3.0 * rx * inv5
    txyz = 15.0 * rx * ry * rz * inv7
    txzz = 15.0 * rx * rz * rz * inv7 - 3.0 * rx * inv5
    tyyy = 15.0 * ry * ry * ry * inv7 - 9.0 * ry * inv5
    tyyz = 15.0 * ry * ry * rz * inv7 - 3.0 * rz * inv5
    tyzz = 15.0 * ry * rz * rz * inv7 - 3.0 * ry * inv5
    tzzz = 15.0 * rz * rz * rz * inv7 - 9.0 * rz * inv5

    # Rank-4 derivative tensor U_ijkl = dT_ijk/dr_l (15 unique).
    x2, y2, z2 = rx * rx, ry * ry, rz * rz

    def u_aaaa(a2):
        return -105.0 * a2 * a2 * inv9 + 90.0 * a2 * inv7 - 9.0 * inv5

    def u_aaab(ra, rb, a2):
        return -105.0 * a2 * ra * rb * inv9 + 45.0 * ra * rb * inv7

    def u_aabb(a2, b2):
        return -105.0 * a2 * b2 * inv9 + 15.0 * (a2 + b2) * inv7 - 3.0 * inv5

    def u_aabc(a2, rb, rc):
        return -105.0 * a2 * rb * rc * inv9 + 15.0 * rb * rc * inv7

    uxxxx, uyyyy, uzzzz = u_aaaa(x2), u_aaaa(y2), u_aaaa(z2)
    uxxxy, uxxxz = u_aaab(rx, ry, x2), u_aaab(rx, rz, x2)
    uxyyy, uyyyz = u_aaab(ry, rx, y2), u_aaab(ry, rz, y2)
    uxzzz, uyzzz = u_aaab(rz, rx, z2), u_aaab(rz, ry, z2)
    uxxyy, uxxzz, uyyzz = u_aabb(x2, y2), u_aabb(x2, z2), u_aabb(y2, z2)
    uxxyz = u_aabc(x2, ry, rz)
    uxyyz = u_aabc(y2, rx, rz)
    uxyzz = u_aabc(z2, rx, ry)

    def row(f3, j6, h10):
        return torch.stack(tuple(f3) + tuple(j6) + tuple(h10), -1)

    # monopole: F = inv3 r_i; J = 3 r_i r_j inv5 - delta inv3; H = T.
    row_m = row(
        (inv3 * rx, inv3 * ry, inv3 * rz),
        (3.0 * rx * rx * inv5 - inv3, 3.0 * rx * ry * inv5,
         3.0 * rx * rz * inv5, 3.0 * ry * ry * inv5 - inv3,
         3.0 * ry * rz * inv5, 3.0 * rz * rz * inv5 - inv3),
        (txxx, txxy, txxz, txyy, txyz, txzz, tyyy, tyyz, tyzz, tzzz))
    # dipole d_a: F_i = delta_ia inv3 - 3 r_i r_a inv5; J_ij = -T_ija;
    # H_ijk = +U_ijka.
    row_dx = row(
        (inv3 - 3.0 * rx * rx * inv5, -3.0 * ry * rx * inv5,
         -3.0 * rz * rx * inv5),
        (-txxx, -txxy, -txxz, -txyy, -txyz, -txzz),
        (uxxxx, uxxxy, uxxxz, uxxyy, uxxyz, uxxzz,
         uxyyy, uxyyz, uxyzz, uxzzz))
    row_dy = row(
        (-3.0 * rx * ry * inv5, inv3 - 3.0 * ry * ry * inv5,
         -3.0 * rz * ry * inv5),
        (-txxy, -txyy, -txyz, -tyyy, -tyyz, -tyzz),
        (uxxxy, uxxyy, uxxyz, uxyyy, uxyyz, uxyzz,
         uyyyy, uyyyz, uyyzz, uyzzz))
    row_dz = row(
        (-3.0 * rx * rz * inv5, -3.0 * ry * rz * inv5,
         inv3 - 3.0 * rz * rz * inv5),
        (-txxz, -txyz, -txzz, -tyyz, -tyzz, -tzzz),
        (uxxxz, uxxyz, uxxzz, uxyyz, uxyzz, uxzzz,
         uyyyz, uyyzz, uyzzz, uzzzz))
    # quadrupole Q_ab (stored once per symmetric pair, mult folds the
    # off-diagonal double count): F_i = mult/2 T_iab; J_ij = -mult/2 U_ijab.
    zeros10 = (torch.zeros_like(rx),) * 10

    def qrow(mult, t3, u6):
        h = 0.5 * mult
        return row((h * t3[0], h * t3[1], h * t3[2]),
                   tuple(-h * u for u in u6), zeros10)

    row_qxx = qrow(1.0, (txxx, txxy, txxz),
                   (uxxxx, uxxxy, uxxxz, uxxyy, uxxyz, uxxzz))
    row_qxy = qrow(2.0, (txxy, txyy, txyz),
                   (uxxxy, uxxyy, uxxyz, uxyyy, uxyyz, uxyzz))
    row_qxz = qrow(2.0, (txxz, txyz, txzz),
                   (uxxxz, uxxyz, uxxzz, uxyyz, uxyzz, uxzzz))
    row_qyy = qrow(1.0, (txyy, tyyy, tyyz),
                   (uxxyy, uxyyy, uxyyz, uyyyy, uyyyz, uyyzz))
    row_qyz = qrow(2.0, (txyz, tyyz, tyzz),
                   (uxxyz, uxyyz, uxyzz, uyyyz, uyyzz, uyzzz))
    row_qzz = qrow(1.0, (txzz, tyzz, tzzz),
                   (uxxzz, uxyzz, uxzzz, uyyzz, uyzzz, uzzzz))

    B = torch.stack((row_m, row_dx, row_dy, row_dz, row_qxx, row_qxy,
                     row_qxz, row_qyy, row_qyz, row_qzz), 1)  # [T, 10, 19]
    k3 = (2 * radius - 1) ** 3
    ci = fl[:, None, None] * 10 + np.arange(10)[None, :, None]
    ti = el[:, None, None] * 19 + np.arange(19)[None, None, :]
    pb = np.broadcast_to(po[:, None, None], ci.shape)

    def idx(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64,
                               device=device).expand(B.shape)

    W = torch.zeros((k3, 80, 152), dtype=dtype, device=device)
    W[idx(pb), idx(ci), idx(ti)] = B
    return W


def _center_channels3(g10, corner, size, r_full: int, x0: int):
    """Raw origin moments [X, r, r, 10] -> moments about each cell's own
    centre in CELL UNITS: (m, d_i / s_l, Q_ij / s_l^2). x0 = global x
    index of slab 0."""
    dtype, device = g10.dtype, g10.device
    s_l = size / r_full
    inv_s = 1.0 / s_l
    shape = g10.shape[:3]
    cx = corner[0] + (_iota(shape, 0, device) + x0).to(dtype) * s_l \
        + 0.5 * s_l
    cy = corner[1] + _iota(shape, 1, device).to(dtype) * s_l + 0.5 * s_l
    cz = corner[2] + _iota(shape, 2, device).to(dtype) * s_l + 0.5 * s_l
    m = g10[..., 0]
    sx, sy, sz = g10[..., 1], g10[..., 2], g10[..., 3]
    inv2 = inv_s * inv_s
    return torch.stack(
        (m,
         (sx - m * cx) * inv_s,
         (sy - m * cy) * inv_s,
         (sz - m * cz) * inv_s,
         (g10[..., 4] - 2.0 * cx * sx + m * cx * cx) * inv2,
         (g10[..., 5] - cx * sy - cy * sx + m * cx * cy) * inv2,
         (g10[..., 6] - cx * sz - cz * sx + m * cx * cz) * inv2,
         (g10[..., 7] - 2.0 * cy * sy + m * cy * cy) * inv2,
         (g10[..., 8] - cy * sz - cz * sy + m * cy * cz) * inv2,
         (g10[..., 9] - 2.0 * cz * sz + m * cz * cz) * inv2), -1)


def _m2l_conv3(gx, corner, size, r_full: int, eps_sq, radius: int,
               row0: int, rows: int):
    """One 3D M2L level as the parent-level convolution.

    gx: [rows + 4(R-1), r_full, r_full, 10] raw-moment x-window whose first
    and last 2(R-1) slabs are halo (zeros beyond the grid); its slab 0 is
    global x index row0 - 2(R-1). row0 and rows must be even. Returns the
    19 local terms, [rows, r_full, r_full] each.

    XLA's NDHWC/DHWIO `conv_general_dilated` becomes `F.conv3d` on
    NCDHW/OIDHW; both are cross-correlations, so the taps need no flip. It
    runs in full f32 (`_full_f32_conv`)."""
    qh = radius - 1
    h = r_full // 2
    hb = rows // 2
    ch = _center_channels3(gx, corner, size, r_full, row0 - 2 * qh)
    X = rows + 4 * qh
    # Space-to-depth: channel (4a + 2b + d) * 10 + c of parent cell
    # (i, j, k) is channel c of child (2i + a, 2j + b, 2k + d), the child
    # enumeration of `_m2l_conv_taps`.
    m8 = (ch.reshape(X // 2, 2, h, 2, h, 2, 10)
          .permute(0, 2, 4, 1, 3, 5, 6)
          .reshape(X // 2, h, h, 80))
    m8 = F.pad(m8, (0, 0, qh, qh, qh, qh))      # [X/2, h + 2qh, h + 2qh, 80]
    s_l = size / r_full
    W = _m2l_conv_weights3(radius, eps_sq / (s_l * s_l), gx.dtype, gx.device)
    k = 2 * radius - 1
    weight = W.reshape(k, k, k, 80, 152).permute(4, 3, 0, 1, 2).contiguous()
    with _full_f32_conv():
        out = F.conv3d(m8.permute(3, 0, 1, 2)[None].contiguous(), weight)[0]
    inv_s = 1.0 / s_l
    s2 = inv_s * inv_s
    # F, J, H scale as s_l^-(2, 3, 4).
    scales = torch.stack((s2,) * 3 + (s2 * inv_s,) * 6 + (s2 * s2,) * 10)
    # Channel (4c + 2d + e) * 19 + t of parent cell (i, j, k) is term t of
    # child (2i + c, 2j + d, 2k + e): de-space-to-depth to [19, rows, r, r].
    terms = (out.reshape(2, 2, 2, 19, hb, h, h)
             .permute(3, 4, 0, 5, 1, 6, 2)
             .reshape(19, rows, r_full, r_full)) * scales[:, None, None, None]
    return tuple(terms)


def _taylor_eval3(local19, ex, ey, ez):
    """Second-order Taylor of (F, J) at offset (ex, ey, ez). Shared by L2L
    (child-centre offsets) and L2P (particle offsets). Returns the 19 terms
    re-centred (H unchanged)."""
    (fx, fy, fz, jxx, jxy, jxz, jyy, jyz, jzz,
     hxxx, hxxy, hxxz, hxyy, hxyz, hxzz, hyyy, hyyz, hyzz, hzzz) = local19
    fxc = (fx + jxx * ex + jxy * ey + jxz * ez
           + 0.5 * (hxxx * ex * ex + hxyy * ey * ey + hxzz * ez * ez)
           + hxxy * ex * ey + hxxz * ex * ez + hxyz * ey * ez)
    fyc = (fy + jxy * ex + jyy * ey + jyz * ez
           + 0.5 * (hxxy * ex * ex + hyyy * ey * ey + hyzz * ez * ez)
           + hxyy * ex * ey + hxyz * ex * ez + hyyz * ey * ez)
    fzc = (fz + jxz * ex + jyz * ey + jzz * ez
           + 0.5 * (hxxz * ex * ex + hyyz * ey * ey + hzzz * ez * ez)
           + hxyz * ex * ey + hxzz * ex * ez + hyzz * ey * ez)
    jxxc = jxx + hxxx * ex + hxxy * ey + hxxz * ez
    jxyc = jxy + hxxy * ex + hxyy * ey + hxyz * ez
    jxzc = jxz + hxxz * ex + hxyz * ey + hxzz * ez
    jyyc = jyy + hxyy * ex + hyyy * ey + hyyz * ez
    jyzc = jyz + hxyz * ex + hyyz * ey + hyzz * ez
    jzzc = jzz + hxzz * ex + hyzz * ey + hzzz * ez
    return (fxc, fyc, fzc, jxxc, jxyc, jxzc, jyyc, jyzc, jzzc,
            hxxx, hxxy, hxxz, hxyy, hxyz, hxzz, hyyy, hyyz, hyzz, hzzz)


def _l2l_upsample3(local19, s_child):
    """Shift parent local expansions to the 8 child centres and upsample."""

    def up(a):
        return (a.repeat_interleave(2, 0).repeat_interleave(2, 1)
                .repeat_interleave(2, 2))

    ref = local19[0]
    shape2 = tuple(2 * s for s in ref.shape)
    ex, ey, ez = (((_iota(shape2, a, ref.device) & 1).to(ref.dtype) - 0.5)
                  * s_child for a in range(3))
    return _taylor_eval3(tuple(up(a) for a in local19), ex, ey, ez)


def _l2p_eval3(local, ci, pos, corner, size, level: int):
    """Second-order L2P at each particle, one fused [19, N] gather.
    Returns [N, 3], unscaled by g_const."""
    res = 1 << level
    s_l = size / res
    cent = corner + (ci.to(pos.dtype) + 0.5) * s_l
    d = pos - cent
    loc19 = torch.stack(local, 0).reshape(19, res ** 3)
    g = loc19[:, (ci[:, 0] * res + ci[:, 1]) * res + ci[:, 2]]   # [19, N]
    ev = _taylor_eval3(tuple(g[i] for i in range(19)), d[:, 0], d[:, 1],
                       d[:, 2])
    return torch.stack(ev[:3], -1)


def _bh3_accelerations(pos, mass, levels: int, eps_sq: float,
                       g_const: float, near_cap: int, radius: int,
                       use_kernels: bool):
    """The octree force evaluation (the JAX package's `_bh3_accelerations`
    without its deep and sparse-near-field branches). With use_kernels, the
    near field is K7 and the outlier couplings are K1 (outliers <- all) and
    K4 (bulk <- outliers); on a CPU tensor those wrappers run their plain
    versions. use_kernels=False runs the plain versions on any device."""
    ext, acc_heavy, acc_out, acc_from_out = _exact_couplings(
        pos, mass, eps_sq, g_const, use_kernels)

    tree_mass = ext["tree_mass"]          # the tree sees only the bulk
    grids, corner, size, ci, flat = _build_pyramid3(
        ext["bulk_pos"], tree_mass, levels)
    res = 1 << levels

    # Downward pass: M2L at each level + L2L to the next.
    local = None
    for lv in range(2, levels + 1):
        terms = _m2l_level3(grids[lv], corner, size, eps_sq, radius)
        if local is None:
            local = terms
        else:
            up = _l2l_upsample3(local, size / (1 << lv))
            local = tuple(u + t for u, t in zip(up, terms))

    far = g_const * _l2p_eval3(local, ci, pos, corner, size, levels)
    near, _ = _near_field_buckets(
        pos, tree_mass, ci, _outlier_flat_ids(flat, ext["is_out"], res ** 3),
        levels, eps_sq, g_const, near_cap, radius, use_kernels=use_kernels)
    return _assemble(ext, far, near, acc_heavy, acc_out, acc_from_out)


def _resolve_levels3(config: SimConfig, n: int) -> int:
    """Finest octree level: config.bh_levels, or 1-8 particles per cell
    (8^L <= N, the JAX package's rule), clamped to 2..7."""
    levels = config.bh_levels
    if levels <= 0:
        levels = max(2, min(_MAX_LEVELS_3D,
                            (max(n, 8).bit_length() - 1) // 3))
    return min(levels, _MAX_LEVELS_3D)


def _resolve_radius3(config: SimConfig) -> int:
    """3D acceptance radius; unlike 2D (floored at R=3) the octree defaults
    to R=2 (the V-list has (4R-1)^3 - (2R-1)^3 offsets, so R=3 costs ~4x);
    clamped to 2..5."""
    r = config.bh_accept_radius
    if r <= 0:
        r = max(2, int(round(1.0 + 1.0 / max(config.theta, 0.25))) - 1)
    return max(2, min(5, r))


def _resolve_deep_levels3(config: SimConfig, levels: int) -> int:
    """3D deep-overflow chain depth (0 = off; -1 = auto, levels + 2;
    capped). Any nonzero result needs ROADMAP Queue A item 1 (3D)."""
    d = config.bh_deep_levels
    if d == 0:
        return 0
    if d < 0:
        d = levels + 2
    return max(levels + 1, min(d, _MAX_DEEP_3D)) if d > levels else 0


def bh3_accelerations(pos: torch.Tensor, mass: torch.Tensor,
                      config: SimConfig, *,
                      use_kernels: Optional[bool] = None) -> torch.Tensor:
    """Approximate softened accelerations via the 3D octree FMM.

    use_kernels (default: the tensors lie on a CUDA device) routes the
    near field and the outlier couplings to K7, K1 and K4; False runs the
    same tree code through their plain versions (the reference on the
    card)."""
    if pos.shape[1] != 3:
        raise ValueError("bh3_accelerations is the dim=3 tree code")
    levels = _resolve_levels3(config, pos.shape[0])
    if _resolve_deep_levels3(config, levels):
        raise NotImplementedError(
            "the 3D deep-overflow chain, hot-zone tiles and sparse near "
            "field (bh_deep_levels != 0) are ROADMAP Queue A item 1 (3D) "
            "and not ported yet")
    if use_kernels is None:
        use_kernels = pos.device.type == "cuda"
    return _bh3_accelerations(
        pos, mass, levels=levels, eps_sq=float(config.eps_sq),
        g_const=float(config.g_const), near_cap=NEAR_CAP,
        radius=_resolve_radius3(config), use_kernels=use_kernels)


def bh3_near_overflow(pos: torch.Tensor, mass: torch.Tensor,
                      config: SimConfig) -> int:
    """Bulk particles beyond the 3D near-field bucket cap, after the same
    heavy/outlier extraction the force path applies (no forces)."""
    return _near_overflow(pos, mass, _resolve_levels3(config, pos.shape[0]))
