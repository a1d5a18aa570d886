"""The 3D tree code: the octree FMM (port of
`nbodysim_tpu.physics.barneshut3d`).

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
  deep chain:    with `bh_deep_levels != 0` (switched on by
                 `forces.resolve_config_for_state` where the buckets overflow
                 past the residual's cap) the synthesized pyramid and the
                 downward pass continue past the bucket level; targets near
                 an overflowing cell take the deep level's local expansion
                 plus smoothed 3 x 3 x 3 cell aggregates, and inside the T
                 hottest tiles the chain continues k sub-levels finer
                 (`_tile_refine3`). It skips the residual. With
                 `bh_nf_sparse=1` the few bucket-tier targets get an exact
                 cell-masked pass instead of the dense bucket grid
                 (`_sparse_near_field3`).

Differences from the JAX package, each deliberate:
  * the M2L convolution runs in full f32 at every level, with cuDNN's TF32
    off around the call (the JAX package pins HIGHEST, and HIGH, bf16x3,
    from r = 256: the deep chain's 256^3 level);
  * the space-to-depth and its inverse are a reshape and a permute; the
    JAX package's permutation-matrix products, identity contraction and
    per-term interleaves are TPU layout workarounds. The channel order is
    the same: (4a + 2b + d) * 10 + c in, (4c + 2d + e) * 19 + t out;
  * the pyramid pools by reshape-sum (the strided-slice form is a TPU
    tiling workaround), except the synthesized (deep-mode) grids, which
    pool in the JAX package's order (`_pool2x3`, and `_pool_seq3` for the
    tiles): their quadrupoles are sx^2/m at absolute coordinates, centred
    by subtracting ~m c^2, so the pooled sums' last bits matter;
  * the residual tiers, the deep chain's row compactions and the sparse
    near field's source compaction are Python branches on a count read from
    the device (one host sync each), where the JAX package uses `lax.cond`;
    the sparse pass runs on its valid target rows and compacted sources
    only, where the JAX package pads both to static caps;
  * the per-tile chain runs the T tiles as one batch where the JAX package
    vmaps; the deep aggregates are always the per-offset gathers
    (`_aggregate_window_eval3`): the JAX package's packed variants sum the
    same terms in the same order for the TPU's gather row rate.

Scatter order: `index_add_` on CUDA uses atomics, so the pyramid's sums
differ in the last bits from run to run; tolerances state that as their
reason.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.physics.barneshut import (
    _DEEP_SMOOTH, NEAR_CAP, _assemble, _bounding_box, _cell_ids,
    _compact_indices, _exact_couplings, _extract_heavy_outliers,
    _full_f32_conv, _halo_cap, _iota, _m2l_conv_taps, _near_field_buckets,
    _near_masked_blocked, _near_overflow, _outlier_flat_ids, _scatter_rows)

_MAX_LEVELS_3D = 7   # 128^3 cells; the JAX package's cap
_MAX_DEEP_3D = 8     # a 256^3 deep grid: 671 MB for its 10 moment channels


def _moment_payload3(pos, mass):
    """[N, 10] raw-moment rows: m, m x, m y, m z, m xx, m xy, m xz, m yy,
    m yz, m zz (raw moments pool additively)."""
    px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]
    return torch.stack(
        (mass, mass * px, mass * py, mass * pz,
         mass * px * px, mass * px * py, mass * px * pz,
         mass * py * py, mass * py * pz, mass * pz * pz), -1)


def _synth_quad_channels3(g4):
    """(m, sx, sy, sz) [..., 4] -> 10 raw-moment channels [..., 10] with
    point-at-COM quadrupoles (rxx = sx^2/m, ...; exact for single-particle
    cells): the deep mode's finest grid and the tiles' grids. The JAX
    package's per-channel `_synth_quad_tuple3` is the same arithmetic on a
    TPU-friendly layout."""
    m, sx, sy, sz = (g4[..., i] for i in range(4))
    inv = torch.where(m > 0, 1.0 / torch.where(m > 0, m, 1.0), 0.0)
    return torch.stack((m, sx, sy, sz, sx * sx * inv, sx * sy * inv,
                        sx * sz * inv, sy * sy * inv, sy * sz * inv,
                        sz * sz * inv), -1)


def _pool2x3(g):
    """2 x 2 x 2 sum-pool of [..., 2r, 2r, 2r, C] grids in the JAX package's
    `_pool2x3` order: x pairs, then y pairs, then z pairs. Used for the
    synthesized pyramid, whose quadrupoles (sx^2/m at absolute coordinates)
    `_center_channels3` centres by subtracting ~m c^2: the pooled sums'
    last bits then reach the deep local terms, so the order must be the
    reference's."""
    g = g[..., 0::2, :, :, :] + g[..., 1::2, :, :, :]
    g = g[..., :, 0::2, :, :] + g[..., :, 1::2, :, :]
    return g[..., :, :, 0::2, :] + g[..., :, :, 1::2, :]


def _pool_seq3(g):
    """2 x 2 x 2 sum-pool of [..., 2r, 2r, 2r, C] grids adding the 8
    children one by one in (x, y, z) row-major order: XLA's CPU order for
    the JAX package's reshape-sum of the tile grids (`_tile_chain3`)."""
    r = g.shape[-2] // 2
    a = g.reshape(g.shape[:-4] + (r, 2, r, 2, r, 2, g.shape[-1]))
    out = a[..., :, 0, :, 0, :, 0, :]
    for c in range(1, 8):
        out = out + a[..., :, c >> 2, :, (c >> 1) & 1, :, c & 1, :]
    return out


def _build_pyramid3(pos, mass, levels: int, synth_quad: bool = False):
    """Ten moment grids per level, levels L..0 (fine to coarse), each a
    tuple of [r, r, r] channels, from ONE [N, 10]-payload `index_add_` and
    one 2 x 2 x 2 pooling per level.

    synth_quad=True scatters only (m, sx, sy, sz), synthesizes the
    quadrupole channels as point-at-COM raw moments (the JAX package's deep
    mode) and pools in `_pool2x3`'s order. Returns (grids, corner, size, ci
    [N, 3] int64, flat [N])."""
    corner, size = _bounding_box(pos)
    res = 1 << levels
    ci, flat = _cell_ids(pos, corner, size, res)
    payload = _moment_payload3(pos, mass)
    c = 4 if synth_quad else 10
    g = torch.zeros((res ** 3, c), dtype=pos.dtype, device=pos.device)
    g.index_add_(0, flat, payload[:, :c])
    g = g.reshape(res, res, res, c)
    if synth_quad:
        g = _synth_quad_channels3(g)
    grids = {levels: tuple(g[..., i] for i in range(10))}
    for lv in range(levels - 1, -1, -1):
        r = 1 << lv
        g = (_pool2x3(g) if synth_quad
             else g.reshape(r, 2, r, 2, r, 2, 10).sum((1, 3, 5)))
        grids[lv] = tuple(g[..., i] for i in range(10))
    return grids, corner, size, ci, flat


def _m2l_level3(g10, corner, size, eps_sq, radius: int):
    """V-list pass at one full level -> p=2 local terms (19 x [r, r, r]).

    Even grids (every real level) run as the parent-level convolution
    (`_m2l_conv3`); the stencil is the reference and the odd-size path.
    Even grids may carry leading batch axes (the deep chain's tiles), with
    one corner per grid."""
    r = g10[0].shape[-1]
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
                  row0: int, rows: int, offsets=None, gate_parity: bool = True,
                  pad: Optional[int] = None):
    """V-list stencil over an x-window -> p=2 local terms (F, J, H) with the
    quadrupole source moments folded into F.

    `window`: the 10 raw moment grids, [rows + 2p, r_full + 2p, r_full + 2p]
    each (p = 2*radius - 1, or `pad`): the `rows` target x-slabs plus p halo
    slabs on each side and p zero faces in y and z; `row0` is the global x
    index of the first target slab. `offsets`/`gate_parity`/`pad`
    generalize it beyond the V-list (the deep chain's ring fold). Offsets
    are summed in order, as the JAX package's scan does. The grids may carry
    leading batch axes, with `corner` [..., 3] one corner per grid."""
    R = radius
    p = 2 * R - 1 if pad is None else pad
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
    cx = corner[..., 0, None, None, None] + (ii.to(dtype) + 0.5) * s_l
    cy = corner[..., 1, None, None, None] + (jj.to(dtype) + 0.5) * s_l
    cz = corner[..., 2, None, None, None] + (kk.to(dtype) + 0.5) * s_l
    parx, pary, parz = ii & 1, jj & 1, kk & 1

    if offsets is None:
        offsets = [(ox, oy, oz)
                   for ox in range(-p, p + 1)
                   for oy in range(-p, p + 1)
                   for oz in range(-p, p + 1)
                   if max(abs(ox), abs(oy), abs(oz)) >= R]
    out = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(19)]
    for ox, oy, oz in offsets:
        def sl(a):
            return a[..., p + ox:p + ox + rows, p + oy:p + oy + r_full,
                     p + oz:p + oz + r_full]

        ms = sl(m_w)
        sx, sy, sz = sl(cx_), sl(cy_), sl(cz_)
        sq = [sl(q) for q in q_w]
        if gate_parity:
            # Boundary ring (cheb == 2R-1): only when the source's parent
            # lies in the parent's near set (exactly-once coverage).
            cheb = max(abs(ox), abs(oy), abs(oz))
            pm_ok = ((((ox + parx) >> 1).abs() <= R - 1)
                     & (((oy + pary) >> 1).abs() <= R - 1)
                     & (((oz + parz) >> 1).abs() <= R - 1))
            keep = pm_ok | (cheb < 2 * R - 1)
            ms = torch.where(keep, ms, 0.0)
            sq = [torch.where(keep, s, 0.0) for s in sq]
        sqxx, sqxy, sqxz, sqyy, sqyz, sqzz = sq

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
    """Raw origin moments [..., X, r, r, 10] -> moments about each cell's own
    centre in CELL UNITS: (m, d_i / s_l, Q_ij / s_l^2). x0 = global x
    index of slab 0; `corner` [..., 3] holds one corner per leading index."""
    dtype, device = g10.dtype, g10.device
    s_l = size / r_full
    inv_s = 1.0 / s_l
    shape = g10.shape[-4:-1]
    cx = corner[..., 0, None, None, None] \
        + (_iota(shape, 0, device) + x0).to(dtype) * s_l + 0.5 * s_l
    cy = corner[..., 1, None, None, None] \
        + _iota(shape, 1, device).to(dtype) * s_l + 0.5 * s_l
    cz = corner[..., 2, None, None, None] \
        + _iota(shape, 2, device).to(dtype) * s_l + 0.5 * s_l
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

    gx: [..., rows + 4(R-1), r_full, r_full, 10] raw-moment x-window whose
    first and last 2(R-1) slabs are halo (zeros beyond the grid); its slab
    0 is global x index row0 - 2(R-1). row0 and rows must be even. Leading
    axes are a batch of grids (`corner` [..., 3], one corner each) run as
    one convolution batch. Returns the 19 local terms, [..., rows, r_full,
    r_full] each.

    XLA's NDHWC/DHWIO `conv_general_dilated` becomes `F.conv3d` on
    NCDHW/OIDHW; both are cross-correlations, so the taps need no flip. It
    runs in full f32 (`_full_f32_conv`) at every level, the deep chain's
    256^3 included."""
    qh = radius - 1
    h = r_full // 2
    hb = rows // 2
    lead = gx.shape[:-4]
    ch = _center_channels3(gx, corner, size, r_full, row0 - 2 * qh)
    X = rows + 4 * qh
    # Space-to-depth: channel (4a + 2b + d) * 10 + c of parent cell
    # (i, j, k) is channel c of child (2i + a, 2j + b, 2k + d), the child
    # enumeration of `_m2l_conv_taps`; laid out channel-first for conv3d.
    m8 = (ch.reshape(-1, X // 2, 2, h, 2, h, 2, 10)
          .permute(0, 2, 4, 6, 7, 1, 3, 5)
          .reshape(-1, 80, X // 2, h, h))
    m8 = F.pad(m8, (qh, qh, qh, qh))      # [B, 80, X/2, h + 2qh, h + 2qh]
    s_l = size / r_full
    W = _m2l_conv_weights3(radius, eps_sq / (s_l * s_l), gx.dtype, gx.device)
    k = 2 * radius - 1
    weight = W.reshape(k, k, k, 80, 152).permute(4, 3, 0, 1, 2).contiguous()
    with _full_f32_conv():
        out = F.conv3d(m8.contiguous(), weight)      # [B, 152, hb, h, h]
    inv_s = 1.0 / s_l
    s2 = inv_s * inv_s
    # F, J, H scale as s_l^-(2, 3, 4).
    scales = torch.stack((s2,) * 3 + (s2 * inv_s,) * 6 + (s2 * s2,) * 10)
    # Channel (4c + 2d + e) * 19 + t of parent cell (i, j, k) is term t of
    # child (2i + c, 2j + d, 2k + e): de-space-to-depth to
    # [19, B, rows, r, r].
    terms = (out.reshape(-1, 2, 2, 2, 19, hb, h, h)
             .permute(4, 0, 5, 1, 6, 2, 7, 3)
             .reshape((19,) + lead + (rows, r_full, r_full)))
    return tuple(terms[t] * scales[t] for t in range(19))


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
    """Shift parent local expansions to the 8 child centres and upsample
    (the last three axes; leading axes are a batch of grids)."""

    def up(a):
        return (a.repeat_interleave(2, -3).repeat_interleave(2, -2)
                .repeat_interleave(2, -1))

    ref = local19[0]
    shape2 = tuple(2 * s for s in ref.shape[-3:])
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


# ---------------------------------------------------------------------------
# The deep-overflow chain, its hot-zone tiles and the sparse near field (the
# JAX package's barneshut3d.py:867-1496). Names and signatures are the JAX
# package's, so the banded multi-GPU octree can call the tile stages on
# their own.
# ---------------------------------------------------------------------------

_NF_SPARSE_CAP = 16384   # bucket-tier target capacity of the sparse near
                         # field; targets beyond it promote to the deep path


def _nf_sparse_cap(n: int) -> int:
    return min(n, _NF_SPARSE_CAP)


def _nf_sparse_src_cap(n: int) -> int:
    """Source capacity of the sparse near field's compaction (the residents
    of cells that are not hot); past it the pass takes all N sources."""
    return min(n, 8 * _NF_SPARSE_CAP)


def _deep_rows_cap3(n: int) -> int:
    """Row capacity of the compacted deep L2P + aggregate pass when tiles
    are on (the rows the tiles do not refine)."""
    return max((3 * n) // 4, 4096)


def _refined_cap3(n: int) -> int:
    """Row capacity of the compacted tile apply (the refined targets)."""
    return max((5 * n) // 8, 4096)


def _scatter_cap3(n: int) -> int:
    """Row capacity of the compacted tile-scatter sources (the selected
    tiles' members and their selected-adjacent edge bands)."""
    return max((5 * n) // 8, 4096)


def _deep_targets3(flat_nf, flat, is_out, res: int, near_cap: int,
                   radius: int):
    """(b_par [N], hot [res^3]): the deep path's targets, the bulk rows
    whose bucket stencil window (Chebyshev radius - 1) holds an overflowing
    cell, and the overflowing (hot) cells. Outliers never take the deep
    path (and must not inflate the tile scores)."""
    n_cells = res ** 3
    occ = torch.zeros(n_cells + 1, dtype=torch.int32, device=flat.device)
    occ.index_add_(0, torch.clamp(flat_nf, max=n_cells),
                   torch.ones_like(flat_nf, dtype=torch.int32))
    hot = occ[:n_cells] > near_cap
    rr = radius - 1
    bmask = F.max_pool3d(hot.to(torch.float32).reshape(1, 1, res, res, res),
                         2 * rr + 1, stride=1, padding=rr)[0, 0] > 0
    return bmask.reshape(-1)[flat] & ~is_out, hot


def _aggregate_window_eval3(gp_flat, base, side, payload, pos, eps_sq,
                            rr: int):
    """(2rr+1)^3 smoothed cell-aggregate kick, shared by the full-grid deep
    path and the tile path. gp_flat: [M, 10] flattened padded raw-moment
    cells (monopole at the COM plus quadrupole), or [M, 4] (m, sx, sy, sz)
    rows, each cell then a monopole at its COM. base: [N] flat index of
    each particle's home cell in that layout; side: the padded y/z side (x
    stride side^2); payload (the particle's own row, subtracted from its
    home cell) has gp_flat's channels. eps_sq arrives already widened by
    the Plummer-cloud term. Offsets summed in (ox, oy, oz) order. Returns
    [N, 3], unscaled by g_const."""
    mono = gp_flat.shape[1] == 4
    px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]
    ax = torch.zeros_like(px)
    ay = torch.zeros_like(py)
    az = torch.zeros_like(pz)
    for ox in range(-rr, rr + 1):
        for oy in range(-rr, rr + 1):
            for oz in range(-rr, rr + 1):
                ch = gp_flat[base + ((ox * side + oy) * side + oz)]
                if ox == 0 and oy == 0 and oz == 0:
                    ch = ch - payload
                m = ch[:, 0]
                safe_m = torch.where(m > 0, m, 1.0)
                cx = ch[:, 1] / safe_m
                cy = ch[:, 2] / safe_m
                cz = ch[:, 3] / safe_m
                dx = cx - px
                dy = cy - py
                dz = cz - pz
                q = dx * dx + dy * dy + dz * dz + eps_sq
                inv = torch.rsqrt(q)
                inv3 = inv * inv * inv
                w3 = m * inv3
                ax = ax + w3 * dx
                ay = ay + w3 * dy
                az = az + w3 * dz
                if mono:
                    continue
                qxx = ch[:, 4] - m * cx * cx
                qxy = ch[:, 5] - m * cx * cy
                qxz = ch[:, 6] - m * cx * cz
                qyy = ch[:, 7] - m * cy * cy
                qyz = ch[:, 8] - m * cy * cz
                qzz = ch[:, 9] - m * cz * cz
                inv5 = inv3 * inv * inv
                inv7 = inv5 * inv * inv
                u7 = 15.0 * inv7
                u5 = 3.0 * inv5
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
                ax = ax + 0.5 * (
                    qxx * txxx + qyy * txyy + qzz * txzz
                    + 2.0 * (qxy * txxy + qxz * txxz + qyz * txyz))
                ay = ay + 0.5 * (
                    qxx * txxy + qyy * tyyy + qzz * tyzz
                    + 2.0 * (qxy * txyy + qxz * txyz + qyz * tyyz))
                az = az + 0.5 * (
                    qxx * txxz + qyy * tyyz + qzz * tzzz
                    + 2.0 * (qxy * txyz + qxz * txzz + qyz * tyzz))
    return torch.stack([ax, ay, az], -1)


def _deep_near_aggregates3(pos, payload, gp, ci_deep, eps_sq, s_d,
                           rr: int, row0=0):
    """Smoothed-aggregate near field of the deep path: the (2rr+1)^3
    deepest-level cell aggregates evaluated at each particle, each cell a
    Plummer cloud (softening widened to eps^2 + (0.3 s_d)^2; see the 2D
    `_deep_near_aggregates`). gp: [rows + 2rr, r_d + 2rr, r_d + 2rr, C]
    PRE-PADDED moment window (zeros on one device; an x-slab band with real
    halo slabs in a banded tree); `row0` is the global deep x-slab of its
    first real slab, and out-of-window targets gather clipped slabs
    (callers mask them). Returns [N, 3], unscaled by g_const."""
    eps_sq = eps_sq + _DEEP_SMOOTH * s_d * s_d
    rows = gp.shape[0] - 2 * rr
    side = gp.shape[1]
    gp = gp.reshape(-1, gp.shape[-1])
    ix = torch.clamp(ci_deep[:, 0] - row0, 0, rows - 1) + rr
    base = (ix * side + ci_deep[:, 1] + rr) * side + ci_deep[:, 2] + rr
    return _aggregate_window_eval3(gp, base, side, payload, pos, eps_sq, rr)


def _fold_aggregate_ring3(local, window, corner, size, r_full: int, eps_sq,
                          radius: int, row0, rows: int):
    """Fold the OUTER shell (Chebyshev >= 2) of the smoothed aggregate
    window into the local expansion as a dense stencil, so the
    per-particle pass keeps only the inner 3^3 (see the 2D
    `_fold_aggregate_ring`). `window`: 10 moment grids pre-padded by
    rr = radius - 1 (leading batch axes allowed, `corner` [..., 3]). A
    no-op at the default R = 2 (rr = 1: the window is the inner 3^3)."""
    rr = radius - 1
    if rr < 2:
        return local
    s_d = size / r_full
    eps_w = eps_sq + _DEEP_SMOOTH * s_d * s_d
    ring = [(ox, oy, oz)
            for ox in range(-rr, rr + 1)
            for oy in range(-rr, rr + 1)
            for oz in range(-rr, rr + 1)
            if max(abs(ox), abs(oy), abs(oz)) >= 2]
    terms = _m2l_stencil3(window, corner, size, r_full, eps_w, radius,
                          row0=row0, rows=rows, offsets=ring,
                          gate_parity=False, pad=rr)
    return tuple(a + b for a, b in zip(local, terms))


def _tile_select3(ci_f, b_par, deep: int, t: int, T: int, radius: int):
    """Top-T t^3-cell tiles by deep-path-target count. Returns (tid [N]
    home-tile id, tile_slot [nt^3 + 1] tile id -> slot (T = unselected; the
    last entry is the sentinel), orig [T, 3] window origin in deep cells =
    tile corner - radius). Ties break as `lax.top_k`'s, lower index first:
    a stable descending sort."""
    nt = (1 << deep) // t
    device = ci_f.device
    tid = ((ci_f[:, 0] // t) * nt + ci_f[:, 1] // t) * nt + ci_f[:, 2] // t
    scores = torch.zeros(nt ** 3, dtype=torch.int64, device=device)
    scores.index_add_(0, tid, b_par.to(torch.int64))
    top_s, top_i = torch.sort(scores, descending=True, stable=True)
    top_s, top_i = top_s[:T], top_i[:T]
    # Score-0 tiles are not selected: they write to a dump entry past the
    # sentinel, which stays T.
    tile_slot = torch.full((nt ** 3 + 2,), T, dtype=torch.int64,
                           device=device)
    tile_slot[torch.where(top_s > 0, top_i, nt ** 3 + 1)] = torch.arange(
        T, device=device)
    orig = torch.stack([top_i // (nt * nt), (top_i // nt) % nt, top_i % nt],
                       -1) * t - radius
    return tid, tile_slot[:nt ** 3 + 1], orig


def _tile_candidates3(ci_f, tile_slot, t: int, T: int, radius: int,
                      nt: int):
    """Each row's eight candidate tile windows at the deep level: its home
    tile, and each x/y/z neighbour combination toward the edges it lies
    within `radius` cells of. Returns [(ok, slot)] in the JAX package's
    order, home first, then (cx, cy, cz) = (0, 0, 1), (0, 1, 0), ...,
    (1, 1, 1); ok is True where that tile is selected."""
    H = radius
    tq = [ci_f[:, a] // t for a in range(3)]
    sg = []
    for a in range(3):
        m = ci_f[:, a] % t
        sg.append(torch.where(m < H, -1, torch.where(m >= t - H, 1, 0)))
    out = []
    for c in range(8):
        use = (c >> 2, (c >> 1) & 1, c & 1)
        ct = [tq[a] + sg[a] if use[a] else tq[a] for a in range(3)]
        ok = torch.ones_like(ct[0], dtype=torch.bool)
        for a in range(3):
            ok = ok & (ct[a] >= 0) & (ct[a] < nt)
            if use[a]:
                ok = ok & (sg[a] != 0)
        slot = tile_slot[torch.where(ok, (ct[0] * nt + ct[1]) * nt + ct[2],
                                     nt ** 3)]
        out.append((ok & (slot < T), slot))
    return out


def _tile_src_mask3(ci_f, tile_slot, deep: int, radius: int, t: int,
                    T: int):
    """Rows that can contribute moments to any selected tile window: the
    selected tiles' members and the rows within `radius` of an edge whose
    neighbour tile is selected."""
    cands = _tile_candidates3(ci_f, tile_slot, t, T, radius,
                              (1 << deep) // t)
    src = cands[0][0]
    for ok, _ in cands[1:]:
        src = src | ok
    return src


def _tile_scatter3(payload, bulk_pos, ci_f, tile_slot, orig, corner, size,
                   deep: int, radius: int, k: int, t: int, T: int,
                   src_mask=None):
    """Moment scatter into the selected tile windows at 2^k x the deep
    resolution -> g4k [T, Wf, Wf, Wf, 4] (m, sx, sy, sz). Every row
    scatters into its home tile; the seven halo candidates take only the
    first `_halo_cap(m)` rows, in index order, of the rows on an edge whose
    neighbour tile is selected (and, with `src_mask`, only those rows). The
    quadrupole channels are synthesized per level in `_tile_chain3`."""
    m = bulk_pos.shape[0]
    f = 1 << k
    Wf = (t + 2 * radius) * f
    drop = T * Wf ** 3
    ci_sub, _ = _cell_ids(bulk_pos, corner, size, (1 << deep) * f)
    pay4 = payload[:, :4]
    cands = _tile_candidates3(ci_f, tile_slot, t, T, radius,
                              (1 << deep) // t)

    def dest(ok, slot, sub):
        rel = sub - orig[torch.clamp(slot, max=T - 1)] * f
        return torch.where(
            ok, ((slot * Wf + rel[:, 0]) * Wf + rel[:, 1]) * Wf + rel[:, 2],
            drop)

    g4t = torch.zeros((drop + 1, 4), dtype=bulk_pos.dtype,
                      device=bulk_pos.device)
    g4t.index_add_(0, dest(*cands[0], ci_sub), pay4)
    on_edge = cands[1][0]
    for ok, _ in cands[2:]:
        on_edge = on_edge | ok
    if src_mask is not None:
        on_edge = on_edge & src_mask
    bidx = torch.argsort((~on_edge).to(torch.int32), stable=True)[
        :_halo_cap(m)]
    pay_b = torch.where(on_edge[bidx, None], pay4[bidx], 0.0)
    for ok, slot in cands[1:]:
        g4t.index_add_(0, dest(ok[bidx], slot[bidx], ci_sub[bidx]), pay_b)
    return g4t[:drop].reshape(T, Wf, Wf, Wf, 4)


def _tile_chain3(local_w, g4k, orig, corner, size, deep: int, radius: int,
                 eps_sq, k: int, t: int, T: int):
    """Per-tile sub-level chain, the T tiles as one batch: upsample the
    window locals and add each sub-level's M2L terms (window origins are
    even at every sub-level, so the tile grids' parity stays aligned with
    the global hierarchy), then fold the tile aggregate ring. Returns
    local_w [T, Wf, Wf, Wf, 19]."""
    W = t + 2 * radius
    s_D = size / (1 << deep)
    corner_t = corner[None, :] + orig.to(g4k.dtype) * s_D        # [T, 3]
    size_w = W * s_D
    pooled4 = {k: g4k}
    for j in range(k - 1, 0, -1):
        pooled4[j] = _pool_seq3(pooled4[j + 1])
    for j in range(1, k + 1):
        g10 = _synth_quad_channels3(pooled4[j])
        up = _l2l_upsample3(tuple(local_w[..., c] for c in range(19)),
                            s_D / (1 << j))
        terms = _m2l_level3(tuple(g10[..., c] for c in range(10)), corner_t,
                            size_w, eps_sq, radius)
        local_w = torch.stack([a + b for a, b in zip(up, terms)], -1)
    rr = radius - 1
    if rr >= 2:
        g10k = _synth_quad_channels3(g4k)
        window = tuple(F.pad(g10k[..., c], (rr,) * 6) for c in range(10))
        Wf = W << k
        local_w = torch.stack(_fold_aggregate_ring3(
            tuple(local_w[..., c] for c in range(19)), window, corner_t,
            size_w, Wf, eps_sq, radius, 0, Wf), -1)
    return local_w


def _tile_apply3(pos, payload, bulk_pos, ci_f, b_par, local_w, g4k,
                 tile_slot, orig, corner, size, deep: int, radius: int,
                 eps_sq, k: int, t: int, T: int):
    """Refined per-particle evaluation against the chained tile locals and
    the tile aggregates (inner 3^3; the ring is folded into local_w).
    Returns (refined [N] bool, far_ref [N, 3], near_ref [N, 3]); the
    outputs are unscaled by g_const and garbage where ~refined."""
    dtype = pos.dtype
    rD = 1 << deep
    f = 1 << k
    Wf = (t + 2 * radius) * f
    nt = rD // t
    tid = ((ci_f[:, 0] // t) * nt + ci_f[:, 1] // t) * nt + ci_f[:, 2] // t
    ci_sub, _ = _cell_ids(bulk_pos, corner, size, rD * f)
    slot_home = tile_slot[tid]
    refined = (slot_home < T) & b_par
    sc = torch.clamp(slot_home, max=T - 1)
    rel = torch.clamp(ci_sub - orig[sc] * f, 0, Wf - 1)

    s_k = size / rD / f
    cent = corner[None, :] + (ci_sub.to(dtype) + 0.5) * s_k
    d = pos - cent
    g19 = local_w.reshape(T * Wf ** 3, 19)[
        ((sc * Wf + rel[:, 0]) * Wf + rel[:, 1]) * Wf + rel[:, 2]]
    ev = _taylor_eval3(tuple(g19[:, i] for i in range(19)), d[:, 0],
                       d[:, 1], d[:, 2])

    rin = min(radius - 1, 1)
    g4kp = F.pad(g4k, (0, 0) + (rin, rin) * 3)
    side = Wf + 2 * rin
    base = (((sc * side + rel[:, 0] + rin) * side + rel[:, 1] + rin) * side
            + rel[:, 2] + rin)
    near_ref = _aggregate_window_eval3(
        g4kp.reshape(-1, 4), base, side, payload[:, :4], pos,
        eps_sq + _DEEP_SMOOTH * s_k * s_k, rin)
    return refined, torch.stack(ev[:3], -1), near_ref


def _tile_eval3(pos, payload, bulk_pos, ci_f, b_par, local_w,
                tid, tile_slot, orig, corner, size, deep: int, radius: int,
                eps_sq, k: int, t: int, T: int):
    """Per-tile chain and refined per-particle evaluation, given the window
    slice of the level-D locals. The scatter takes only the rows that can
    reach a selected window, and the apply only the refined targets,
    each compacted to a fixed capacity when the count fits it (a host
    sync), else over all rows; both give the same result."""
    n = pos.shape[0]
    geo = (corner, size, deep, radius, k, t, T)
    s_cap = _scatter_cap3(n)
    g4k = None
    if s_cap < n:
        sidx_s, n_src = _compact_indices(
            _tile_src_mask3(ci_f, tile_slot, deep, radius, t, T), s_cap)
        if int(n_src) <= s_cap:
            valid_s = sidx_s < n
            ss = torch.clamp(sidx_s, max=n - 1)
            g4k = _tile_scatter3(
                torch.where(valid_s[:, None], payload[ss], 0.0),
                bulk_pos[ss], ci_f[ss], tile_slot, orig, *geo,
                src_mask=valid_s)
    if g4k is None:
        g4k = _tile_scatter3(payload, bulk_pos, ci_f, tile_slot, orig, *geo)
    local_w = _tile_chain3(local_w, g4k, orig, corner, size, deep, radius,
                           eps_sq, k, t, T)

    cap = _refined_cap3(n)
    if cap < n:
        sidx, n_cand = _compact_indices((tile_slot[tid] < T) & b_par, cap)
        if int(n_cand) <= cap:
            valid = sidx < n
            si = torch.clamp(sidx, max=n - 1)
            r_s, far_s, near_s = _tile_apply3(
                pos[si], payload[si], bulk_pos[si], ci_f[si],
                b_par[si] & valid, local_w, g4k, tile_slot, orig,
                corner, size, deep, radius, eps_sq, k, t, T)
            return tuple(_scatter_rows(
                n, torch.where(valid & r_s, si, n), r_s, far_s, near_s))
    return _tile_apply3(pos, payload, bulk_pos, ci_f, b_par, local_w, g4k,
                        tile_slot, orig, corner, size, deep, radius, eps_sq,
                        k, t, T)


def _tile_windows3(local_deep, orig, t: int, radius: int):
    """Each tile's window [T, W, W, W, 19] of the level-D locals, zero
    beyond the grid: one gather a channel, no host sync for the origins
    (channel by channel, so the 19-channel grid is never stacked: 1.3 GB at
    the 256^3 deep level)."""
    H = radius
    span = torch.arange(t + 2 * H, device=orig.device)
    ix, iy, iz = (orig[:, a, None] + H + span for a in range(3))   # [T, W]
    idx = (ix[:, :, None, None], iy[:, None, :, None], iz[:, None, None, :])
    return torch.stack([F.pad(g, (H,) * 6)[idx] for g in local_deep], -1)


def _tile_refine3(pos, payload, bulk_pos, ci_f, b_par, local_deep,
                  corner, size, deep: int, radius: int, eps_sq,
                  k: int, t: int, T: int):
    """Hot-zone sub-box refinement: continue the deep chain k more levels
    inside the T hottest t^3-cell tiles of the deepest level, so the
    aggregates' smoothing scale drops 2^k where the targets crowd (what
    lets clustered 3D scenes keep tree-speed evals with core smoothing
    finer than the 256^3 global deep grid). Targets whose home tile is not
    selected keep the deep path. Returns (refined [N] bool, far_ref [N, 3],
    near_ref [N, 3]), unscaled by g_const and garbage where ~refined."""
    tid, tile_slot, orig = _tile_select3(ci_f, b_par, deep, t, T, radius)
    local_w = _tile_windows3(local_deep, orig, t, radius)
    return _tile_eval3(pos, payload, bulk_pos, ci_f, b_par, local_w,
                       tid, tile_slot, orig, corner, size, deep, radius,
                       eps_sq, k=k, t=t, T=T)


def _sparse_near_field3(pos, bulk_pos, tree_mass, ci, flat, hot, b_par,
                        is_out, eps_sq: float, g_const: float, radius: int):
    """The sparse near field (`bh_nf_sparse=1`): where nearly every target
    takes the deep path, the bucket-tier targets (~b_par) get an exact
    cell-masked pairwise pass (Chebyshev radius - 1 cells, as the bucket
    stencil covers) instead of the dense bucket grid. Only the first
    `_nf_sparse_cap(n)` of them; the rest promote to the deep path. A
    bucket-tier target has no hot cell in its window, so its sources are
    the residents of cells that are not hot, compacted to
    `_nf_sparse_src_cap(n)` (all N sources past it).

    The JAX package pads both sides to those static caps; here the pass
    runs on the valid target rows and compacted sources only (zero-mass
    padding adds nothing, so only the blocks' summation order differs),
    and not at all without a bucket-tier target. Returns (near [N, 3]
    scaled by g_const, zero off the pass's rows; b_par with the promoted
    rows)."""
    n = pos.shape[0]
    cand = ~b_par & ~is_out
    cap = _nf_sparse_cap(n)
    sidx, n_cand = _compact_indices(cand, cap)
    n_tgt = min(int(n_cand), cap)
    near = torch.zeros_like(pos)
    if n_tgt:
        si = sidx[:n_tgt]
        src = ~hot[flat]
        scap = _nf_sparse_src_cap(n)
        sidx_s, n_srcs = _compact_indices(src, scap)
        n_srcs = int(n_srcs)
        if scap < n and n_srcs <= scap:
            ss = sidx_s[:n_srcs]
            s_pos, s_mass, s_cell = bulk_pos[ss], tree_mass[ss], ci[ss]
        else:
            s_pos, s_mass, s_cell = bulk_pos, tree_mass, ci
        block = 8192 if pos.device.type == "cuda" else 2048
        near[si] = g_const * _near_masked_blocked(
            pos[si], ci[si], s_pos, s_mass, s_cell, eps_sq, radius - 1,
            block)
    rank = torch.cumsum(cand, 0) - 1
    return near, b_par | (cand & (rank >= cap))


def _deep_chain3(pos, bulk_pos, tree_mass, grids, local, corner, size, ci_f,
                 b_par, far, near, levels: int, deep: int, eps_sq: float,
                 g_const: float, radius: int, tile_levels: int,
                 tile_size: int, tile_count: int):
    """The deep branch of `_bh3_accelerations`: continue the downward pass
    from the bucket level's locals to `deep`, and give the deep-path
    targets (b_par) the deep L2P against the ring-folded locals plus the
    inner 3^3 smoothed aggregates, then the tile refinement. Returns the
    overridden (far, near), scaled by g_const. Without a deep-path target
    (no overflowing cell) nothing changes, and nothing runs (one host
    sync)."""
    n = pos.shape[0]
    if not bool(b_par.any()):
        return far, near
    for lv in range(levels + 1, deep + 1):
        terms = _m2l_level3(grids[lv], corner, size, eps_sq, radius)
        up = _l2l_upsample3(local, size / (1 << lv))
        local = tuple(u + t for u, t in zip(up, terms))
    local_deep = local

    payload = _moment_payload3(pos, tree_mass)
    rrd = radius - 1
    rin = min(rrd, 1)    # inner aggregate window; the shell folds into L2P
    # The tiles must see the UN-folded local_deep: their sub-level chain
    # re-decomposes the window the fold covers. At R = 2 the fold is a
    # no-op: its padded 10-channel window (7 GB at 256^3) is not built.
    local_agg = local_deep
    if rrd >= 2:
        local_agg = _fold_aggregate_ring3(
            local_deep, tuple(F.pad(g, (rrd,) * 6) for g in grids[deep]),
            corner, size, 1 << deep, eps_sq, radius, row0=0, rows=1 << deep)
    g4_pad = F.pad(torch.stack(grids[deep][:4], -1), (0, 0) + (rin,) * 6)
    s_d = size / (1 << deep)

    def deep_rows(pos_r, ci_r, pay_r):
        far_r = g_const * _l2p_eval3(local_agg, ci_r, pos_r, corner, size,
                                     deep)
        near_r = g_const * _deep_near_aggregates3(pos_r, pay_r, g4_pad, ci_r,
                                                  eps_sq, s_d, rr=rin)
        return far_r, near_r

    rows_d = None
    dcap = _deep_rows_cap3(n)
    if tile_levels and dcap < n:
        # Rows the tiles refine discard the deep rows' output, so only
        # b_par & ~refined rows run them (refined equals this cand).
        tid_d, tile_slot_d, _ = _tile_select3(ci_f, b_par, deep, tile_size,
                                              tile_count, radius)
        cand = (tile_slot_d[tid_d] < tile_count) & b_par
        sidx, n_need = _compact_indices(b_par & ~cand, dcap)
        if int(n_need) <= dcap:
            valid = sidx < n
            sd = torch.clamp(sidx, max=n - 1)
            rows_d = _scatter_rows(n, torch.where(valid, sd, n),
                                   *deep_rows(pos[sd], ci_f[sd],
                                              payload[sd, :4]))
    if rows_d is None:
        rows_d = deep_rows(pos, ci_f, payload[:, :4])
    far = torch.where(b_par[:, None], rows_d[0], far)
    near = torch.where(b_par[:, None], rows_d[1], near)

    if tile_levels:
        refined, far_ref, near_ref = _tile_refine3(
            pos, payload, bulk_pos, ci_f, b_par, local_deep, corner, size,
            deep, radius, eps_sq, k=tile_levels, t=tile_size, T=tile_count)
        sel = refined[:, None]
        far = torch.where(sel, g_const * far_ref, far)
        near = torch.where(sel, g_const * near_ref, near)
    return far, near


def _bh3_accelerations(pos, mass, levels: int, eps_sq: float,
                       g_const: float, near_cap: int, radius: int,
                       use_kernels: bool = False, deep_levels: int = 0,
                       tile_levels: int = 0, tile_size: int = 8,
                       tile_count: int = 8, nf_sparse: bool = False):
    """The octree force evaluation (the JAX package's `_bh3_accelerations`).
    With use_kernels, the near field is K7 and the outlier couplings are K1
    (outliers <- all) and K4 (bulk <- outliers); on a CPU tensor those
    wrappers run their plain versions. use_kernels=False runs the plain
    versions on any device. deep_levels > levels turns on the deep-overflow
    chain (`_deep_chain3`), tile_levels > 0 its hot-zone tiles, and
    nf_sparse (with the deep chain) the sparse near field in place of the
    bucket grid and K7."""
    ext, acc_heavy, acc_out, acc_from_out = _exact_couplings(
        pos, mass, eps_sq, g_const, use_kernels)

    tree_mass = ext["tree_mass"]          # the tree sees only the bulk
    bulk_pos = ext["bulk_pos"]
    deep = deep_levels if deep_levels > levels else 0
    grids, corner, size, ci_f, flat_f = _build_pyramid3(
        bulk_pos, tree_mass, deep or levels, synth_quad=bool(deep))
    res = 1 << levels
    if deep:
        ci = ci_f >> (deep - levels)           # bucket-level cell indices
        flat = (ci[:, 0] * res + ci[:, 1]) * res + ci[:, 2]
    else:
        ci, flat = ci_f, flat_f

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
    flat_nf = _outlier_flat_ids(flat, ext["is_out"], res ** 3)
    if not deep:
        near, _ = _near_field_buckets(
            pos, tree_mass, ci, flat_nf, levels, eps_sq, g_const, near_cap,
            radius, use_kernels=use_kernels)
        return _assemble(ext, far, near, acc_heavy, acc_out, acc_from_out)

    b_par, hot = _deep_targets3(flat_nf, flat, ext["is_out"], res, near_cap,
                                radius)
    if nf_sparse:
        near, b_par = _sparse_near_field3(
            pos, bulk_pos, tree_mass, ci, flat, hot, b_par, ext["is_out"],
            eps_sq, g_const, radius)
    else:
        near, _ = _near_field_buckets(
            pos, tree_mass, ci, flat_nf, levels, eps_sq, g_const, near_cap,
            radius, use_kernels=use_kernels, skip_residual=True)
    far, near = _deep_chain3(
        pos, bulk_pos, tree_mass, grids, local, corner, size, ci_f, b_par,
        far, near, levels, deep, eps_sq, g_const, radius, tile_levels,
        tile_size, tile_count)
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
    """3D deep-overflow chain depth: 0 disables; > 0 is explicit; -1 (auto)
    descends 2 levels past the buckets (64x the per-cell resolution),
    capped at `_MAX_DEEP_3D` (a 256^3 moment grid). A depth at or above the
    bucket level disables it."""
    d = config.bh_deep_levels
    if d == 0:
        return 0
    if d < 0:
        d = levels + 2
    return max(levels + 1, min(d, _MAX_DEEP_3D)) if d > levels else 0


def _resolve_tile_params3(config: SimConfig, deep: int,
                          radius: int) -> Tuple[int, int, int]:
    """(k sub-levels, tile side t, tile count T) of the octree's hot-zone
    tiles; (0, 0, 0) disables. The default side is 8 deep cells (8 + 2R
    at k = 3 is a 96^3 window a tile)."""
    k = config.bh_tile_levels
    if deep == 0 or k == 0:
        return 0, 0, 0
    if k < 0:
        k = 3
    t = config.bh_tile_size or 8
    r_d = 1 << deep
    count = config.bh_tile_count
    while t > 2 and (r_d // max(t, 1)) ** 3 < max(count, 8):
        t //= 2
    if t < 2 * radius or t <= 0 or r_d % t:
        return 0, 0, 0
    return k, t, count


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
    deep = _resolve_deep_levels3(config, levels)
    radius = _resolve_radius3(config)
    tk, tt, tc = _resolve_tile_params3(config, deep, radius)
    if use_kernels is None:
        use_kernels = pos.device.type == "cuda"
    return _bh3_accelerations(
        pos, mass, levels=levels, eps_sq=float(config.eps_sq),
        g_const=float(config.g_const), near_cap=NEAR_CAP, radius=radius,
        use_kernels=use_kernels, deep_levels=deep, tile_levels=tk,
        tile_size=tt, tile_count=tc,
        nf_sparse=bool(deep) and config.bh_nf_sparse == 1)


def bh3_near_overflow(pos: torch.Tensor, mass: torch.Tensor,
                      config: SimConfig) -> int:
    """Bulk particles beyond the 3D near-field bucket cap, after the same
    heavy/outlier extraction the force path applies (no forces)."""
    return _near_overflow(pos, mass, _resolve_levels3(config, pos.shape[0]))


def bh3_bucket_tier_count(pos: torch.Tensor, mass: torch.Tensor,
                          config: SimConfig) -> int:
    """Bulk particles that would take the bucket-tier near field (not the
    deep path) under the configuration's resolved deep chain; N when the
    chain is off. `forces._resolve_nf_sparse` reads it: when nearly every
    target is on the deep path, the dense bucket grid is discarded work
    and the sparse near field takes its place."""
    n = pos.shape[0]
    levels = _resolve_levels3(config, n)
    if not _resolve_deep_levels3(config, levels):
        return n
    res = 1 << levels
    ext = _extract_heavy_outliers(pos, mass)
    corner, size = _bounding_box(ext["bulk_pos"])
    _, flat = _cell_ids(ext["bulk_pos"], corner, size, res)
    flat_nf = _outlier_flat_ids(flat, ext["is_out"], res ** 3)
    b_par, _ = _deep_targets3(flat_nf, flat, ext["is_out"], res, NEAR_CAP,
                              _resolve_radius3(config))
    return int((~b_par & ~ext["is_out"]).sum())
