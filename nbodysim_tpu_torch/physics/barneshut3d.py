"""The octree's stages: the 3D tree code's stage math, row caps and
resolvers (port of `nbodysim_tpu.physics.barneshut3d`).

The force evaluation itself is the one pipeline of `physics/barneshut.py`
(`bh_accelerations`), which takes these stages for a 3D state; the
bucket grid, its residual, the exact couplings and the row compactions
are that module's, generic over dim. The JAX module's docstring gives the
design and the derivative formulas:

  upward (M2M):  one [N, 10]-payload `index_add_` of the raw moments
                 (m, m r_i, m r_i r_j) into the finest 2^L x 2^L x 2^L grid,
                 2 x 2 x 2 sum-pooling up the pyramid.
  M2L:           per level, the V-list (Chebyshev distance R..2R-1, parity-
                 gated on the outer ring) into p=2 local terms: F [3],
                 J [6 sym], H [10 sym]: on the card one launch of the M2L
                 kernel (`kernels/m2l3.py`, `csrc/m2l3.cu`) on the moment
                 grids as they lie; on the CPU its plain version, ONE
                 parent-level convolution (`kernels/m2l3._m2l_conv3`,
                 `F.conv3d`, 80 -> 152 channels); `_m2l_stencil3` is the
                 reference of both and the odd-size path.
  L2L / L2P:     local expansions re-centred down the pyramid, then one
                 [19, N] gather per particle and a second-order Taylor
                 evaluation.
  near field:    the (2R-1)^3 finest-cell neighbourhood particle-particle on
                 the shared bucket grid [r, r, r, K] (`NEAR_CAP` slots): K7
                 (`kernels/nearfield.py`) on the card; cells holding more
                 than K particles spill into the exact near-masked residual.
  deep chain:    the pipeline's, with the octree's stages: the synthesized
                 pyramid (`_pool2x3`), the deep targets and hot cells
                 (`_deep_targets3`), the 3^3 aggregates, and the tiles
                 (`_tile_select3` .. `_tile_apply3`, windows gathered a
                 channel at a time by `_tile_windows3`). With
                 `bh_nf_sparse=1` the few bucket-tier targets get an exact
                 cell-masked pass instead of the dense bucket grid
                 (`_sparse_near_field3`).

Differences from the JAX package, each deliberate:
  * the M2L runs in full f32 at every level: the kernel in FMA on the CUDA
    cores, the plain convolution with cuDNN's TF32 off around the call (the
    JAX package pins HIGHEST, and HIGH, bf16x3, from r = 256: the deep
    chain's 256^3 level);
  * the plain convolution's space-to-depth and its inverse are a reshape
    and a permute; the JAX package's permutation-matrix products, identity
    contraction and per-term interleaves are TPU layout workarounds. The
    channel order is the same: (4a + 2b + d) * 10 + c in, (4c + 2d + e) *
    19 + t out;
  * the pyramid pools by reshape-sum (the strided-slice form is a TPU
    tiling workaround), except the synthesized (deep-mode) grids, which
    pool in the JAX package's order (`_pool2x3`, and `_pool_seq3` for the
    tiles): their quadrupoles are sx^2/m at absolute coordinates, centred
    by subtracting ~m c^2, so the pooled sums' last bits matter;
  * the residual tiers, the deep chain's row compactions and the sparse
    near field's source compaction are Python branches on a count read from
    the device (one host sync each, `profiling.host_read`), where the JAX
    package uses `lax.cond`;
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

import torch
import torch.nn.functional as F

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.diagnostics import profiling
from nbodysim_tpu_torch.kernels.m2l3 import m2l3
from nbodysim_tpu_torch.physics.barneshut import (
    _DEEP_SMOOTH, NEAR_CAP, _bounding_box, _cell_ids, _compact_indices,
    _count_rows, _extract_heavy_outliers, _halo_cap, _iota,
    _near_masked_blocked, _outlier_flat_ids, bh_accelerations,
    bh_near_overflow)

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
    the M2L centres by subtracting ~m c^2 (`kernels.m2l3`): the pooled
    sums' last bits then reach the deep local terms, so the order must be
    the reference's."""
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


def _channel_stack3(g10):
    """The 10 moment grids as one [..., 10] tensor: a view where they are
    the channels of one channel-last tensor (as the pyramid and the tile
    chain make them), else a stack."""
    a = g10[0]
    step, rem = divmod(g10[1].data_ptr() - a.data_ptr(), a.element_size())
    base = a.untyped_storage().data_ptr()
    if step > 0 and not rem and all(
            c.shape == a.shape and c.stride() == a.stride()
            and c.dtype == a.dtype
            and c.untyped_storage().data_ptr() == base
            and c.data_ptr() == a.data_ptr() + i * step * a.element_size()
            for i, c in enumerate(g10)):
        return a.as_strided(a.shape + (10,), a.stride() + (step,))
    return torch.stack(g10, -1)


def _m2l_level3(g10, corner, size, eps_sq, radius: int):
    """V-list pass at one full level -> p=2 local terms (19 x [r, r, r]).

    Even grids (every real level) run through `kernels.m2l3.m2l3`: the
    kernel on the card, the parent-level convolution on the CPU; the
    stencil is the reference and the odd-size path. Even grids may carry
    leading batch axes (the deep chain's tiles), with one corner per grid.
    Every call is the span `tree.m2l`, inside the stage that makes it
    (`tree.downward`, `tree.deep`, `tree.tiles`)."""
    r = g10[0].shape[-1]
    with profiling.span("tree.m2l"):
        if r % 2 == 0 and r >= 2:
            return m2l3(_channel_stack3(g10), corner, size, r, eps_sq,
                        radius, row0=0, rows=r, x0=0)
        p = 2 * radius - 1
        window = tuple(F.pad(g, (p,) * 6) for g in g10)
        return _m2l_stencil3(window, corner, size, r, eps_sq, radius,
                             row0=0, rows=r)


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
    and not at all without a bucket-tier target. Its two counts are host
    reads (`sparse_targets`, `sparse_sources`), and the row counters of
    both compactions count the rows the pass runs on: its valid targets,
    and the compacted sources, or all N past their cap. Returns (near
    [N, 3] scaled by g_const, zero off the pass's rows; b_par with the
    promoted rows)."""
    n = pos.shape[0]
    cand = ~b_par & ~is_out
    cap = _nf_sparse_cap(n)
    sidx, n_cand = _compact_indices(cand, cap)
    n_tgt = min(profiling.host_read(n_cand, "sparse_targets"), cap)
    near = torch.zeros_like(pos)
    if n_tgt:
        _count_rows("sparse_targets", n_tgt, n_tgt, n)
        si = sidx[:n_tgt]
        src = ~hot[flat]
        scap = _nf_sparse_src_cap(n)
        sidx_s, n_srcs = _compact_indices(src, scap)
        n_srcs = profiling.host_read(n_srcs, "sparse_sources")
        fits = scap < n and n_srcs <= scap
        _count_rows("sparse_sources", n_srcs, n_srcs if fits else n, n)
        if fits:
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
    """The octree's accelerations under the JAX package's name: the one
    pipeline, `barneshut.bh_accelerations`, on a 3D state."""
    return bh_accelerations(pos, mass, config, use_kernels=use_kernels)


def bh3_near_overflow(pos: torch.Tensor, mass: torch.Tensor,
                      config: SimConfig) -> int:
    """`barneshut.bh_near_overflow` under the JAX package's 3D name."""
    return bh_near_overflow(pos, mass, config)


def bh3_bucket_tier_count(pos: torch.Tensor, mass: torch.Tensor,
                          config: SimConfig) -> int:
    """Bulk particles that would take the bucket-tier near field (not the
    deep path) under the configuration's resolved deep chain; N when the
    chain is off. `barneshut._resolve_nf_sparse` reads it: when nearly every
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
