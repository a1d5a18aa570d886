"""The octree's M2L level — CUDA kernel, wrapper, plain version.

Replaces no TPU kernel: the JAX package leaves this contraction to XLA's
`conv_general_dilated` (`nbodysim_tpu/physics/barneshut3d.py:_m2l_conv3`).
The kernel is `csrc/m2l3.cu`; its header says what bounds it on the H100
and how its design answers that.

One V-list level of the octree: the raw moment grids in, the 19 p=2 local
terms (F [3], J [6 sym], H [10 sym]) of every target cell out. The input is
g [..., X, r, r, 10], channel-last raw moments (m, m x, m y, m z, m xx,
m xy, m xz, m yy, m yz, m zz) of a batch of grids (one `corner` [..., 3]
each), X x-slabs of which slab 0 is the grid's x index `x0`; moments beyond
the grid or the slabs given are zero. Targets are the `rows` x-slabs from
`row0` (both even; r even).

  * `m2l3` — the wrapper. On a CUDA tensor it launches the kernel (or
    raises); on a CPU tensor, and only there, it runs the plain version.
    `m2l3.launches` counts kernel launches, and each adds 1 to the tracing
    counter `m2l3.launches`. It takes the pyramid's channel-last grids as
    they lie (any strides: a channel view, a tile batch, a banded x-window)
    and returns the 19 terms as views of one [19, ..., rows, r, r] buffer.
  * `m2l3_plain` — the same function in plain torch: the x-window padded
    with zero slabs to 2(R-1) halo slabs a side, then `_m2l_conv3`, the
    parent-level convolution (cuDNN with TF32 off on a card; the reference
    the kernel is held to there, and the CPU path).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from nbodysim_tpu_torch.diagnostics import profiling
from nbodysim_tpu_torch.physics.barneshut import (
    _full_f32_conv, _iota, _m2l_conv_taps)

RADII = (2, 3, 4, 5)      # the acceptance radii csrc/m2l3.cu is built for

# ---------------------------------------------------------------------------
# The plain version: M2L as one convolution at the parent level (see the 2D
# module): cell-centre moments make the V-list translation-invariant, and
# the space-to-depth view makes the parity-gated ring exact with taps at
# |PO|_inf <= R - 1. 10 moment channels (m, d_x, d_y, d_z, Q_xx, Q_xy,
# Q_xz, Q_yy, Q_yz, Q_zz) x 8 children = 80 in, 19 local terms x 8 children
# = 152 out, (2R-1)^3 taps.
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


def m2l3_plain(g, corner, size, r_full: int, eps_sq, radius: int, *,
               row0: int, rows: int, x0: int):
    """The 19 local terms of the target slabs [row0, row0 + rows) in plain
    torch (see module): `g`'s slabs cut or zero-padded to the window of
    2(R-1) halo slabs a side that `_m2l_conv3` takes."""
    qh = radius - 1
    lo, hi = row0 - 2 * qh - x0, row0 + rows + 2 * qh - x0
    n = g.shape[-4]
    if (lo, hi) != (0, n):
        g = F.pad(g[..., max(lo, 0):min(hi, n), :, :, :],
                  (0, 0) * 3 + (max(-lo, 0), max(hi - n, 0)))
    return _m2l_conv3(g, corner, size, r_full, eps_sq, radius, row0=row0,
                      rows=rows)


def m2l3(g, corner, size, r_full: int, eps_sq, radius: int, *, row0: int,
         rows: int, x0: int):
    """One M2L level's 19 local terms, [..., rows, r_full, r_full] each
    (see module). CUDA tensor: the kernel; CPU: the plain version."""
    if g.device.type == "cpu":
        return m2l3_plain(g, corner, size, r_full, eps_sq, radius,
                          row0=row0, rows=rows, x0=x0)
    out = _launch(g, corner, size, r_full, eps_sq, radius, row0, rows, x0)
    m2l3.launches += 1
    profiling.count("m2l3.launches", 1)
    return tuple(out[t] for t in range(19))


m2l3.launches = 0


def _launch(g, corner, size, r_full, eps_sq, radius, row0, rows,
            x0) -> torch.Tensor:
    """One launch of csrc/m2l3.cu on CUDA tensors: [19, ..., rows, r, r].
    Counts nothing: the wrapper does."""
    if g.device.type != "cuda":
        raise ValueError(f"no M2L kernel for device {g.device}")
    from nbodysim_tpu_torch.kernels._build import check, library

    device = g.device
    for name, t in (("moments", g), ("corner", corner), ("size", size)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 \
                or t.device != device:
            raise ValueError(f"the M2L kernel takes float32 tensors on "
                             f"{device}; {name} is {type(t).__name__} "
                             f"{getattr(t, 'dtype', '')}")
    if g.dim() < 4 or g.shape[-3:] != (r_full, r_full, 10):
        raise ValueError(f"moments {tuple(g.shape)}: expected [..., X, "
                         f"{r_full}, {r_full}, 10], channel last")
    lead, X = g.shape[:-4], g.shape[-4]
    if r_full < 2 or r_full % 2 or row0 % 2 or rows % 2 or rows <= 0 \
            or row0 < 0 or row0 + rows > r_full:
        raise ValueError(f"the M2L kernel takes an even grid and even target "
                         f"slabs inside it: r={r_full}, row0={row0}, "
                         f"rows={rows}")
    if radius not in RADII:
        raise ValueError(f"no M2L kernel for acceptance radius {radius}")
    if corner.shape[-1:] != (3,) or size.numel() != 1:
        raise ValueError(f"corner {tuple(corner.shape)} and size "
                         f"{tuple(size.shape)}: expected [..., 3] and one "
                         f"number")
    gb = g.reshape((-1,) + g.shape[-4:])
    batch = gb.shape[0]
    corner_b = corner.expand(lead + (3,)).reshape(batch, 3).contiguous()
    size_1 = size.reshape(1)
    out = torch.empty((19,) + lead + (rows, r_full, r_full),
                      dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    lib = library()
    wtab = torch.empty(lib.nb_m2l3_table_floats(radius), dtype=torch.float32,
                       device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.nb_m2l3(
            gb.data_ptr(), *gb.stride(), batch, X, x0, r_full, row0, rows,
            corner_b.data_ptr(), size_1.data_ptr(), float(eps_sq), radius,
            wtab.data_ptr(), out.data_ptr(), stream)
    check(status, "nb_m2l3")
    return out
