"""K3 and K7: the tree code's near field on a dense bucket grid, in 2D and
3D — CUDA kernels, wrappers, plain versions.

Replaces the TPU kernels `nbodysim_tpu/kernels/nearfield.py:_nearfield_kernel`
(K3; wrappers `bucket_stencil_pallas_flat`, `bucket_stencil_pallas`) and
`_nearfield3_kernel` (K7; wrapper `bucket_stencil3_pallas_flat`, layout
class `_FlatLayout3`). The kernels are `csrc/nearfield.cu` and
`csrc/nearfield3.cu`; their headers say what bounds them on the H100 and how
their designs answer that. The TPU kernels' slot-major `[K, F]` layouts,
128-aligned pitches, lead margins and column shifts exist for their DMA
alignment; the functions here take the bucket grid as the tree code builds
it.

  * `bucket_stencil` / `bucket_stencil3` — the wrappers. On a CUDA tensor
    each launches its kernel (or raises); on a CPU tensor, and only there,
    it runs the plain version. `.launches` counts kernel launches.
  * `bucket_stencil_plain` / `bucket_stencil3_plain` — the same functions
    in plain torch (the ports of `physics/barneshut._bucket_stencil` and
    `physics/barneshut3d._bucket_stencil3`): for each of the (2rr+1)^D
    static neighbour offsets, a broadcast K x K pair block, chunked over
    rows (x-slabs). The CPU path, and the reference the kernels are held
    to on the card.

Contract, 2D: bx, by, bm are [center_rows + 2rr, res, K] (K slots per cell);
target cells are the rows [rr, rr + center_rows); the rr halo rows on each
side are sources only. Returns (accx, accy), [center_rows, res, K] each,
unscaled by G. 3D: bx, by, bz, bm are [center_rows + 2rr, res, res, K] with
rr halo x-slabs; returns (accx, accy, accz), [center_rows, res, res, K] each.

Occupancy: the wrappers take `counts`, int32 of the grid's shape without its
slot axis ([center_rows + 2rr, res(, res)], halo included): the cell's
occupied slots, which fill from slot 0. Every slot at or above its cell's
count must be empty (mass 0), as `physics/barneshut._bucket_grid` leaves it;
a slot below it may hold a massless particle, and is still a target. The
kernels compute the slots below each count and write exactly 0 at every
slot at or above it, and take as sources only the slots below the counts.
The plain versions ignore `counts` and compute every slot, empty ones
included; `_bucket_gather` reads only the occupied slots, so the force path
gets the same numbers either way. The count cannot be read off the mass
grid: the tree zeroes the mass of heavy bodies, which keep their slot.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def bucket_stencil_plain(bx, by, bm, rr: int, eps_sq: float,
                         center_rows: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch K x K pair stencil over the bucket grid (see module)."""
    _, res, cap = bx.shape
    tx = bx[rr:rr + center_rows]
    ty = by[rr:rr + center_rows]

    def pad_cols(a):
        return F.pad(a, (0, 0, rr, rr))

    bx_p, by_p, bm_p = pad_cols(bx), pad_cols(by), pad_cols(bm)
    # Row-chunked K x K pair blocks: a full [rows, res, K, K] temp is
    # O(rows * res * K^2) -- chunk rows so temps stay ~256 MB.
    chunk = max(1, min(center_rows, (1 << 26) // max(1, res * cap * cap)))
    accx = torch.zeros((center_rows, res, cap), dtype=bx.dtype,
                       device=bx.device)
    accy = torch.zeros_like(accx)
    for ox in range(-rr, rr + 1):
        for oy in range(-rr, rr + 1):
            r0, c0 = rr + ox, rr + oy
            for i in range(0, center_rows, chunk):
                j = min(center_rows, i + chunk)
                sx = bx_p[r0 + i:r0 + j, c0:c0 + res]
                sy = by_p[r0 + i:r0 + j, c0:c0 + res]
                sm = bm_p[r0 + i:r0 + j, c0:c0 + res]
                dx = sx[:, :, None, :] - tx[i:j, :, :, None]
                dy = sy[:, :, None, :] - ty[i:j, :, :, None]
                d_sq = dx * dx + dy * dy
                inv = torch.rsqrt(d_sq + eps_sq)
                w = sm[:, :, None, :] * (inv * inv * inv)
                if eps_sq == 0.0:
                    w = torch.where(d_sq > 0.0, w, 0.0)
                accx[i:j] += (w * dx).sum(-1)
                accy[i:j] += (w * dy).sum(-1)
    return accx, accy


def _check_counts(counts, grid_shape, device, name: str):
    """`counts` must be int32 [grid_shape[:-1]] on `device`."""
    if not torch.is_tensor(counts) or counts.dtype != torch.int32:
        raise ValueError(f"{name}: counts must be an int32 tensor")
    if counts.device != device:
        raise ValueError(f"{name}: counts on {counts.device}, expected "
                         f"{device}")
    if tuple(counts.shape) != tuple(grid_shape[:-1]):
        raise ValueError(f"{name}: counts {tuple(counts.shape)}, expected "
                         f"the grid's cells {tuple(grid_shape[:-1])}")
    return counts.contiguous()


def bucket_stencil(bx, by, bm, *, counts, rr: int, eps_sq: float,
                   center_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Near field per slot (see module). CUDA tensor: K3; CPU: plain."""
    counts = _check_counts(counts, bx.shape, bx.device, "K3")
    if bx.device.type == "cpu":
        return bucket_stencil_plain(bx, by, bm, rr, eps_sq, center_rows)
    if bx.device.type != "cuda":
        raise ValueError(f"no K3 kernel for device {bx.device}")
    from nbodysim_tpu_torch.kernels._build import check, f32_args, library

    device = bx.device
    bx, by, bm = f32_args(device, bx, by, bm)
    rows_w, res, cap = bx.shape
    if by.shape != bx.shape or bm.shape != bx.shape:
        raise ValueError(
            f"bucket grids {tuple(bx.shape)}, {tuple(by.shape)}, "
            f"{tuple(bm.shape)} differ")
    if rows_w != center_rows + 2 * rr:
        raise ValueError(
            f"{rows_w} grid rows, expected center_rows + 2rr = "
            f"{center_rows + 2 * rr}")
    if not (1 <= cap <= 16 and 0 <= rr <= 4):
        raise ValueError(f"K3 takes 1 <= K <= 16 slots and rr <= 4, got "
                         f"K={cap}, rr={rr}")
    accx = torch.empty((center_rows, res, cap), dtype=torch.float32,
                       device=device)
    accy = torch.empty_like(accx)
    if accx.numel() == 0:
        return accx, accy
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.nb_bucket_stencil(
            bx.data_ptr(), by.data_ptr(), bm.data_ptr(), counts.data_ptr(),
            accx.data_ptr(), accy.data_ptr(), center_rows, res, cap, rr,
            float(eps_sq), stream)
    check(status, "nb_bucket_stencil")
    bucket_stencil.launches += 1
    return accx, accy


bucket_stencil.launches = 0


def bucket_stencil3_plain(bx, by, bz, bm, rr: int, eps_sq: float,
                          center_rows: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-torch K x K pair stencil over the 3D bucket grid (see module).
    Offsets are summed in (ox, oy, oz) order, as the JAX package's scan
    does; each offset's K source slots are summed before it is added."""
    _, res, _, cap = bx.shape
    tx, ty, tz = (a[rr:rr + center_rows] for a in (bx, by, bz))

    def pad_yz(a):
        return F.pad(a, (0, 0, rr, rr, rr, rr))

    bx_p, by_p, bz_p, bm_p = (pad_yz(a) for a in (bx, by, bz, bm))
    # x-slab-chunked K x K pair blocks: temps stay ~256 MB on the card, ~1 MB
    # on the CPU, where the memory traffic of larger temps costs ~4x the
    # time. Chunking changes no element's arithmetic.
    budget = 1 << (26 if bx.device.type == "cuda" else 18)
    chunk = max(1, min(center_rows, budget // max(1, res * res * cap * cap)))
    out = tuple(torch.zeros((center_rows, res, res, cap), dtype=bx.dtype,
                            device=bx.device) for _ in range(3))
    for ox in range(-rr, rr + 1):
        for oy in range(-rr, rr + 1):
            for oz in range(-rr, rr + 1):
                x0, y0, z0 = rr + ox, rr + oy, rr + oz
                for i in range(0, center_rows, chunk):
                    j = min(center_rows, i + chunk)

                    def src(a):
                        return a[x0 + i:x0 + j, y0:y0 + res, z0:z0 + res,
                                 None, :]

                    dx = src(bx_p) - tx[i:j, ..., None]
                    dy = src(by_p) - ty[i:j, ..., None]
                    dz = src(bz_p) - tz[i:j, ..., None]
                    d_sq = dx * dx + dy * dy + dz * dz
                    inv = torch.rsqrt(d_sq + eps_sq)
                    w = src(bm_p) * (inv * inv * inv)
                    if eps_sq == 0.0:
                        w = torch.where(d_sq > 0.0, w, 0.0)
                    for acc, d in zip(out, (dx, dy, dz)):
                        acc[i:j] += (w * d).sum(-1)
    return out


def bucket_stencil3(bx, by, bz, bm, *, counts, rr: int, eps_sq: float,
                    center_rows: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """3D near field per slot (see module). CUDA tensor: K7; CPU: plain."""
    counts = _check_counts(counts, bx.shape, bx.device, "K7")
    if bx.device.type == "cpu":
        return bucket_stencil3_plain(bx, by, bz, bm, rr, eps_sq, center_rows)
    if bx.device.type != "cuda":
        raise ValueError(f"no K7 kernel for device {bx.device}")
    from nbodysim_tpu_torch.kernels._build import check, f32_args, library

    device = bx.device
    bx, by, bz, bm = f32_args(device, bx, by, bz, bm)
    if bx.dim() != 4 or any(a.shape != bx.shape for a in (by, bz, bm)):
        raise ValueError(
            f"3D bucket grids must share one [rows, res, res, K] shape, got "
            f"{[tuple(a.shape) for a in (bx, by, bz, bm)]}")
    rows_w, res, res_z, cap = bx.shape
    if res_z != res:
        raise ValueError(f"grid {tuple(bx.shape)}: y and z sizes differ")
    if rows_w != center_rows + 2 * rr:
        raise ValueError(
            f"{rows_w} grid x-slabs, expected center_rows + 2rr = "
            f"{center_rows + 2 * rr}")
    if not (1 <= cap <= 16 and 0 <= rr <= 4):
        raise ValueError(f"K7 takes 1 <= K <= 16 slots and rr <= 4, got "
                         f"K={cap}, rr={rr}")
    accx = torch.empty((center_rows, res, res, cap), dtype=torch.float32,
                       device=device)
    accy, accz = torch.empty_like(accx), torch.empty_like(accx)
    if accx.numel() == 0:
        return accx, accy, accz
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.nb_bucket_stencil3(
            bx.data_ptr(), by.data_ptr(), bz.data_ptr(), bm.data_ptr(),
            counts.data_ptr(), accx.data_ptr(), accy.data_ptr(),
            accz.data_ptr(), center_rows, res, cap, rr, float(eps_sq), stream)
    check(status, "nb_bucket_stencil3")
    bucket_stencil3.launches += 1
    return accx, accy, accz


bucket_stencil3.launches = 0
