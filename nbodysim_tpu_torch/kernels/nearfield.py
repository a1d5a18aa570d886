"""K3: the tree code's near field on a dense bucket grid — CUDA kernel,
wrapper, plain version.

Replaces the TPU kernel `nbodysim_tpu/kernels/nearfield.py:_nearfield_kernel`
(wrappers `bucket_stencil_pallas_flat`, `bucket_stencil_pallas`). The kernel
is `csrc/nearfield.cu`; its header says what bounds it on the H100 and how
its design answers that. The TPU kernel's slot-major `[K, F]` layout exists
for its DMA alignment; both functions here take the bucket grid as the tree
code builds it.

  * `bucket_stencil` — the wrapper. On a CUDA tensor it launches the kernel
    (or raises); on a CPU tensor, and only there, it runs the plain version.
    `bucket_stencil.launches` counts kernel launches.
  * `bucket_stencil_plain` — the same function in plain torch (the port of
    `physics/barneshut._bucket_stencil`): for each of the (2rr+1)^2 static
    neighbour offsets, a broadcast K x K pair block, chunked over rows. The
    CPU path, and the reference the kernel is held to on the card.

Contract of both: bx, by, bm are [center_rows + 2rr, res, K] (K slots per
cell, empty slots with mass 0); target cells are the rows [rr, rr +
center_rows); the rr halo rows on each side are sources only. Returns
(accx, accy), [center_rows, res, K] each, unscaled by G.
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


def bucket_stencil(bx, by, bm, *, rr: int, eps_sq: float, center_rows: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Near field per slot (see module). CUDA tensor: K3; CPU: plain."""
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
    if bx.numel() >= 2 ** 31:
        raise ValueError("K3 indexes rows with 32-bit ints: grid too large")
    accx = torch.empty((center_rows, res, cap), dtype=torch.float32,
                       device=device)
    accy = torch.empty_like(accx)
    if accx.numel() == 0:
        return accx, accy
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.nb_bucket_stencil(
            bx.data_ptr(), by.data_ptr(), bm.data_ptr(), accx.data_ptr(),
            accy.data_ptr(), center_rows, res, cap, rr, float(eps_sq), stream)
    check(status, "nb_bucket_stencil")
    bucket_stencil.launches += 1
    return accx, accy


bucket_stencil.launches = 0
