"""K1: exact softened all-pairs gravity — CUDA kernel, wrapper, plain version.

Replaces the TPU kernel `nbodysim_tpu/kernels/allpairs.py:_allpairs_kernel`
(wrapper `allpairs_accelerations`). The kernel is `csrc/allpairs.cu`; its
header says what bounds it on the H100 and how its design answers that.

  * `allpairs_accelerations` — the wrapper. On a CUDA tensor it launches the
    kernel (or raises); on a CPU tensor, and only there, it runs the plain
    version. `allpairs_accelerations.launches` counts kernel launches.
  * `allpairs_accelerations_plain` — the same function in plain torch,
    blocked over targets and sources (elementwise multiply-and-sum, no
    matmul, so TF32 can never touch it). The CPU path, and the reference the
    kernel is held to on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from nbodysim_tpu_torch.core.blocking import pairwise_blocked


def _pairwise_acc_block(tgt_pos, src_pos, src_mass, eps_sq, g_const):
    """Accelerations on a tile of targets from a tile of sources. [T, D].

    Coincident pairs (d == 0) contribute nothing, which also removes
    self-interaction (reference Quadtree.hpp:124 `if (d_sq > 0)`).
    """
    d = src_pos[None, :, :] - tgt_pos[:, None, :]          # [T, S, D]
    d_sq = (d * d).sum(-1)                                  # [T, S]
    inv = torch.rsqrt(d_sq + eps_sq)
    w = src_mass[None, :] * (inv * inv * inv)
    w = torch.where(d_sq > 0.0, w, torch.zeros_like(w))
    return g_const * (w[:, :, None] * d).sum(1)


def allpairs_accelerations_plain(
    pos: torch.Tensor,
    mass: Optional[torch.Tensor],
    *,
    eps_sq: float,
    g_const: float = 1.0,
    src_pos: Optional[torch.Tensor] = None,
    src_mass: Optional[torch.Tensor] = None,
    block_size: int = 2048,
) -> torch.Tensor:
    """Plain-torch all-pairs accelerations, [N, D]; temps <= [bs, 2 bs, D]."""
    if src_pos is None:
        src_pos, src_mass = pos, mass
    elif src_mass is None:
        raise ValueError("src_mass must accompany src_pos")

    def kernel(tgt, src):
        return (_pairwise_acc_block(tgt[0], src[0], src[1], eps_sq, g_const),)

    (acc,) = pairwise_blocked(
        kernel, (pos,), (src_pos, src_mass), out_dims=((pos.shape[1],),),
        dtype=pos.dtype, bs_t=block_size, bs_s=2 * block_size)
    return acc


def allpairs_accelerations(
    pos: torch.Tensor,
    mass: Optional[torch.Tensor],
    *,
    eps_sq: float,
    g_const: float = 1.0,
    src_pos: Optional[torch.Tensor] = None,
    src_mass: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """All-pairs softened accelerations on `pos`, [N, D] f32.

    With `src_pos`/`src_mass`, accelerations due to those sources only (the
    building block of a multi-device ring); the positional `mass` is then
    unused and may be None.
    """
    if src_pos is None:
        src_pos, src_mass = pos, mass
    elif src_mass is None:
        raise ValueError("src_mass must accompany src_pos")
    if pos.device.type == "cpu":
        return allpairs_accelerations_plain(
            pos, mass, eps_sq=eps_sq, g_const=g_const,
            src_pos=src_pos, src_mass=src_mass)
    if pos.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {pos.device}")
    from nbodysim_tpu_torch.kernels._build import check, f32_args, library

    device = pos.device
    tgt, src, src_m = f32_args(device, pos, src_pos, src_mass)
    n, dim = tgt.shape
    s = src.shape[0]
    if dim not in (2, 3) or src.shape != (s, dim) or src_m.shape != (s,):
        raise ValueError(
            f"shapes {tuple(tgt.shape)}, {tuple(src.shape)}, "
            f"{tuple(src_m.shape)}: expected [N, D], [S, D], [S], D in 2, 3")
    if max(n, s) * dim >= 2 ** 31:
        raise ValueError("K1 indexes with 32-bit ints: N * D must be < 2^31")
    if n == 0 or s == 0:
        return torch.zeros_like(tgt)
    out = torch.empty_like(tgt)
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.nb_allpairs_accelerations(
            tgt.data_ptr(), src.data_ptr(), src_m.data_ptr(), out.data_ptr(),
            n, s, dim, float(eps_sq), float(g_const), stream)
    check(status, "nb_allpairs_accelerations")
    allpairs_accelerations.launches += 1
    return out


allpairs_accelerations.launches = 0
