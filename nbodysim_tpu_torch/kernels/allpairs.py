"""K1 and K4: exact softened all-pairs gravity — CUDA kernel, wrappers,
plain version.

Replaces the TPU kernels `nbodysim_tpu/kernels/allpairs.py:_allpairs_kernel`
(wrapper `allpairs_accelerations`) and `_allpairs_wide_kernel` (wrapper
`allpairs_accelerations_wide`). Both are one CUDA kernel, `csrc/allpairs.cu`;
its header says what bounds it on the H100 and how its design answers that.
The TPU's wide kernel existed only for its transposed `[D, N]` IO, a TPU
tiling workaround; on the card K4 is a launch of the same kernel.

  * `allpairs_accelerations` — K1's wrapper. On a CUDA tensor it launches the
    kernel (or raises); on a CPU tensor, and only there, it runs the plain
    version. `allpairs_accelerations.launches` counts kernel launches.
  * `allpairs_accelerations_wide` — K4's wrapper: many targets, few
    separate sources (the tree code's bulk <- outliers coupling). Its own
    count, `allpairs_accelerations_wide.launches`.
  * `allpairs_accelerations_plain` — the same function in plain torch,
    blocked over targets and sources (elementwise multiply-and-sum, no
    matmul, so TF32 can never touch it). The CPU path, and the reference the
    kernel is held to on the card.
  * `packed_sources` — the sources as the kernel stages them: float4
    (x, y, z, G m) rows, padded to whole tiles with inert sources; plain
    torch, for the tests that hold the padding inert.
  * `allpairs_potential` — the exact potential's pair sum
    sum_{i != j, d > 0} m_i m_j / sqrt(d^2 + eps^2) (a kernel that the port
    adds beside K1 in the same source; no TPU counterpart). On a CUDA
    tensor it launches the kernel (or raises), on a CPU tensor it runs the
    plain version, `allpairs_potential_plain`. Its own count,
    `allpairs_potential.launches`.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from nbodysim_tpu_torch.core.blocking import pairwise_blocked


TILE = 512           # sources a pass of the kernel stages (kTile)
PAD_POS = 1e18       # where its padding sources sit (kPadPos), mass 0
WARP = 32            # a block covers WARP * k targets, k targets a thread


def packed_sources(src_pos: torch.Tensor, src_mass: torch.Tensor,
                   g_const: float = 1.0, tile: int = TILE) -> torch.Tensor:
    """[S', 4] rows (x, y, z, G m), z = 0 in 2D, S' = S rounded up to a
    whole `tile`; the padding rows are (PAD_POS, PAD_POS, PAD_POS, 0), whose
    terms are exactly 0 (d^2 ~ 1e36, r^-3 underflows), also at eps = 0."""
    s, dim = src_pos.shape
    packed = torch.full((-(-s // tile) * tile, 4), PAD_POS,
                        dtype=src_pos.dtype, device=src_pos.device)
    packed[:, 3] = 0.0
    packed[:s, :dim] = src_pos
    if dim == 2:
        packed[:s, 2] = 0.0
    packed[:s, 3] = g_const * src_mass
    return packed


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
    out = _launch(pos, src_pos, src_mass, eps_sq, g_const, "K1")
    allpairs_accelerations.launches += 1
    return out


allpairs_accelerations.launches = 0


def allpairs_accelerations_wide(
    pos: torch.Tensor,
    src_pos: torch.Tensor,
    src_mass: torch.Tensor,
    *,
    eps_sq: float,
    g_const: float = 1.0,
) -> torch.Tensor:
    """Accelerations on MANY targets `pos` [N, D] from FEW sources
    `src_pos` [S, D] / `src_mass` [S] (K4). The same function as
    `allpairs_accelerations` with separate sources; on a CUDA tensor it
    launches the kernel (or raises), on a CPU tensor it runs the plain
    version."""
    if pos.device.type == "cpu":
        return allpairs_accelerations_plain(
            pos, None, eps_sq=eps_sq, g_const=g_const,
            src_pos=src_pos, src_mass=src_mass)
    out = _launch(pos, src_pos, src_mass, eps_sq, g_const, "K4")
    allpairs_accelerations_wide.launches += 1
    return out


allpairs_accelerations_wide.launches = 0


def allpairs_potential_plain(
    pos: torch.Tensor,
    mass: torch.Tensor,
    *,
    eps_sq: float,
    src_pos: Optional[torch.Tensor] = None,
    src_mass: Optional[torch.Tensor] = None,
    block_size: int = 2048,
) -> torch.Tensor:
    """sum_{i in pos, j in src, d != 0} m_i m_j / sqrt(d^2 + eps^2) in plain
    torch, blocked as `allpairs_accelerations_plain`; the sources default
    to the targets. A 0-dim tensor."""
    if src_pos is None:
        src_pos, src_mass = pos, mass

    def kernel(t, s):
        tp, tm = t
        sp, sm = s
        d = sp[None, :, :] - tp[:, None, :]
        d_sq = (d * d).sum(-1)
        pair = tm[:, None] * sm[None, :] * torch.rsqrt(d_sq + eps_sq)
        return (torch.where(d_sq > 0.0, pair, 0.0).sum(1),)

    (per_target,) = pairwise_blocked(
        kernel, (pos, mass), (src_pos, src_mass), out_dims=((),),
        dtype=pos.dtype, bs_t=block_size, bs_s=2 * block_size)
    return per_target.sum()


def allpairs_potential(
    pos: torch.Tensor,
    mass: torch.Tensor,
    *,
    eps_sq: float,
    block_size: int = 2048,
) -> torch.Tensor:
    """sum_{i != j, d_ij > 0} m_i m_j / sqrt(d_ij^2 + eps^2) over `pos`
    [N, D], a 0-dim f32 tensor. On a CUDA tensor it launches the kernel (or
    raises); on a CPU tensor it runs the plain version, blocked by
    `block_size` (which the kernel does not read)."""
    if pos.device.type == "cpu":
        return allpairs_potential_plain(pos, mass, eps_sq=eps_sq,
                                        block_size=block_size)
    out = _launch_potential(pos, mass, eps_sq)
    allpairs_potential.launches += 1
    return out


allpairs_potential.launches = 0


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def targets_per_thread(n: int, device: torch.device) -> int:
    """k for a launch over N targets: 4 where the launch still has >= 3
    blocks of 128 targets per SM, or is split over its sources anyway;
    else 2, whose 64-target blocks spread N=25k evenly over the SMs (391
    blocks, against 196 at k = 4, which left SMs with 1 block beside SMs
    with 2). k = 4 halves the shared-memory loads per pair."""
    sms = _sm_count(device)
    if -(-n // (WARP * 2)) < sms or -(-n // (WARP * 4)) >= 3 * sms:
        return 4
    return 2


def source_splits(n: int, s: int, device: torch.device,
                  block_targets: int) -> int:
    """Source chunks for a launch of N targets x S sources: 1 while the
    card has at least one block of `block_targets` per SM; below that,
    enough chunks for ~8 blocks per SM, each chunk at least 1024 sources."""
    blocks = -(-n // block_targets)
    sms = _sm_count(device)
    if blocks >= sms:
        return 1
    return max(1, min(8 * sms // blocks, s // 1024))


def _launch(pos, src_pos, src_mass, eps_sq, g_const, name,
            splits: Optional[int] = None,
            k: Optional[int] = None) -> torch.Tensor:
    """One launch of csrc/allpairs.cu on CUDA tensors (`splits` source
    chunks, default `source_splits`; `k` targets a thread, 2 or 4, default
    `targets_per_thread`). Counts nothing: the wrappers do."""
    if pos.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {pos.device}")
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
        raise ValueError(
            f"{name} indexes with 32-bit ints: N * D must be < 2^31")
    if n == 0 or s == 0:
        return torch.zeros_like(tgt)
    if k is None:
        k = targets_per_thread(n, device)
    if splits is None:
        splits = source_splits(n, s, device, WARP * k)
    out = torch.empty_like(tgt)
    scratch = (torch.empty((splits, n, dim), dtype=torch.float32,
                           device=device) if splits > 1 else None)
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.nb_allpairs_accelerations(
            tgt.data_ptr(), src.data_ptr(), src_m.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), n, s, dim,
            splits, k, float(eps_sq), float(g_const), stream)
    check(status, "nb_allpairs_accelerations")
    return out


def _launch_potential(pos, mass, eps_sq, splits: Optional[int] = None,
                      k: Optional[int] = None) -> torch.Tensor:
    """One launch of csrc/allpairs.cu's potential kernel and its sum of the
    blocks' partials, on CUDA tensors (`splits`, `k` as in `_launch`).
    Counts nothing: the wrapper does."""
    if pos.device.type != "cuda":
        raise ValueError(f"no potential kernel for device {pos.device}")
    from nbodysim_tpu_torch.kernels._build import check, f32_args, library

    device = pos.device
    p, m = f32_args(device, pos, mass)
    n, dim = p.shape
    if dim not in (2, 3) or m.shape != (n,):
        raise ValueError(
            f"shapes {tuple(p.shape)}, {tuple(m.shape)}: expected [N, D], "
            f"[N], D in 2, 3")
    if n * dim >= 2 ** 31:
        raise ValueError(
            "the potential kernel indexes with 32-bit ints: N * D must be "
            "< 2^31")
    if n == 0:
        return torch.zeros((), dtype=torch.float32, device=device)
    if k is None:
        k = targets_per_thread(n, device)
    if splits is None:
        splits = source_splits(n, n, device, WARP * k)
    partial = torch.empty(-(-n // (WARP * k)) * splits, dtype=torch.float64,
                          device=device)
    out = torch.empty((), dtype=torch.float32, device=device)
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.nb_allpairs_potential(
            p.data_ptr(), m.data_ptr(), partial.data_ptr(), out.data_ptr(),
            n, dim, splits, k, float(eps_sq), stream)
    check(status, "nb_allpairs_potential")
    return out
