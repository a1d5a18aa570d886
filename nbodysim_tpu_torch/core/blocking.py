"""Shared double-blocked pairwise mapping (port of
`nbodysim_tpu.core.blocking`).

The plain torch versions of the O(T x S) pairwise stages (forces, potential,
collision narrow phase) run over [bs_t, bs_s] tiles of targets and sources,
so no temporary grows past [bs_t, bs_s, D] however large N is. Eager torch
needs no padding: the ragged last block is just a shorter slice.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch


def pairwise_blocked(
    kernel: Callable,
    tgt_arrays: Sequence[torch.Tensor],
    src_arrays: Sequence[torch.Tensor],
    out_dims: Sequence[Tuple[int, ...]],
    dtype,
    bs_t: int = 1024,
    bs_s: int = 4096,
) -> Tuple[torch.Tensor, ...]:
    """Run `kernel` over all (target-block, source-chunk) pairs.

    kernel(tgt_blk_tuple, src_blk_tuple) -> tuple of tensors, each
    [t_blk, *out_dims[i]]: the partial sum over this source chunk. Partials
    are summed over source chunks in order and concatenated over target
    blocks. Returns a tuple of tensors [T, *out_dims[i]].
    """
    t = tgt_arrays[0].shape[0]
    s = src_arrays[0].shape[0]
    device = tgt_arrays[0].device
    outs = tuple(
        torch.empty((t,) + tuple(d), dtype=dtype, device=device)
        for d in out_dims)
    for i in range(0, t, bs_t):
        tgt = tuple(a[i:i + bs_t] for a in tgt_arrays)
        acc = None
        for j in range(0, s, bs_s):
            src = tuple(a[j:j + bs_s] for a in src_arrays)
            partials = kernel(tgt, src)
            acc = partials if acc is None else tuple(
                c + p for c, p in zip(acc, partials))
        for o, a in zip(outs, acc):
            o[i:i + bs_t] = a
    return outs
