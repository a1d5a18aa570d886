"""K6: dense stage of the lex-sorted block collision pass — CUDA kernel,
wrapper, plain version.

Replaces the TPU kernel
`nbodysim_tpu/kernels/collide_block.py:_block_collide_kernel` (wrapper
`block_collision_deltas`). The kernel is `csrc/collide_block.cu`; its header
says what bounds it on the H100 and how its design answers that.

Both versions take the block pass's sorted, padded particle planes and the
per-block window bounds that `physics/collisions._block_structure` finds:

  planes  [2D + 3, n_tot] f32: pos (D rows), vel (D), mass (0 outside
          covered blocks), radius (-1e9 on padding), ok (1.0 where covered);
  keys    [D, n_tot] int32: sorted cell keys (sentinel on bigs and padding);
  w_lo, w_hi  [nb, n_off] int32: each block's window of sorted rows per
          neighbour offset (n_off = 3 in 2D, 9 in 3D; `lead_offsets`).

and return target-side (dpos, dvel), [nb_loc * t_blk, D] each, for the
blocks blk0 .. blk0 + nb_loc (a band of them, for the multi-GPU pass).

  * `block_collision_deltas` — the wrapper. On a CUDA tensor it launches the
    kernel (or raises); on a CPU tensor, and only there, it runs the plain
    version. `block_collision_deltas.launches` counts kernel launches.
  * `block_collision_deltas_plain` — the JAX package's XLA dense stage: per
    chunk of blocks, tile-aligned window gathers of fixed length
    w_len = 2 t_blk + 512 from `start_row`, the `in_span` mask, and dense
    masked [CB, T, W] pair blocks through `_pair_deltas`. The kernel walks
    each target's run of rows inside the windows' true spans instead; for
    the covered blocks (the only ones whose targets are ok) the two are the
    same pairs.
  * `block_collision_walks` — the kernel's counting instantiation, for
    measurement only (it adds nothing to `launches`): the rows its threads
    walk, with and without the idle lanes of a warp, the rows it stages and
    the rows its lanes read directly.
  * `k6_needed_pairs` — the pairs that pass the masks on given data (the
    work a bound counts), by lex binary search (`lex_searchsorted`, which
    the block structure also uses for its windows).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from nbodysim_tpu_torch.kernels.collide import _pair_deltas

ROW_ALIGN = 256   # start_row alignment of the fixed-length windows


def lead_offsets(dim: int) -> List[Tuple[int, ...]]:
    """Lead-axis neighbour offsets, one window each: (dx,) in 2D, (dx, dy)
    in 3D, dx outer."""
    if dim == 2:
        return [(dx,) for dx in (-1, 0, 1)]
    return [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]


def window_length(t_blk: int) -> int:
    """Rows of the fixed-length window a block's span must fit to count as
    covered."""
    return 2 * t_blk + 2 * ROW_ALIGN


def window_start(w_lo: torch.Tensor, n_tot: int, t_blk: int) -> torch.Tensor:
    """First row of each fixed-length window: w_lo rounded down to the
    alignment, clipped so the window stays inside the array."""
    return torch.clamp((w_lo // ROW_ALIGN) * ROW_ALIGN, 0,
                       n_tot - window_length(t_blk))


def lex_searchsorted(cols, qs, right: bool, n: int) -> torch.Tensor:
    """Vectorised binary search over lex-sorted int32 columns `cols` ([n]
    each) for the query tuples `qs` (arrays of any one shape): the left (or
    right) insertion index, int32. log2(n) rounds of one small gather each;
    the queries are per block, thousands, not millions."""
    lo = torch.zeros(qs[0].shape, dtype=torch.int64, device=qs[0].device)
    hi = torch.full(qs[0].shape, n, dtype=torch.int64, device=qs[0].device)
    for _ in range(max(1, n - 1).bit_length() + 1):
        mid = (lo + hi) >> 1
        midc = torch.clamp(mid, max=n - 1)
        ks = [c[midc] for c in cols]
        # lex compare ks < qs (left) / ks <= qs (right), folded from the
        # last key outward.
        go = ks[-1] <= qs[-1] if right else ks[-1] < qs[-1]
        for k, q in zip(reversed(ks[:-1]), reversed(qs[:-1])):
            go = (k < q) | ((k == q) & go)
        go = go & (lo < hi)
        lo, hi = torch.where(go, mid + 1, lo), torch.where(go, hi, mid)
    return lo.to(torch.int32)


def k6_needed_pairs(planes: torch.Tensor, keys: torch.Tensor) -> float:
    """Pairs that K6's masks let through on this data (a bound's work):
    keys, both rows `ok`, not the same row. Per ok target, the ok rows of
    its 3^D neighbouring cells: one lex range of the sorted keys per lead
    offset, the trailing key within +-1. Equals a count of the masks over
    the windows for the covered blocks of a block structure whose keys do
    not wrap."""
    dim, n_tot = keys.shape
    ok = planes[-1] > 0
    cum = F.pad(torch.cumsum(ok.to(torch.int64), 0), (1, 0))
    kt = keys[:, ok]
    offs = torch.tensor(lead_offsets(dim), dtype=torch.int32,
                        device=keys.device)                   # [n_off, D-1]
    lead = [kt[a][:, None] + offs[None, :, a] for a in range(dim - 1)]
    tail = kt[dim - 1][:, None].expand(-1, offs.shape[0])
    lo = lex_searchsorted(list(keys), lead + [tail - 1], False, n_tot)
    hi = lex_searchsorted(list(keys), lead + [tail + 1], True, n_tot)
    return float((cum[hi.long()] - cum[lo.long()]).sum() - kt.shape[1])


def _check(planes, keys, w_lo, w_hi, t_blk, blk0, nb_loc):
    dim = keys.shape[0]
    n_tot = planes.shape[1]
    nb = n_tot // t_blk
    if (dim not in (2, 3) or planes.shape != (2 * dim + 3, n_tot)
            or keys.shape != (dim, n_tot) or n_tot % t_blk
            or t_blk % ROW_ALIGN
            or w_lo.shape != (nb, len(lead_offsets(dim)))
            or w_hi.shape != w_lo.shape):
        raise ValueError(
            f"planes {tuple(planes.shape)}, keys {tuple(keys.shape)}, "
            f"w_lo {tuple(w_lo.shape)}, w_hi {tuple(w_hi.shape)}, t_blk "
            f"{t_blk}: expected [2D+3, n_tot], [D, n_tot], [n_tot/T, n_off] "
            f"x2, T a multiple of {ROW_ALIGN}")
    if nb_loc is None:
        nb_loc = nb - blk0
    if blk0 < 0 or nb_loc <= 0 or blk0 + nb_loc > nb:
        raise ValueError(f"blocks {blk0}..{blk0 + nb_loc} outside 0..{nb}")
    return dim, n_tot, nb_loc


def block_collision_deltas_plain(
    planes: torch.Tensor,
    keys: torch.Tensor,
    w_lo: torch.Tensor,
    w_hi: torch.Tensor,
    *,
    t_blk: int,
    impulse: float,
    blk0: int = 0,
    nb_loc: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch K6 (see the module docstring); chunks of blocks keep the
    [CB, T, W] pair temps near 2^25 elements."""
    dim, n_tot, nb_loc = _check(planes, keys, w_lo, w_hi, t_blk, blk0,
                                nb_loc)
    device = planes.device
    w_len = window_length(t_blk)
    offs = lead_offsets(dim)
    cb = max(1, (1 << 25) // (t_blk * w_len))
    while nb_loc % cb:
        cb -= 1
    win = torch.arange(w_len, dtype=torch.int32, device=device)
    tcol = torch.arange(t_blk, dtype=torch.int32, device=device)
    dp_out, dv_out = [], []
    for c0 in range(blk0, blk0 + nb_loc, cb):
        lo, hi = w_lo[c0:c0 + cb], w_hi[c0:c0 + cb]            # [CB, n_off]
        src_rows = (window_start(lo, n_tot, t_blk)[:, :, None]
                    + win[None, None, :])                       # [CB, off, W]
        in_span = (src_rows >= lo[:, :, None]) & (src_rows < hi[:, :, None])
        tgt_rows = (torch.arange(c0, c0 + cb, dtype=torch.int32,
                                 device=device)[:, None] * t_blk
                    + tcol[None, :])                            # [CB, T]
        tgt = planes[:, tgt_rows.long()]                        # [F, CB, T]
        tkey = keys[:, tgt_rows.long()]
        src = planes[:, src_rows.long()]                        # [F, CB, off, W]
        skey = keys[:, src_rows.long()]
        tp, tv = tgt[:dim], tgt[dim:2 * dim]
        tm, tr, tok = tgt[2 * dim], tgt[2 * dim + 1], tgt[2 * dim + 2] > 0
        acc_dp = torch.zeros(tm.shape + (dim,), dtype=planes.dtype,
                             device=device)
        acc_dv = torch.zeros_like(acc_dp)
        for o, off in enumerate(offs):
            s = src[:, :, o]                                    # [F, CB, W]
            sk = skey[:, :, o]
            # [CB, T, W] masks: span, lead keys = target keys + offset,
            # trailing key within +-1, both ok, no self.
            valid = in_span[:, o][:, None, :]
            for a in range(dim - 1):
                valid = valid & (sk[a][:, None, :]
                                 == tkey[a][:, :, None] + off[a])
            dtrail = sk[dim - 1][:, None, :] - tkey[dim - 1][:, :, None]
            valid = valid & (dtrail.abs() <= 1)
            valid = valid & (src_rows[:, o][:, None, :]
                             != tgt_rows[:, :, None])
            valid = valid & (s[2 * dim + 2][:, None, :] > 0) & tok[:, :, None]
            d = torch.stack([s[a][:, None, :] - tp[a][:, :, None]
                             for a in range(dim)], -1)
            v = torch.stack([s[dim + a][:, None, :] - tv[a][:, :, None]
                             for a in range(dim)], -1)
            sm = s[2 * dim][:, None, :]
            msum = tm[:, :, None] + sm
            valid = valid & (msum > 0.0)
            w1 = torch.where(valid, sm / torch.where(msum > 0.0, msum, 1.0),
                             0.0)
            r = tr[:, :, None] + s[2 * dim + 1][:, None, :]
            dp, dv = _pair_deltas(d, v, w1, r, valid, impulse)
            acc_dp = acc_dp + dp.sum(2)
            acc_dv = acc_dv + dv.sum(2)
        dp_out.append(acc_dp.reshape(-1, dim))
        dv_out.append(acc_dv.reshape(-1, dim))
    return torch.cat(dp_out), torch.cat(dv_out)


def _launch(planes, keys, w_lo, w_hi, t_blk, impulse, blk0, nb_loc,
            counts=None):
    """Checks the operands and launches K6 (with `counts`, a [7] int64 CUDA
    tensor, its counting instantiation); returns (dpos, dvel)."""
    from nbodysim_tpu_torch.kernels._build import check, f32_args, library

    device = planes.device
    dim, n_tot, nb_loc = _check(planes, keys, w_lo, w_hi, t_blk, blk0,
                                nb_loc)
    if planes.numel() >= 2 ** 31:
        raise ValueError("K6 indexes rows with 32-bit ints: (2D+3) * n_tot "
                         "must be < 2^31")
    (planes,) = f32_args(device, planes)
    for t in (keys, w_lo, w_hi):
        if t.device != device:
            raise ValueError(f"tensor on {t.device}, expected {device}")
    keys, w_lo, w_hi = (t.to(torch.int32).contiguous()
                        for t in (keys, w_lo, w_hi))
    n_loc = nb_loc * t_blk
    out = torch.empty((2, n_loc, dim), dtype=torch.float32, device=device)
    lib = library()
    args = (planes.data_ptr(), keys.data_ptr(), w_lo.data_ptr(),
            w_hi.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), n_tot,
            dim, t_blk, blk0 * t_blk, n_loc, float(impulse))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if counts is None:
            status = lib.nb_block_collide(*args, stream)
        else:
            status = lib.nb_block_collide_count(*args, counts.data_ptr(),
                                                stream)
    check(status, "nb_block_collide")
    return out[0], out[1]


def block_collision_deltas(
    planes: torch.Tensor,
    keys: torch.Tensor,
    w_lo: torch.Tensor,
    w_hi: torch.Tensor,
    *,
    t_blk: int,
    impulse: float,
    blk0: int = 0,
    nb_loc: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: dense-stage deltas of the block pass (see the module docstring).
    On a CUDA tensor it launches the kernel (or raises); on a CPU tensor it
    runs the plain version."""
    if planes.device.type == "cpu":
        return block_collision_deltas_plain(
            planes, keys, w_lo, w_hi, t_blk=t_blk, impulse=impulse,
            blk0=blk0, nb_loc=nb_loc)
    if planes.device.type != "cuda":
        raise ValueError(f"no K6 kernel for device {planes.device}")
    out = _launch(planes, keys, w_lo, w_hi, t_blk, impulse, blk0, nb_loc)
    block_collision_deltas.launches += 1
    return out


block_collision_deltas.launches = 0


def block_collision_walks(
    planes: torch.Tensor,
    keys: torch.Tensor,
    w_lo: torch.Tensor,
    w_hi: torch.Tensor,
    *,
    t_blk: int,
    impulse: float,
) -> dict:
    """K6's counting instantiation on a CUDA tensor (one launch over every
    block, not counted in `block_collision_deltas.launches`): the rows its
    threads walk ("walked", the lane-pairs issued), the same with every lane
    of a warp counted to the warp's longest walk in each tile or run
    ("warp_slots"), the rows staged into shared memory ("staged"), the pairs
    that pass the masks and overlap, which take the resolve path
    ("overlapping"), the SM clock cycles its CTAs spent finding their runs
    and walking them, summed over the CTAs ("cycles_runs", "cycles_walk"),
    and the walked rows that lanes of warps with short runs read straight
    from the planes, unstaged ("direct")."""
    if planes.device.type != "cuda":
        raise ValueError("block_collision_walks counts on the card only")
    counts = torch.zeros(7, dtype=torch.int64, device=planes.device)
    _launch(planes, keys, w_lo, w_hi, t_blk, impulse, 0, None,
            counts=counts)
    return dict(zip(("walked", "warp_slots", "staged", "overlapping",
                     "cycles_runs", "cycles_walk", "direct"),
                    (int(c) for c in counts.tolist())))
