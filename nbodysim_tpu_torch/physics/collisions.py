"""Collision detection and response (port of
`nbodysim_tpu.physics.collisions`).

Reference semantics (Simulation.hpp:216-346) resolved as one Jacobi pass:
every particle sums its own side of each overlapping pair's correction and
all corrections apply at once (see the JAX module's docstring for the
derivation). The per-pair math is antisymmetric, so momentum is conserved.

Broad phases, as `resolve_collisions` dispatches them:

  * 'dense' (what 'auto' picks while N <= DENSE_THRESHOLD): every pair; the
    narrow phase is K2 (`kernels/collide.allpairs_collision_deltas`).
  * 'bucket' ('auto' above the threshold in 2D): a dense [res, res, K] grid
    of span-scaled cells and a 9-cell shift stencil, plain torch as in the
    JAX package (XLA there, outside any Pallas kernel).
  * 'block' ('auto' in 3D, and in 2D when the bucket grid would overflow
    its residual): particles lex-sorted by radius-scaled cells, each block
    of T sorted targets against 3 (2D) / 9 (3D) contiguous source windows;
    the dense stage is K6 (`kernels/collide_block.block_collision_deltas`).

  * 'hash' (never picked by 'auto'; only when set explicitly): particles
    sorted by a multiplicative hash of radius-scaled cells, each scanning a
    fixed window of the 9 (2D) / 27 (3D) neighbour cells' hash segments,
    located by binary search (`_grid_pass`, `_cell_hash`); plain torch, as
    the JAX package computes it in XLA, in chunks of `_WINDOW_CHUNK` rows.

The large-N passes extract the (at most 64) big bodies from the grid and
couple them to everything, and send particles the grid could not cover to a
capped exact residual (`_exact_corrections`); every such rectangle of
targets against sources is K5 (`kernels/collide.rect_pair_deltas`). On a
CUDA tensor, with collision_backend 'auto' or 'cuda', the kernels run;
collision_backend 'torch' runs their plain versions on any device.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.core.blocking import sorted_first_occurrence
from nbodysim_tpu_torch.core.state import ParticleState
from nbodysim_tpu_torch.diagnostics import profiling
from nbodysim_tpu_torch.kernels.collide import (
    _pair_deltas,
    allpairs_collision_deltas,
    collision_deltas_plain,
    rect_pair_deltas,
    rect_pair_deltas_plain,
)
from nbodysim_tpu_torch.kernels.collide_block import (
    block_collision_deltas,
    block_collision_deltas_plain,
    lead_offsets,
    lex_searchsorted,
    window_length,
    window_start,
)

DENSE_THRESHOLD = 65536

# Capacity of the exact residual for particles a broad phase cannot cover.
_OVERFLOW_CAP = 16384

# Sentinel key for rows excluded from the lex grid (bigs; padding sorts after
# them at sentinel + 1): sorts past every real cell, and sentinel + any
# neighbour offset never equals a real cell coordinate.
_CELL_SENTINEL = 2 ** 31 - 1 - 4

_BIG_K = 64   # at most this many bodies leave the grid as big bodies

Fields = Tuple[torch.Tensor, ...]   # (pos, vel, mass, radius, cell)


def resolve_collision_backend(config: SimConfig, device) -> str:
    """"cuda" (the kernels) or "torch" (their plain versions) on `device`;
    an explicit "cuda" on a CPU device raises."""
    device = torch.device(device)
    backend = config.collision_backend
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(
            f"collision_backend='cuda' needs a CUDA tensor, got one on "
            f"{device}")
    return backend


def _use_kernels(state: ParticleState, config: SimConfig) -> bool:
    return resolve_collision_backend(config, state.device) == "cuda"


def _dense_pass(state: ParticleState, config: SimConfig) -> ParticleState:
    """Exact O(N^2) masked Jacobi collision pass: K2 on the card, the
    blocked plain version otherwise."""
    pos, vel = state.pos, state.vel
    if _use_kernels(state, config):
        dp, dv = allpairs_collision_deltas(
            pos, vel, state.mass, state.radius,
            impulse=config.collision_impulse)
    else:
        dp, dv = collision_deltas_plain(
            pos, vel, state.mass, state.radius,
            impulse=config.collision_impulse)
    return state.replace(pos=pos + dp, vel=vel + dv)


# ---------------------------------------------------------------------------
# Shared by the bucket and block passes
# ---------------------------------------------------------------------------

def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k`: the k largest values and their indices, ties to the
    lower index (a stable descending sort)."""
    values, idx = torch.sort(x, descending=True, stable=True)
    return values[:k], idx[:k]


class _Bigs(NamedTuple):
    """Big-body extraction: the cell size is floored at 2.05x the 65th
    largest radius, so at most 64 bodies (radius > cell/2) can overlap
    beyond the neighbouring cells; they leave the grid."""
    cell_size: torch.Tensor   # [] f32
    top_i: torch.Tensor       # [k] indices of the k <= 64 largest radii
    big_sel: torch.Tensor     # [k] which of them are big
    is_big: torch.Tensor      # [N] bool


def _extract_bigs(radius: torch.Tensor, floor: torch.Tensor) -> _Bigs:
    n = radius.shape[0]
    k_big = min(_BIG_K, n)
    top_r, top_i = _top_k(radius, min(k_big + 1, n))
    cell_size = torch.maximum(floor, 2.05 * top_r[min(k_big, n - 1)])
    big_sel = top_r[:k_big] > 0.5 * cell_size
    top_i = top_i[:k_big]
    is_big = torch.zeros(n, dtype=torch.bool, device=radius.device)
    is_big[top_i] = big_sel
    return _Bigs(cell_size, top_i, big_sel, is_big)


def _cheb_pair_deltas_blocked(tgt: Fields, src: Fields, dim: int,
                              impulse: float, max_cheb: Optional[int] = 1,
                              use_kernel: bool = False):
    """Exact pair deltas of `tgt` against `src` ((pos, vel, mass, radius,
    cell) tuples), masked to cell Chebyshev distance <= max_cheb (None: no
    cell mask); zero-mass rows are inert. K5 with `use_kernel` (on a CUDA
    tensor, at any size: the JAX package's size gate existed for its TPU
    kernel's source padding), else K5's plain version."""
    fn = rect_pair_deltas if use_kernel else rect_pair_deltas_plain
    return fn(tgt, src, dim=dim, impulse=impulse, max_cheb=max_cheb)


def _big_body_corrections(dpos_s, dvel_s, fields_s: Fields, big_s,
                          big_src: Fields, big_sel, top_sorted,
                          impulse: float, dim: int, use_kernel: bool):
    """Big bodies, exact and unmasked by cells (they reach across cells):
    everyone <- bigs, then bigs <- smalls (added at the bigs' sorted rows)."""
    pos_s, vel_s, mass_s, radius_s, cell_s = fields_s
    dp_b1, dv_b1 = _cheb_pair_deltas_blocked(
        fields_s, big_src, dim, impulse, max_cheb=None,
        use_kernel=use_kernel)
    dpos_s = dpos_s + dp_b1
    dvel_s = dvel_s + dv_b1
    small_src = (pos_s, vel_s, torch.where(big_s, 0.0, mass_s), radius_s,
                 cell_s)
    dp_b2, dv_b2 = _cheb_pair_deltas_blocked(
        big_src, small_src, dim, impulse, max_cheb=None,
        use_kernel=use_kernel)
    sel = big_sel[:, None]
    dpos_s = dpos_s.index_add(0, top_sorted, torch.where(sel, dp_b2, 0.0))
    dvel_s = dvel_s.index_add(0, top_sorted, torch.where(sel, dv_b2, 0.0))
    return dpos_s, dvel_s


class _Overflow(NamedTuple):
    """The residual's overflow set O, chosen over the whole sorted set."""
    idx: torch.Tensor        # [m_cap] sorted rows of O (stable order)
    valid: torch.Tensor      # [m_cap] the row is an overflow small
    src: Fields              # O's fields, mass 0 where not valid
    tgt_ok: torch.Tensor     # [N] sorted: the targets of pass (b)
    cover_src: Fields        # the sources of pass (c): covered rows only


def _overflow_set(fields_s: Fields, in_cover, big_s) -> _Overflow:
    """The first `_OVERFLOW_CAP` smalls the broad phase could not cover
    (stable order, as JAX's argsort), and what the residual's two passes
    take. The multi-device pass computes it on every rank the same way, so
    every rank drops the same pairs beyond the cap."""
    pos_s, vel_s, mass_s, radius_s, cell_s = fields_s
    n = pos_s.shape[0]
    m_cap = min(n, _OVERFLOW_CAP)
    keep = in_cover | big_s                        # not overflow-small
    o_idx = torch.argsort(keep.to(torch.int32), stable=True)[:m_cap]
    o_valid = ~keep[o_idx]
    o = (pos_s[o_idx], vel_s[o_idx],
         torch.where(o_valid, mass_s[o_idx], 0.0), radius_s[o_idx],
         cell_s[o_idx])
    sel_over = torch.zeros(n, dtype=torch.bool, device=pos_s.device)
    sel_over[o_idx] = o_valid
    cover_src = (pos_s, vel_s, torch.where(in_cover, mass_s, 0.0), radius_s,
                 cell_s)
    return _Overflow(o_idx, o_valid, o, ~big_s & (in_cover | sel_over),
                     cover_src)


def _residual_corrections(dpos_s, dvel_s, fields_s: Fields, in_cover, big_s,
                          impulse: float, dim: int, use_kernel: bool):
    """Exact residual for the smalls the broad phase could not cover: the
    set O (`_overflow_set`), and
      (b) covered and selected targets <- O sources (cheb <= 1),
      (c) O targets <- covered sources (cheb <= 1).
    Big targets already received overflow-small impulses from the big-body
    pass, and unselected overflow targets are in no source set, so both are
    left out of (b): pairs beyond the cap drop symmetrically."""
    ov = _overflow_set(fields_s, in_cover, big_s)
    dp_b, dv_b = _cheb_pair_deltas_blocked(fields_s, ov.src, dim, impulse,
                                           use_kernel=use_kernel)
    tgt_ok = ov.tgt_ok[:, None]
    dpos_s = dpos_s + torch.where(tgt_ok, dp_b, 0.0)
    dvel_s = dvel_s + torch.where(tgt_ok, dv_b, 0.0)
    dp_c, dv_c = _cheb_pair_deltas_blocked(ov.src, ov.cover_src, dim,
                                           impulse, use_kernel=use_kernel)
    ok = ov.valid[:, None]
    dpos_s = dpos_s.index_add(0, ov.idx, torch.where(ok, dp_c, 0.0))
    dvel_s = dvel_s.index_add(0, ov.idx, torch.where(ok, dv_c, 0.0))
    return dpos_s, dvel_s


def _exact_corrections(dpos_s, dvel_s, fields_s: Fields, in_cover, big_s,
                       big_src: Fields, big_sel, top_sorted, overflow,
                       impulse: float, dim: int, use_kernel: bool):
    """Big-body and overflow-residual exact passes, shared by the bucket and
    block broad phases. `fields_s` = (pos, vel, mass, radius, cell) in the
    broad phase's sorted order; `in_cover` marks the sorted-order smalls it
    fully resolved; `big_src` is the (<= 64)-row extracted big-body tuple
    and `top_sorted` its rows' sorted-order indices. The residual runs only
    when `overflow` > 0: a Python branch, one host sync (`host_read`; JAX:
    lax.cond), counted as `collide.overflow`."""
    dpos_s, dvel_s = _big_body_corrections(
        dpos_s, dvel_s, fields_s, big_s, big_src, big_sel, top_sorted,
        impulse, dim, use_kernel)
    over = profiling.host_read(overflow, "collide_overflow")
    profiling.count("collide.overflow", over)
    if over > 0:
        dpos_s, dvel_s = _residual_corrections(
            dpos_s, dvel_s, fields_s, in_cover, big_s, impulse, dim,
            use_kernel)
    return dpos_s, dvel_s


def _inverse(order: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return inv


def _corrected_deltas(state: ParticleState, order, bigs: _Bigs, cell,
                      fields_s: Fields, dpos_s, dvel_s, in_cover, big_s,
                      overflow, config: SimConfig, use_kernel: bool):
    """A broad phase's deltas (sorted order) with the exact corrections
    added, back in the original order: (dpos, dvel) [N, D]."""
    inv = _inverse(order)
    top_i, big_sel = bigs.top_i, bigs.big_sel
    big_src = (state.pos[top_i], state.vel[top_i],
               torch.where(big_sel, state.mass[top_i], 0.0),
               state.radius[top_i], cell[top_i])
    dpos_s, dvel_s = _exact_corrections(
        dpos_s, dvel_s, fields_s, in_cover, big_s, big_src, big_sel,
        inv[top_i], overflow, config.collision_impulse, state.dim,
        use_kernel)
    return dpos_s[inv], dvel_s[inv]


def _apply(state: ParticleState, deltas) -> ParticleState:
    dpos, dvel = deltas
    return state.replace(pos=state.pos + dpos, vel=state.vel + dvel)


# ---------------------------------------------------------------------------
# Lex-sorted block broad phase (large N, 2D and 3D)
# ---------------------------------------------------------------------------

def _lex_argsort(cols) -> torch.Tensor:
    """Stable lexicographic argsort over int columns (first column most
    significant): successive stable argsorts, last key first."""
    order = torch.argsort(cols[-1], stable=True)
    for c in reversed(cols[:-1]):
        order = order[torch.argsort(c[order], stable=True)]
    return order


class _Blocks(NamedTuple):
    """What the block pass and its occupancy probe share."""
    t_blk: int
    n_tot: int               # rows padded to whole blocks and >= one window
    order: torch.Tensor      # [N] lex sort permutation
    cell: torch.Tensor       # [N, D] int32 cells (original order)
    bigs: _Bigs
    keys: torch.Tensor       # [D, n_tot] int32 sorted keys, padded
    w_lo: torch.Tensor       # [nb, n_off] int32 window starts
    w_hi: torch.Tensor       # [nb, n_off] int32 window ends
    ok_blk: torch.Tensor     # [nb] bool: every span fits its fixed window


def _block_structure(pos: torch.Tensor, radius: torch.Tensor,
                     config: SimConfig) -> _Blocks:
    """Big-body extraction, radius-scaled cells, lex sort, per-block
    neighbour windows and block coverage. The block size is
    `collision_block_size` on every device (K6 takes any multiple of 256;
    the TPU kernel forced 1024)."""
    floor = torch.tensor(max(float(config.collision_cell_size), 1e-6),
                         dtype=pos.dtype, device=pos.device)
    bigs = _extract_bigs(radius, floor)
    cell = torch.floor(pos / bigs.cell_size).to(torch.int32)      # [N, D]
    return _blocks_of_cells(cell, bigs, config.collision_block_size)


def _blocks_of_cells(cell: torch.Tensor, bigs: _Bigs, t_blk: int) -> _Blocks:
    """The lex sort, per-block neighbour windows and block coverage of
    int32 cells [N, D] (bigs sort last under the sentinel)."""
    n, dim = cell.shape
    device = cell.device
    w_len = window_length(t_blk)
    # Whole blocks, and at least one full window (the fixed-length windows
    # of the plain version must stay inside the array).
    nb = max(-(-n // t_blk), -(-w_len // t_blk))
    n_tot = nb * t_blk
    cols = ([torch.where(bigs.is_big, _CELL_SENTINEL, cell[:, 0])]
            + [cell[:, a] for a in range(1, dim)])
    order = _lex_argsort(cols)
    keys = torch.full((dim, n_tot), _CELL_SENTINEL + 1, dtype=torch.int32,
                      device=device)
    for a in range(dim):
        keys[a, :n] = cols[a][order]

    # Per-block first/last target cells -> neighbour windows. The x-offset
    # neighbourhood of a lex-consecutive cell run is itself a lex interval
    # (the +-1 trailing-axis offsets merge into the interval bounds), so 3
    # windows cover the 9-cell neighbourhood in 2D and 9 the 27-cell one.
    firsts, lasts = keys[:, ::t_blk], keys[:, t_blk - 1::t_blk]  # [D, nb]
    offs = torch.tensor(lead_offsets(dim), dtype=torch.int32,
                        device=device)                           # [n_off, D-1]
    qlo = ([firsts[a][:, None] + offs[None, :, a] for a in range(dim - 1)]
           + [(firsts[dim - 1] - 1)[:, None].expand(-1, offs.shape[0])])
    qhi = ([lasts[a][:, None] + offs[None, :, a] for a in range(dim - 1)]
           + [(lasts[dim - 1] + 1)[:, None].expand(-1, offs.shape[0])])
    rows = list(keys)
    w_lo = lex_searchsorted(rows, qlo, False, n_tot)            # [nb, n_off]
    w_hi = lex_searchsorted(rows, qhi, True, n_tot)
    ok_blk = (w_hi - window_start(w_lo, n_tot, t_blk) <= w_len).all(1)
    return _Blocks(t_blk, n_tot, order, cell, bigs, keys, w_lo, w_hi,
                   ok_blk)


class _BlockPlanes(NamedTuple):
    planes: torch.Tensor     # [2D + 3, n_tot] K6's planes (kernels/collide_block)
    fields_s: tuple          # (pos, vel, mass, radius, cell), sorted, [N]
    ok_p: torch.Tensor       # [N] sorted: covered block and not big
    big_s: torch.Tensor      # [N] sorted is_big


def _block_planes(state: ParticleState, s: _Blocks) -> _BlockPlanes:
    """Sorted fields and K6's padded planes. Only covered, non-big rows are
    `ok`; the mass plane is zero elsewhere; padding has mass 0, ok 0 and
    radius -1e9."""
    n, dim = state.n, state.dim
    order = s.order
    fields_s = (state.pos[order], state.vel[order], state.mass[order],
                state.radius[order], s.cell[order])
    pos_s, vel_s, mass_s, radius_s, _ = fields_s
    big_s = s.bigs.is_big[order]
    ok_p = s.ok_blk.repeat_interleave(s.t_blk)[:n] & ~big_s
    planes = torch.zeros((2 * dim + 3, s.n_tot), dtype=state.pos.dtype,
                         device=state.device)
    planes[:dim, :n] = pos_s.T
    planes[dim:2 * dim, :n] = vel_s.T
    planes[2 * dim, :n] = torch.where(ok_p, mass_s, 0.0)
    planes[2 * dim + 1] = -1e9
    planes[2 * dim + 1, :n] = radius_s
    planes[2 * dim + 2, :n] = ok_p.to(planes.dtype)
    return _BlockPlanes(planes, fields_s, ok_p, big_s)


def _block_dense_deltas(planes: torch.Tensor, s: _Blocks, config: SimConfig,
                        use_kernel: bool, blk0: int = 0,
                        nb_loc: Optional[int] = None):
    """Dense-stage deltas (sorted order) of blocks [blk0, blk0 + nb_loc):
    K6 with `use_kernel`, else its plain version. [nb_loc * T, D] each."""
    fn = block_collision_deltas if use_kernel else \
        block_collision_deltas_plain
    return fn(planes, s.keys, s.w_lo, s.w_hi, t_blk=s.t_blk,
              impulse=config.collision_impulse, blk0=blk0, nb_loc=nb_loc)


def _block_corrections(state: ParticleState, s: _Blocks, bp: _BlockPlanes,
                       dp_s, dv_s, config: SimConfig, use_kernel: bool):
    """The block pass's tail: exact big-body and overflow corrections on
    the dense-stage deltas ([N, D], sorted order) through K5 with
    `use_kernel`; (dpos, dvel) [N, D] in the original order."""
    overflow = (~bp.ok_p & ~bp.big_s).sum()
    return _corrected_deltas(state, s.order, s.bigs, s.cell, bp.fields_s,
                             dp_s, dv_s, bp.ok_p, bp.big_s, overflow, config,
                             use_kernel)


def _block_deltas(state: ParticleState, config: SimConfig,
                  use_kernel: bool):
    """The block pass's (dpos, dvel) [N, D] in the original order: through
    K6 and K5 with `use_kernel`, else through their plain versions."""
    n = state.n
    with profiling.span("collide.structure"):
        s = _block_structure(state.pos, state.radius, config)
    with profiling.span("collide.planes"):
        bp = _block_planes(state, s)
    with profiling.span("collide.block"):
        dp_s, dv_s = _block_dense_deltas(bp.planes, s, config, use_kernel)
    with profiling.span("collide.corrections"):
        return _block_corrections(state, s, bp, dp_s[:n], dv_s[:n], config,
                                  use_kernel)


def _block_pass(state: ParticleState, config: SimConfig) -> ParticleState:
    """Lex-sorted block Jacobi collision pass (large N, 2D and 3D).

    Sorting by true cell coordinates makes every neighbour offset's sources
    a contiguous window of the sorted array for each block of T sorted
    targets; K6 resolves each block against its windows. Pairs fire iff
    both members sit in covered blocks (each window's span fits
    2T + 512 rows), keeping every impulse two-sided; particles of uncovered
    blocks take the shared exact residual (cap `_OVERFLOW_CAP`), big bodies
    the shared unmasked passes. Reference narrow phase:
    Simulation.hpp:216-346."""
    return _apply(state, _block_deltas(state, config,
                                       _use_kernels(state, config)))


def collision_block_overflow(state: ParticleState,
                             config: SimConfig) -> int:
    """Diagnostic: small particles in uncovered blocks (a window's span
    beyond its fixed length), i.e. the load the block pass would push into
    its capped exact residual."""
    s = _block_structure(state.pos, state.radius, config)
    big_s = s.bigs.is_big[s.order]
    ok_p = s.ok_blk.repeat_interleave(s.t_blk)[:state.n] & ~big_s
    return int((~ok_p & ~big_s).sum())


# ---------------------------------------------------------------------------
# Dense-bucket broad phase (large N, 2D)
# ---------------------------------------------------------------------------

class _BucketCells(NamedTuple):
    bigs: _Bigs
    cell: torch.Tensor       # [N, 2] int32, clipped to the grid
    flat: torch.Tensor       # [N] flat cell id; res^2 for bigs


def _bucket_cells(pos: torch.Tensor, radius: torch.Tensor,
                  config: SimConfig) -> _BucketCells:
    """The bounding square at `collision_grid_res` cells per axis (cells
    track the particle span), the cell size floored for the big-body
    extraction. Bigs rank in a virtual cell past the grid."""
    res = config.collision_grid_res
    mn, mx = pos.amin(0), pos.amax(0)
    span = torch.clamp_min((mx - mn).amax(), 1e-3) * 1.0001
    corner = 0.5 * (mn + mx) - 0.5 * span
    bigs = _extract_bigs(radius, span / res)
    cell = torch.clamp(((pos - corner) / bigs.cell_size).to(torch.int32),
                       0, res - 1)
    flat = torch.where(bigs.is_big, res * res, cell[:, 0] * res + cell[:, 1])
    return _BucketCells(bigs, cell, flat)


def _bucket_stencil(planes, res: int, cap: int, impulse: float,
                    center_rows: Optional[int] = None):
    """Pair deltas of every target slot against the slots of its 9
    neighbouring cells, per slot: (dpos x, dpos y, dvel x, dvel y), [rows,
    res, cap] each. `planes` = (px, py, vx, vy, m, r): the whole grid
    [res, res, cap] (center_rows None: zero rows beyond it), or a row window
    [center_rows + 2, res, cap] whose first and last rows are halo sources
    (the multi-device pass's band). Empty slots have mass 0 and radius
    -1e9. Rows of cells in chunks keep the [chunk, res, cap, cap] pair temps
    near 2^24 elements."""
    fills = (0.0, 0.0, 0.0, 0.0, 0.0, -1e9)
    if center_rows is None:
        rows, tgt_planes, row_pad = res, planes, (1, 1)
    else:
        rows, row_pad = center_rows, (0, 0)
        tgt_planes = [p[1:1 + rows] for p in planes]
    padded = [F.pad(p, (0, 0, 1, 1) + row_pad, value=f)
              for p, f in zip(planes, fills)]
    chunk = max(1, min(rows, (1 << 24) // max(1, res * cap * cap)))
    while rows % chunk:
        chunk -= 1
    acc = [torch.zeros_like(tgt_planes[0]) for _ in range(4)]
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            shifted = [p[1 + ox:1 + ox + rows, 1 + oy:1 + oy + res]
                       for p in padded]
            for c0 in range(0, rows, chunk):
                tpx, tpy, tvx, tvy, tm, tr = (p[c0:c0 + chunk]
                                              for p in tgt_planes)
                cpx, cpy, cvx, cvy, cm, cr = (p[c0:c0 + chunk]
                                              for p in shifted)
                d = torch.stack([cpx[:, :, None, :] - tpx[:, :, :, None],
                                 cpy[:, :, None, :] - tpy[:, :, :, None]], -1)
                v = torch.stack([cvx[:, :, None, :] - tvx[:, :, :, None],
                                 cvy[:, :, None, :] - tvy[:, :, :, None]], -1)
                msum = tm[:, :, :, None] + cm[:, :, None, :]
                w1 = cm[:, :, None, :] / torch.where(msum > 0.0, msum, 1.0)
                r = tr[:, :, :, None] + cr[:, :, None, :]
                # Empty source slots carry mass 0; self pairs have
                # d = v = 0, a no-op in both branches of the pair math.
                valid = (cm[:, :, None, :] > 0.0) & (tm[:, :, :, None] > 0.0)
                dpos, dvel = _pair_deltas(d, v, w1, r, valid, impulse)
                sums = (dpos[..., 0].sum(-1), dpos[..., 1].sum(-1),
                        dvel[..., 0].sum(-1), dvel[..., 1].sum(-1))
                for a, part in zip(acc, sums):
                    a[c0:c0 + chunk] = a[c0:c0 + chunk] + part
    return acc


def _bucket_pass(state: ParticleState, config: SimConfig) -> ParticleState:
    """Shift-stencil collision pass on a dense [res, res, K] bucket grid
    (2D; plain torch, as the JAX package computes it in XLA).

    The particles are sorted by cell (stable: the slot rank decides who is
    in the K-slot cap) and the first K of each cell are scattered into the
    grid; every slot meets the slots of its 9 neighbouring cells. Big bodies
    (radius > cell/2) leave the grid for the exact big-body passes, and
    smalls past the cap take the exact residual."""
    return _apply(state, _bucket_deltas(state, config,
                                        _use_kernels(state, config)))


def _bucket_deltas(state: ParticleState, config: SimConfig,
                   use_kernel: bool):
    """The bucket pass's (dpos, dvel) [N, 2] in the original order, its
    corrections through K5 with `use_kernel`. Spans `collide.bucket_grid`
    (cells, sort, slots, the six planes), `collide.stencil` and
    `collide.corrections` (the gathers, the exact passes)."""
    pos, vel, mass, radius = state.pos, state.vel, state.mass, state.radius
    n = state.n
    cap = config.collision_max_neighbors
    res = config.collision_grid_res
    with profiling.span("collide.bucket_grid"):
        bc = _bucket_cells(pos, radius, config)
        order = torch.argsort(bc.flat, stable=True)
        flat_s = bc.flat[order]
        slot = (torch.arange(n, device=pos.device)
                - sorted_first_occurrence(flat_s))
        big_s = bc.bigs.is_big[order]
        in_cap = (slot < cap) & ~big_s
        overflow = (~in_cap & ~big_s).sum()
        fields_s = (pos[order], vel[order], mass[order], radius[order],
                    bc.cell[order])
        pos_s, vel_s, mass_s, radius_s, _ = fields_s

        # Dropped entries (past the cap, bigs) go to one spare slot, cut off.
        size = res * res * cap
        dest = torch.where(in_cap, flat_s * cap + slot, size)

        def scatter(vals, fill=0.0):
            buf = torch.full((size + 1,), fill, dtype=pos.dtype,
                             device=pos.device)
            buf[dest] = vals
            return buf[:size].reshape(res, res, cap)

        planes = (scatter(pos_s[:, 0]), scatter(pos_s[:, 1]),
                  scatter(vel_s[:, 0]), scatter(vel_s[:, 1]),
                  scatter(torch.where(in_cap, mass_s, 0.0)),
                  scatter(radius_s, fill=-1e9))
    with profiling.span("collide.stencil"):
        acc = _bucket_stencil(planes, res, cap, config.collision_impulse)

    with profiling.span("collide.corrections"):
        # Gathers clamp out-of-grid ids, as JAX's do; those rows are masked.
        gidx = (torch.clamp(flat_s, max=res * res - 1) * cap
                + torch.clamp(slot, max=cap - 1))
        dx, dy, dvx, dvy = (torch.where(in_cap, a.reshape(-1)[gidx], 0.0)
                            for a in acc)
        dpos_s = torch.stack([dx, dy], -1)
        dvel_s = torch.stack([dvx, dvy], -1)
        return _corrected_deltas(
            state, order, bc.bigs, bc.cell, fields_s, dpos_s, dvel_s, in_cap,
            big_s, overflow, config, use_kernel)


def collision_bucket_overflow(state: ParticleState, config: SimConfig) -> int:
    """Diagnostic: small particles beyond the 2D bucket-grid slot cap that
    would rely on the (capped) exact residual. Mirrors _bucket_pass's grid;
    occupancy count only."""
    res = config.collision_grid_res
    bc = _bucket_cells(state.pos[:, :2], state.radius, config)
    flat_s = torch.sort(bc.flat).values
    slot = (torch.arange(state.n, device=state.device)
            - sorted_first_occurrence(flat_s))
    return int(((slot >= config.collision_max_neighbors)
                & (flat_s < res * res)).sum())


# ---------------------------------------------------------------------------
# Sorted-spatial-hash broad phase (large N, 2D and 3D; explicit 'hash' only)
# ---------------------------------------------------------------------------

# Particle-chunk size of the windowed candidate scan: bounds its [B, C*W, D]
# temps whatever N is (the JAX package measured ~47 GB for a single [N, 144,
# D] scan at N=4M).
_WINDOW_CHUNK = 1 << 17

# Multiplicative hash of SpatialGrid::hash_position's family
# (Simulation.hpp:31-34), in uint32 in the JAX package.
_HASH_PRIMES = (92837111, 689287499, 283923481)
_HASH_MULT = 15485863
_LOW32 = (1 << 32) - 1


def _cell_hash(cell: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Hash of int32 cell coords [..., D] -> int32 in [0, n_buckets), a
    power of two: the JAX package's uint32 hash bit for bit. The products
    run in int64 and keep their low 32 bits (the uint32 result), so nothing
    relies on int32 overflow wrapping."""
    h = torch.zeros(cell.shape[:-1], dtype=torch.int64, device=cell.device)
    for axis in range(cell.shape[-1]):
        h = h ^ (cell[..., axis].to(torch.int64) * _HASH_PRIMES[axis])
    h = (h & _LOW32) * _HASH_MULT
    return (h & (n_buckets - 1)).to(torch.int32)


def _neighbour_offsets(dim: int, device) -> torch.Tensor:
    """The 9 (2D) / 27 (3D) cell offsets, last axis fastest [C, D] int32."""
    axes = torch.meshgrid(*([torch.arange(-1, 2, dtype=torch.int32,
                                          device=device)] * dim),
                          indexing="ij")
    return torch.stack(axes, -1).reshape(-1, dim)


class _HashGrid(NamedTuple):
    """What the hash pass and its probe share (sorted by hash)."""
    bigs: _Bigs
    cell: torch.Tensor       # [N, D] int32 radius-scaled cells (original)
    n_buckets: int
    order: torch.Tensor      # [N] stable sort by hash
    h_s: torch.Tensor        # [N] int32 sorted hashes
    big_s: torch.Tensor      # [N] sorted is_big
    in_win: torch.Tensor     # [N] sorted: rank in its segment < W, not big


def _hash_grid(pos: torch.Tensor, radius: torch.Tensor,
               config: SimConfig) -> _HashGrid:
    """Big-body extraction (cells floored at 2.05x the 65th largest radius;
    collision_cell_size <= 0 leaves the floor alone), hash, stable sort, and
    the window: the first W = collision_max_neighbors rows of each hash
    segment are the sources its probes see."""
    n = pos.shape[0]
    floor = torch.tensor(max(float(config.collision_cell_size), 1e-6),
                         dtype=pos.dtype, device=pos.device)
    bigs = _extract_bigs(radius, floor)
    cell = torch.floor(pos / bigs.cell_size).to(torch.int32)      # [N, D]
    n_buckets = 1 << max(1, (2 * n - 1).bit_length())    # >= 2N, power of 2
    h = _cell_hash(cell, n_buckets)
    order = torch.argsort(h, stable=True)
    h_s = h[order]
    big_s = bigs.is_big[order]
    rank = torch.arange(n, device=pos.device) - sorted_first_occurrence(h_s)
    in_win = (rank < config.collision_max_neighbors) & ~big_s
    return _HashGrid(bigs, cell, n_buckets, order, h_s, big_s, in_win)


def _window_scan(g: _HashGrid, fields_s: Fields, offs: torch.Tensor,
                 window: int, impulse: float, row0: int, rows: int):
    """Pair deltas (dpos, dvel) [rows, D] of sorted rows [row0, row0+rows)
    against the first `window` rows of each neighbour cell's hash segment.
    A candidate counts when its cell (not only its hash) is the probed one,
    it is not the target itself, and both sit in their windows, so every
    impulse has its Jacobi counterpart."""
    pos_s, vel_s, mass_s, radius_s, cell_s = fields_s
    n = pos_s.shape[0]
    sl = slice(row0, row0 + rows)
    nbr_cells = cell_s[sl, None, :] + offs[None]                 # [B, C, D]
    nbr_hash = _cell_hash(nbr_cells, g.n_buckets)                 # [B, C]
    starts = torch.searchsorted(g.h_s, nbr_hash.reshape(-1)).reshape(
        rows, -1)
    win = torch.arange(window, device=pos_s.device)
    cand = (starts[:, :, None] + win).reshape(rows, -1)           # [B, K]
    in_range = cand < n
    cand = torch.clamp_max(cand, n - 1)
    cell_match = (cell_s[cand] == nbr_cells.repeat_interleave(
        window, dim=1)).all(-1)
    sidx = torch.arange(row0, row0 + rows, device=pos_s.device)
    valid = (in_range
             & (g.h_s[cand] == nbr_hash.repeat_interleave(window, dim=1))
             & cell_match & (cand != sidx[:, None])
             & g.in_win[sl, None] & g.in_win[cand])
    d = pos_s[cand] - pos_s[sl, None, :]
    v = vel_s[cand] - vel_s[sl, None, :]
    m_j = mass_s[cand]
    msum = mass_s[sl, None] + m_j
    valid = valid & (msum > 0.0)    # zero-mass pairs: no impulse, no NaN
    w1 = torch.where(valid, m_j / torch.where(msum > 0.0, msum, 1.0), 0.0)
    r = radius_s[sl, None] + radius_s[cand]
    dpos, dvel = _pair_deltas(d, v, w1, r, valid, impulse)
    return dpos.sum(1), dvel.sum(1)


def _grid_pass(state: ParticleState, config: SimConfig) -> ParticleState:
    """Sorted spatial-hash Jacobi collision pass (JAX `_grid_pass`).

    Hash -> stable sort -> per-particle windowed scan of the neighbour
    cells' segments (the first `collision_max_neighbors` rows of each),
    in chunks of `_WINDOW_CHUNK` rows; particles past their segment's
    window take the shared exact residual, big bodies the shared unmasked
    passes (K5 on the card)."""
    return _apply(state, _grid_deltas(state, config,
                                      _use_kernels(state, config)))


def _grid_deltas(state: ParticleState, config: SimConfig, use_kernel: bool):
    """The hash pass's (dpos, dvel) [N, D] in the original order, its
    corrections through K5 with `use_kernel`."""
    n, dim = state.n, state.dim
    g = _hash_grid(state.pos, state.radius, config)
    order = g.order
    fields_s = (state.pos[order], state.vel[order], state.mass[order],
                state.radius[order], g.cell[order])
    offs = _neighbour_offsets(dim, state.device)
    window = config.collision_max_neighbors
    parts = [_window_scan(g, fields_s, offs, window,
                          config.collision_impulse, r0,
                          min(_WINDOW_CHUNK, n - r0))
             for r0 in range(0, n, _WINDOW_CHUNK)]
    dpos_s = torch.cat([p[0] for p in parts])
    dvel_s = torch.cat([p[1] for p in parts])
    overflow = (~g.in_win & ~g.big_s).sum()
    return _corrected_deltas(
        state, order, g.bigs, g.cell, fields_s, dpos_s, dvel_s, g.in_win,
        g.big_s, overflow, config, use_kernel)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def _broad_phase(state: ParticleState, config: SimConfig) -> str:
    """The pass `resolve_collisions` runs: 'dense', 'bucket', 'hash' or
    'block'."""
    bp = config.collision_broad_phase
    if bp == "auto":
        if state.n <= DENSE_THRESHOLD:
            return "dense"
        bp = "bucket" if state.dim == 2 else "block"
    if bp == "bucket" and state.dim != 2:
        bp = "block"      # the dense bucket grid is 2D-only
    return bp


def resolve_collision_phase_for_state(state: ParticleState,
                                      config: SimConfig) -> SimConfig:
    """Occupancy probe for the collision broad phase: when 'auto' would pick
    the 2D bucket grid and the actual distribution overflows it beyond the
    residual's capacity, switch to the lex-sorted block pass with
    radius-scaled cells (and warn). Explicit broad phases are honoured
    untouched."""
    if not config.enable_collisions:
        return config
    if (state.dim != 2 or state.n <= DENSE_THRESHOLD
            or config.collision_broad_phase != "auto"):
        return config
    over = collision_bucket_overflow(state, config)
    if over <= _OVERFLOW_CAP:
        return config
    warnings.warn(
        f"auto collision broad phase: bucket-grid overflow {over} exceeds "
        f"the residual capacity {_OVERFLOW_CAP}; switching to the "
        f"lex-sorted block pass with radius-scaled cells (full collision "
        f"coverage at any clustering). Set collision_broad_phase explicitly "
        f"to override.", RuntimeWarning)
    return config.replace(collision_broad_phase="block",
                          collision_cell_size=0.0)


def resolve_collisions(state: ParticleState,
                       config: SimConfig) -> ParticleState:
    """Full collision step: broad phase + Jacobi narrow phase, iterated
    (the span `collisions`)."""
    if not config.enable_collisions:
        return state
    one_pass = {"dense": _dense_pass, "bucket": _bucket_pass,
                "hash": _grid_pass,
                "block": _block_pass}[_broad_phase(state, config)]
    with profiling.span("collisions"):
        for _ in range(max(1, config.collision_iterations)):
            state = one_pass(state, config)
    return state
