"""The collision pass of the multi-device step (port of
`nbodysim_tpu.parallel.collisions`; its module docstring gives the design).

  * `gathered_dense_deltas` — the small-N path: every rank all-gathers the
    particle arrays and resolves its own rows [r * N/P, (r + 1) * N/P)
    against all of them, with K2's row-range form on the card (the JAX
    package computes this pass in XLA; its mask, sources' mass > 0, is
    K2's own). At P = 1 it is the launch `_dense_pass` makes.
  * `sharded_collision_deltas` — the broad-phase dispatch, as the JAX
    package's: the dense pass; a large-N pass run replicated on the
    gathered arrays (`_replicated_fallback`) where the JAX package runs it
    so (P = 1, or a bucket grid whose rows do not split over P); else the
    banded passes below.

The banded large-N passes keep the O(N) preparation replicated on the
gathered arrays and split the heavy stage over the mesh; each rank writes
its contributions into a full-length [N, 2D] buffer whose pieces are
disjoint, and one `psum` combines them:

  * block (`_banded_block_deltas`): the lex sort and the block windows on
    every rank; K6 on the rank's band of ceil(nb / P) blocks (the last band
    clipped to the blocks that exist, none for a rank past them); the
    capped corrections replicated after the psum.
  * bucket (`_banded_bucket_deltas`, 2D): the rank's band of res / P grid
    rows plus one halo row a side scattered into a window grid and run
    through `physics.collisions._bucket_stencil`, over a compacted window
    set (`parallel.tree.compact_capacity`) whose stable sort gives every
    particle the slot the single device gives it; the whole set sorted
    where the window overfills it.
  * hash (`_banded_hash_deltas`): the sort on every rank; the window scan
    on the rank's chunk of sorted targets.
  * big bodies: bigs <- the local shard's smalls inside the psum (K5 with
    the sources partitioned), everyone <- bigs on the local rows after it.
  * the residual (`_banded_residual`): the overflow set chosen over the
    whole sorted set on every rank (`physics.collisions._overflow_set`), so
    every rank drops the same pairs beyond the cap; its pass (b) on the
    rank's chunk of sorted targets, (c) on its share of the overflow rows,
    both K5 with the cell mask cheb <= 1.

The JAX package's `lax.cond`s (the residual, the window's fill) are host
branches on a count every rank computes from the same gathered arrays, or
that no collective depends on; no collective sits inside a branch.
`sharded_collision_deltas.work` holds the last banded call's work counts on
this rank: what falls with P.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.core.blocking import sorted_first_occurrence
from nbodysim_tpu_torch.core.state import ParticleState
from nbodysim_tpu_torch.kernels.collide import (
    allpairs_collision_deltas,
    collision_deltas_plain,
)
from nbodysim_tpu_torch.parallel import comm
from nbodysim_tpu_torch.parallel.tree import compact_capacity
from nbodysim_tpu_torch.physics import collisions as C
from nbodysim_tpu_torch.physics.barneshut import _compact_indices
from nbodysim_tpu_torch.physics.collisions import (
    DENSE_THRESHOLD,
    _WINDOW_CHUNK,
    resolve_collision_backend,
)


def gathered_dense_deltas(pos_l, vel_l, mass_l, radius_l, config: SimConfig,
                          axis: comm.Axis
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Jacobi collision deltas of the local rows against all N particles:
    the particle arrays all-gathered as one [N, 2D + 2] block, then K2 (or
    its plain version) on the target rows [r * N/P, (r + 1) * N/P)."""
    dim = pos_l.shape[1]
    g = comm.all_gather(
        torch.cat([pos_l, vel_l, mass_l[:, None], radius_l[:, None]], 1),
        axis)
    pos, vel = g[:, :dim], g[:, dim:2 * dim]
    mass, radius = g[:, 2 * dim], g[:, 2 * dim + 1]
    n_l = pos_l.shape[0]
    rows = (axis.index * n_l, n_l)
    if resolve_collision_backend(config, pos_l.device) == "cuda":
        return allpairs_collision_deltas(
            pos, vel, mass, radius, impulse=config.collision_impulse,
            rows=rows)
    return collision_deltas_plain(pos, vel, mass, radius,
                                  impulse=config.collision_impulse, rows=rows)


def sharded_collision_deltas(pos_l, vel_l, mass_l, radius_l,
                             config: SimConfig, axis: comm.Axis
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Jacobi collision pass for the local shard: (dpos_l, dvel_l).

    The broad phase is picked as `physics.collisions.resolve_collisions`
    picks it (an upstream `resolve_collision_phase_for_state` may have
    pinned it), so the sharded step resolves the physics the single device
    would."""
    p_dev = axis.size
    n_l, dim = pos_l.shape
    n = n_l * p_dev

    bp = config.collision_broad_phase
    if bp == "auto":
        if n <= DENSE_THRESHOLD:
            bp = "dense"
        else:
            bp = "bucket" if dim == 2 else "block"
    if bp == "bucket" and dim != 2:
        bp = "block"
    if bp == "dense":
        return gathered_dense_deltas(pos_l, vel_l, mass_l, radius_l, config,
                                     axis)

    g = comm.all_gather(
        torch.cat([pos_l, vel_l, mass_l[:, None], radius_l[:, None]], 1),
        axis)
    st = ParticleState(pos=g[:, :dim], vel=g[:, dim:2 * dim],
                       acc=torch.zeros_like(g[:, :dim]), mass=g[:, 2 * dim],
                       radius=g[:, 2 * dim + 1],
                       frame=torch.zeros((), dtype=torch.int32,
                                         device=pos_l.device))
    res = config.collision_grid_res
    if p_dev == 1 or (bp == "bucket" and res % p_dev):
        # Grid rows must split evenly; otherwise the single-device pass
        # runs replicated: correct, not compute-scaled.
        sharded_collision_deltas.work = {"replicated": True}
        return _replicated_fallback(st, config, bp, axis.index, n_l)
    band = {"bucket": _banded_bucket_deltas, "block": _banded_block_deltas,
            "hash": _banded_hash_deltas}[bp]
    return band(st, config, axis)


sharded_collision_deltas.work = {}


def _replicated_fallback(st: ParticleState, config: SimConfig, bp: str,
                         my: int, n_l: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The single-device pass's deltas on the gathered arrays (the same on
    every rank), the local rows of them. The JAX package takes
    `out.pos - pos`, which rounds a delta to the positions' ulp; the
    deltas themselves make the step the single device's."""
    fn = {"bucket": C._bucket_deltas, "hash": C._grid_deltas,
          "block": C._block_deltas}[bp]
    dpos, dvel = fn(st, config, C._use_kernels(st, config))
    rows = slice(my * n_l, (my + 1) * n_l)
    return dpos[rows], dvel[rows]


def _rows(axis: comm.Axis, n_l: int) -> slice:
    return slice(axis.index * n_l, (axis.index + 1) * n_l)


# ---------------------------------------------------------------------------
# Shared by the banded passes
# ---------------------------------------------------------------------------

def _big_src(st: ParticleState, bigs, cell) -> C.Fields:
    """The (<= 64)-row big-body tuple (mass 0 where not big)."""
    ti = bigs.top_i
    return (st.pos[ti], st.vel[ti],
            torch.where(bigs.big_sel, st.mass[ti], 0.0), st.radius[ti],
            cell[ti])


def _bigs_from_local(contrib, st, bigs, cell, big_src, axis, n_l, impulse,
                     use_kernel):
    """bigs <- the local shard's smalls, added at the bigs' rows of the
    [N, 2D] contribution buffer (each small is a source on one rank)."""
    dim = st.dim
    rows = _rows(axis, n_l)
    small_l = (st.pos[rows], st.vel[rows],
               torch.where(bigs.is_big[rows], 0.0, st.mass[rows]),
               st.radius[rows], cell[rows])
    dp, dv = C._cheb_pair_deltas_blocked(big_src, small_l, dim, impulse,
                                         max_cheb=None, use_kernel=use_kernel)
    sel = bigs.big_sel[:, None]
    contrib.index_add_(0, bigs.top_i,
                       torch.where(sel, torch.cat([dp, dv], 1), 0.0))


def _combine(contrib, st, cell, big_src, axis, n_l, impulse, use_kernel):
    """psum of the disjoint contributions, the local rows of the sum, and
    everyone <- bigs on the local rows (each target is local on one
    rank)."""
    dim = st.dim
    rows = _rows(axis, n_l)
    total = comm.psum(contrib, axis)[rows]
    tgt_l = (st.pos[rows], st.vel[rows], st.mass[rows], st.radius[rows],
             cell[rows])
    dp, dv = C._cheb_pair_deltas_blocked(tgt_l, big_src, dim, impulse,
                                         max_cheb=None, use_kernel=use_kernel)
    return total[:, :dim] + dp, total[:, dim:] + dv


def _banded_residual(contrib, order, fields_s: C.Fields, in_cover, big_s,
                     axis: comm.Axis, impulse: float, use_kernel: bool):
    """The residual's two passes, banded (JAX `_banded_residual`): the
    overflow set is chosen over the whole sorted set, the same on every
    rank; (b) runs on this rank's chunk of sorted targets, (c) on its
    ceil(m_cap / P) rows of the overflow set, so each pair direction is
    computed on one rank. Adds into the original-order [N, 2D] buffer."""
    n, dim = fields_s[0].shape
    n_l = n // axis.size
    ov = C._overflow_set(fields_s, in_cover, big_s)
    t = _rows(axis, n_l)
    dp_b, dv_b = C._cheb_pair_deltas_blocked(
        tuple(f[t] for f in fields_s), ov.src, dim, impulse,
        use_kernel=use_kernel)
    contrib.index_add_(0, order[t], torch.where(
        ov.tgt_ok[t, None], torch.cat([dp_b, dv_b], 1), 0.0))
    m_cap = ov.idx.shape[0]
    oc = -(-m_cap // axis.size)
    r0 = axis.index * oc
    rows_c = max(0, min(oc, m_cap - r0))
    if rows_c:
        o = slice(r0, r0 + rows_c)
        dp_c, dv_c = C._cheb_pair_deltas_blocked(
            tuple(f[o] for f in ov.src), ov.cover_src, dim, impulse,
            use_kernel=use_kernel)
        contrib.index_add_(0, order[ov.idx[o]], torch.where(
            ov.valid[o, None], torch.cat([dp_c, dv_c], 1), 0.0))
    return {"residual_rows": n_l, "overflow_rows": rows_c}


# ---------------------------------------------------------------------------
# Banded lex-sorted block pass
# ---------------------------------------------------------------------------

def _banded_block_deltas(st: ParticleState, config: SimConfig,
                         axis: comm.Axis):
    """The block pass (`physics.collisions._block_deltas`) with K6 banded:
    the block structure and planes replicated, K6 on blocks [blk0, blk0 +
    nb_loc) with nb_loc = ceil(nb / P). The JAX package pads the tables to
    whole bands with sentinel keys and ok = 0, blocks that make no pairs;
    here the last band is clipped to the blocks that exist (K6 takes no
    block past nb), and a rank past them launches nothing: the same
    pairs. Sorted-order deltas go into a disjoint [N, 2D] buffer, one psum
    sums them, and the corrections (bigs, residual) run replicated."""
    n, dim = st.n, st.dim
    use_kernel = C._use_kernels(st, config)
    s = C._block_structure(st.pos, st.radius, config)
    bp = C._block_planes(st, s)
    nb = s.n_tot // s.t_blk
    nb_loc = -(-nb // axis.size)
    blk0 = axis.index * nb_loc
    n_blk = max(0, min(nb_loc, nb - blk0))
    contrib = torch.zeros((n, 2 * dim), dtype=st.pos.dtype, device=st.device)
    if n_blk:
        dp, dv = C._block_dense_deltas(bp.planes, s, config, use_kernel,
                                       blk0=blk0, nb_loc=n_blk)
        r0 = blk0 * s.t_blk
        k = min(n_blk * s.t_blk, n - r0)        # rows >= n are padding
        if k > 0:
            contrib[r0:r0 + k] = torch.cat([dp[:k], dv[:k]], 1)
    sharded_collision_deltas.work = {"replicated": False, "blocks": nb,
                                     "band_blocks": n_blk}
    total = comm.psum(contrib, axis)
    dpos, dvel = C._block_corrections(st, s, bp, total[:, :dim],
                                      total[:, dim:], config, use_kernel)
    rows = _rows(axis, n // axis.size)
    return dpos[rows], dvel[rows]


# ---------------------------------------------------------------------------
# Banded bucket grid (2D)
# ---------------------------------------------------------------------------

def _banded_bucket_deltas(st: ParticleState, config: SimConfig,
                          axis: comm.Axis):
    """The bucket pass (`physics.collisions._bucket_pass`) banded by grid
    rows: this rank's rb = res / P rows and one halo row a side."""
    n = st.n
    device, dtype = st.device, st.pos.dtype
    cap = config.collision_max_neighbors
    res = config.collision_grid_res
    rb = res // axis.size
    row0 = axis.index * rb
    impulse = config.collision_impulse
    use_kernel = C._use_kernels(st, config)
    pos, vel, mass, radius = st.pos, st.vel, st.mass, st.radius

    # ---- replicated: geometry, bigs and the occupancy -------------------
    bc = C._bucket_cells(pos, radius, config)
    bigs, cell, flat = bc.bigs, bc.cell, bc.flat
    occ = torch.zeros(res * res + 1, dtype=flat.dtype, device=device)
    occ.index_add_(0, flat, torch.ones_like(flat))
    overflow = int((occ[:res * res] - cap).clamp_min(0).sum())
    work = {"replicated": False, "band_rows": rb, "window_rows": rb + 2}

    def window_stage(src, valid_s):
        """The band's stencil over the sorted set `src` (indices into the
        N particles, `valid_s` False on padding): its particles' deltas in
        a [N, 4] buffer."""
        ll = src.shape[0]
        srcc = torch.clamp(src, max=n - 1)
        flat_s = torch.where(valid_s, flat[srcc], res * res + n)
        slot = torch.arange(ll, device=device) - sorted_first_occurrence(
            flat_s)
        in_cap = slot < cap
        pos_s, vel_s = pos[srcc], vel[srcc]
        cell_s = cell[srcc]
        is_small = valid_s & (flat_s < res * res)
        wrow = cell_s[:, 0] - row0 + 1                   # one halo row
        live = is_small & (wrow >= 0) & (wrow < rb + 2) & in_cap
        cells = (rb + 2) * res
        dest = (torch.where(live, wrow * res + cell_s[:, 1], cells) * cap
                + torch.where(live, slot, 0))

        def scat(v, fill=0.0):
            b = torch.full((cells * cap + cap,), fill, dtype=dtype,
                           device=device)
            b[dest] = v
            return b[:cells * cap].reshape(rb + 2, res, cap)

        planes = (scat(pos_s[:, 0]), scat(pos_s[:, 1]), scat(vel_s[:, 0]),
                  scat(vel_s[:, 1]), scat(torch.where(live, mass[srcc], 0.0)),
                  scat(radius[srcc], fill=-1e9))
        acc = C._bucket_stencil(planes, res, cap, impulse, center_rows=rb)
        brow = cell_s[:, 0] - row0
        g_mask = live & (brow >= 0) & (brow < rb)
        gidx = ((torch.clamp(brow, 0, rb - 1) * res + cell_s[:, 1]) * cap
                + torch.clamp(slot, max=cap - 1))
        d = torch.stack([torch.where(g_mask, a.reshape(-1)[gidx], 0.0)
                         for a in acc], -1)
        out = torch.zeros((n + 1, 4), dtype=dtype, device=device)
        out.index_add_(0, torch.where(valid_s, src, n), d)
        return out[:n]

    # ---- the compacted band window, or the whole set sorted -------------
    brow_u = cell[:, 0] - row0
    in_win_u = ~bigs.is_big & (brow_u >= -1) & (brow_u < rb + 1)
    c_cap = compact_capacity(n, rb + 2, res)
    work["window_capacity"] = c_cap
    compact = False
    if c_cap < n:
        n_win = int(in_win_u.sum())
        work["window_particles"] = n_win
        compact = n_win <= c_cap
    if compact:
        widx, _ = _compact_indices(in_win_u, c_cap)
        keys = torch.where(widx < n, flat[torch.clamp(widx, max=n - 1)],
                           res * res + n)
        oc = torch.argsort(keys, stable=True)
        work["sorted_len"] = c_cap
        contrib = window_stage(widx[oc], widx[oc] < n)
    else:
        work["sorted_len"] = n
        contrib = window_stage(torch.argsort(flat, stable=True),
                               torch.ones(n, dtype=torch.bool, device=device))

    # ---- big bodies (sources partitioned), the residual, the psum ------
    big_src = _big_src(st, bigs, cell)
    n_l = n // axis.size
    _bigs_from_local(contrib, st, bigs, cell, big_src, axis, n_l, impulse,
                     use_kernel)
    if overflow > 0:
        order = torch.argsort(flat, stable=True)
        flat_s = flat[order]
        slot = torch.arange(n, device=device) - sorted_first_occurrence(
            flat_s)
        big_s = bigs.is_big[order]
        fields_s = (pos[order], vel[order], mass[order], radius[order],
                    cell[order])
        work |= _banded_residual(contrib, order, fields_s,
                                 (slot < cap) & ~big_s, big_s, axis, impulse,
                                 use_kernel)
    sharded_collision_deltas.work = work
    return _combine(contrib, st, cell, big_src, axis, n_l, impulse,
                    use_kernel)


# ---------------------------------------------------------------------------
# Banded sorted spatial hash (2D and 3D)
# ---------------------------------------------------------------------------

def _banded_hash_deltas(st: ParticleState, config: SimConfig,
                        axis: comm.Axis):
    """The hash pass (`physics.collisions._grid_pass`) with its window scan
    on this rank's chunk of the sorted targets, in `_WINDOW_CHUNK` pieces;
    the candidates' masks read the same sorted arrays on every rank, so the
    pairs stay symmetric."""
    n, dim = st.n, st.dim
    impulse = config.collision_impulse
    use_kernel = C._use_kernels(st, config)
    g = C._hash_grid(st.pos, st.radius, config)
    order = g.order
    fields_s = (st.pos[order], st.vel[order], st.mass[order],
                st.radius[order], g.cell[order])
    offs = C._neighbour_offsets(dim, st.device)
    n_l = n // axis.size
    t0 = axis.index * n_l
    parts = [C._window_scan(g, fields_s, offs, config.collision_max_neighbors,
                            impulse, r0, min(_WINDOW_CHUNK, t0 + n_l - r0))
             for r0 in range(t0, t0 + n_l, _WINDOW_CHUNK)]
    contrib = torch.zeros((n, 2 * dim), dtype=st.pos.dtype, device=st.device)
    contrib[order[t0:t0 + n_l]] = torch.cat(
        [torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])],
        1)
    work = {"replicated": False, "chunk_rows": n_l,
            "scan_pieces": len(parts)}

    big_src = _big_src(st, g.bigs, g.cell)
    _bigs_from_local(contrib, st, g.bigs, g.cell, big_src, axis, n_l,
                     impulse, use_kernel)
    if int((~g.in_win & ~g.big_s).sum()) > 0:
        work |= _banded_residual(contrib, order, fields_s, g.in_win,
                                 g.big_s, axis, impulse, use_kernel)
    sharded_collision_deltas.work = work
    return _combine(contrib, st, g.cell, big_src, axis, n_l, impulse,
                    use_kernel)
