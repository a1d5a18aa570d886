"""The banded multi-device FMM: the 2D tree code sharded by grid rows (port
of `nbodysim_tpu.parallel.tree`; its module docstring gives the design).

Every pyramid level's rows are banded over the 1-D mesh. Each rank runs the
heavy stencils (the M2L, the near field) on its own band only;
the boundary halo rows move between ring neighbours (`comm.ppermute`, one
exchange a level), and the coarse levels that cannot band are all-gathered
and computed replicated. The cell sort, the bucket scatter, the near field
and the L2P run over a compacted per-band window set (`_field_stage`): the
particles of the band and its halo rows, at most `compact_capacity` of
them, else the whole set sorted (a host branch on one count).

Exactness: each pairwise and cell contribution is computed on exactly one
rank into a full-length [N, 2] buffer, and one `psum` combines the
disjoint pieces, so the banded result matches the single-device tree
(`physics/barneshut.bh_accelerations`) to roundoff: the M2L runs on a
band window, `psum` adds in another order, and the scatters'
`index_add_` sums in another order on the card.

Decomposition of `physics/barneshut._bh_accelerations` across the mesh:

  heavy coupling           -> local rows                      (after psum)
  bulk <- outliers (K4)    -> local rows                      (after psum)
  outliers <- all (K1)     -> outlier-index range per rank    (in psum)
  far field (M2L+L2L+L2P)  -> grid-row band per rank          (in psum)
  near field (K3)          -> grid-row band (+ halo sources)  (in psum)
  overflow residual        -> per-band window overflow sets   (in psum)
  deep chain and tiles     -> deep-level row bands            (in psum)

The JAX package's `lax.cond`s become host branches on a count read from the
device (the residual's overflow, the window's and the deep band's fill):
one sync each, and their predicates may differ between ranks, so no
collective sits inside a branch; the halos, the ring fold's window and the
tile grids' psum are exchanged outside them.

`banded_tree_accelerations.work` holds the last call's work counts on this
rank (its band rows, window rows, window capacity and the length of the set
it sorted, the deep band's capacity): what falls with P.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.core.blocking import sorted_first_occurrence
from nbodysim_tpu_torch.kernels.allpairs import (
    allpairs_accelerations, allpairs_accelerations_plain,
    allpairs_accelerations_wide)
from nbodysim_tpu_torch.kernels.m2l2 import m2l2
from nbodysim_tpu_torch.kernels.nearfield import (
    bucket_stencil, bucket_stencil_plain)
from nbodysim_tpu_torch.parallel import comm
from nbodysim_tpu_torch.physics.barneshut import (
    NEAR_CAP,
    _OVERFLOW_CAP,
    _OVERFLOW_SMALL,
    _bounding_box,
    _cell_ids,
    _deep_near_aggregates,
    _deep_targets,
    _extract_heavy_outliers,
    _fold_aggregate_ring,
    _halo_cap,
    _l2l_upsample,
    _m2l_level,
    _moment_payload,
    _near_masked_blocked,
    _outlier_flat_ids,
    _pool_synth,
    _resolve_deep_levels,
    _resolve_levels,
    _resolve_radius,
    _resolve_tile_params,
    _scatter_cap,
    _synth_quad_channels,
    _taylor_eval,
    _tile_apply,
    _tile_candidates,
    _tile_chain,
    _tile_scatter,
    _tile_select,
    heavy_coupling,
)

# Window-compaction slack: the per-band sorted set holds
# ceil(_BAND_SLACK * N * rows_w / res) rows, a 4x particle imbalance between
# bands, before a band falls back to sorting the whole set.
_BAND_SLACK = 4


def compact_capacity(n: int, rows_w: int, res: int,
                     slack: int | None = None) -> int:
    """Per-band sorted-window capacity C: ceil(slack * n * rows_w / res) + 1,
    rounded up to a multiple of 1024, clamped to n. C >= n means the
    compaction cannot pay for itself and the whole set is sorted. Per-rank
    work is O(n) prep + O(C log C) sort + O(C) field gathers, and
    C -> slack * n * rows_w / res = O(n / P) as res grows
    (rows_w = res / P + 2 (radius - 1))."""
    if slack is None:
        slack = _BAND_SLACK
    cap = min(n, -(-slack * n * rows_w // res) + 1)
    return min(n, -(-cap // 1024) * 1024)


def _kept_halo(cands, s_cap: int) -> torch.Tensor:
    """The rows the single device's tile scatter keeps as halo sources
    (`physics.barneshut._tile_eval`): the first `_halo_cap(m)` rows, in
    index order, on an edge whose neighbour tile is selected, where m is
    the rows it scatters, the compacted source rows (`s_cap`) where they
    fit, else all N. `cands`: `_tile_candidates` (`_tile_candidates3`) of
    every row, home first. Every rank computes it from the same replicated
    arrays, so the banded scatter, over whichever rows it runs, keeps the
    single device's halo: the cap is the one that changes results."""
    on_edge = cands[1][0]
    for ok, _ in cands[2:]:
        on_edge = on_edge | ok
    n = on_edge.shape[0]
    fits = s_cap < n and int((cands[0][0] | on_edge).sum()) <= s_cap
    return on_edge & (torch.cumsum(on_edge, 0)
                      <= _halo_cap(s_cap if fits else n))


def _band_tile_scatter(scatter, pay, bulk_pos, ci_f, tile_slot, orig, geo,
                       kept, in_band, si, valid_d, c_deep: int,
                       axis: comm.Axis) -> torch.Tensor:
    """The tiles' moment grids (`scatter`: `_tile_scatter` or
    `_tile_scatter3`, with `geo` its trailing arguments), halo sources
    limited to `kept`. Without compaction (c_deep >= N) every rank runs the
    full scatter; else each rank scatters its band's particles, over its
    compacted set `si` (`valid_d`; None where it did not fit) when its kept
    halo rows stay under that scatter's own cap, else over all rows masked
    to the band, and one psum sums the disjoint pieces (outside the
    branch)."""
    n = pay.shape[0]
    if c_deep >= n:
        return scatter(pay, bulk_pos, ci_f, tile_slot, orig, *geo,
                       src_mask=kept)
    if si is not None and int((valid_d & kept[si]).sum()) <= _halo_cap(
            c_deep):
        g = scatter(torch.where(valid_d[:, None], pay[si], 0.0),
                    bulk_pos[si], ci_f[si], tile_slot, orig, *geo,
                    src_mask=valid_d & kept[si])
    else:
        g = scatter(torch.where(in_band[:, None], pay, 0.0), bulk_pos, ci_f,
                    tile_slot, orig, *geo, src_mask=in_band & kept)
    return comm.psum(g, axis)


def banded_tree_accelerations(pos_l, mass_l, config: SimConfig,
                              axis: comm.Axis,
                              use_kernels: bool | None = None
                              ) -> torch.Tensor:
    """Tree-code accelerations [N/P, 2] of the local shard (see module).

    Banding needs a power-of-two mesh whose finest band still holds the
    whole M2L halo; otherwise (P = 1, odd meshes, small grids) the tree runs
    replicated (`sharded.replicated_tree_accelerations`). use_kernels
    (default: the tensors lie on a CUDA device) routes the near field to
    K3 and the outlier couplings to K1 and K4, as `bh_accelerations`
    does."""
    p_dev = axis.size
    n_l = pos_l.shape[0]
    n = n_l * p_dev
    levels = _resolve_levels(config, n)
    radius = _resolve_radius(config)
    res = 1 << levels
    p_halo = 2 * radius - 1
    if p_dev == 1 or (p_dev & (p_dev - 1)) or res // p_dev < p_halo:
        from nbodysim_tpu_torch.parallel.sharded import (
            replicated_tree_accelerations)

        banded_tree_accelerations.work = {"replicated": True}
        return replicated_tree_accelerations(pos_l, mass_l, config, axis)

    if use_kernels is None:
        use_kernels = pos_l.device.type == "cuda"
    pos = comm.all_gather(pos_l, axis)
    mass = comm.all_gather(mass_l, axis)
    deep = _resolve_deep_levels(config, levels)
    return _banded_eval(
        pos, mass, pos_l, levels=levels, radius=radius,
        eps_sq=float(config.eps_sq), g_const=float(config.g_const),
        near_cap=NEAR_CAP, axis=axis, use_kernels=use_kernels,
        deep_levels=deep,
        tile_params=_resolve_tile_params(config, deep, radius))


banded_tree_accelerations.work = {}


def _halo_window(band: torch.Tensor, p: int, axis: comm.Axis,
                 cols: int = None) -> torch.Tensor:
    """A row window of a band grid stack: band [k, rb, r] -> [k, rb + 2p,
    r + 2 cols] (cols defaults to p): the band, p halo rows from each ring
    neighbour (zeros at the global edges, where ppermute delivers zeros:
    the single device's zero padding) and `cols` zero columns a side."""
    p_dev = axis.size
    down = [(i, i + 1) for i in range(p_dev - 1)]    # receive from my - 1
    up = [(i + 1, i) for i in range(p_dev - 1)]      # receive from my + 1
    top = comm.ppermute_start(band[:, -p:].contiguous(), axis, down)
    bot = comm.ppermute_start(band[:, :p].contiguous(), axis, up)
    win = torch.cat([top.wait(), band, bot.wait()], 1)
    c = p if cols is None else cols
    return F.pad(win, (c, c)) if c else win


def _banded_eval(pos, mass, pos_l, *, levels, radius, eps_sq, g_const,
                 near_cap, axis, use_kernels=False, deep_levels=0,
                 tile_params=(0, 0, 0)):
    n = pos.shape[0]
    device, dtype = pos.device, pos.dtype
    p_dev, my = axis.size, axis.index
    n_l = pos_l.shape[0]
    res = 1 << levels
    rb = res // p_dev              # bucket-level band rows
    p = 2 * radius - 1             # M2L halo rows
    qh = radius - 1                # the convolution's halo: 2 qh rows
    rr = radius - 1                # near-field halo rows
    row0 = my * rb
    # The deep chain bands like the bucket levels: its rows are rows too.
    deep = deep_levels if deep_levels > levels else 0
    build_levels = deep if deep else levels
    res_b = 1 << build_levels      # finest build resolution
    rb_b = res_b // p_dev
    row0_b = my * rb_b

    ext = _extract_heavy_outliers(pos, mass)
    is_out, out_i, out_sel = ext["is_out"], ext["out_i"], ext["out_sel"]
    tree_mass, bulk_pos = ext["tree_mass"], ext["bulk_pos"]

    corner, size = _bounding_box(bulk_pos)
    ci_f, _ = _cell_ids(bulk_pos, corner, size, res_b)           # [N, 2]
    ci = ci_f >> (build_levels - levels) if deep else ci_f
    flat = ci[:, 0] * res + ci[:, 1]

    # ---------------- pyramid: banded build + coarse replication --------
    # The moment payload of every particle scattered into my band's rows at
    # the finest build level (out-of-band rows go to a dump row), pooled up
    # while the band still holds a halo; the coarsest banded level is
    # all-gathered and the rest pooled replicated.
    wrow = ci_f[:, 0] - row0_b
    in_rows = (wrow >= 0) & (wrow < rb_b)
    bflat = torch.where(in_rows, wrow * res_b + ci_f[:, 1], rb_b * res_b)
    payload = _moment_payload(bulk_pos, tree_mass)
    nch = 3 if deep else 6
    g = torch.zeros((rb_b * res_b + 1, nch), dtype=dtype, device=device)
    g.index_add_(0, bflat, payload[:, :nch])
    g = g[:rb_b * res_b].reshape(rb_b, res_b, nch)
    # Deep mode synthesizes the quadrupoles and pools in `_pool_synth`'s
    # order, as `_build_pyramid(synth_quad=True)` does.
    g6 = _synth_quad_channels(g) if deep else g

    def pool(a):
        """2 x 2 sum-pool of a [rows, cols, 6] band, as `_build_pyramid`
        pools the whole grid."""
        if deep:
            return _pool_synth(a)
        return a.reshape(a.shape[0] // 2, 2, a.shape[1] // 2, 2,
                         6).sum((1, 3))

    shard_levels = [lv for lv in range(2, build_levels + 1)
                    if (1 << lv) % p_dev == 0 and (1 << lv) // p_dev >= p]
    ls = min(shard_levels)         # contiguous {ls..build}
    band = {build_levels: g6}      # [rb_l, r_l, 6] each
    for lv in range(build_levels - 1, ls - 1, -1):
        band[lv] = pool(band[lv + 1])

    full = {}
    if ls > 2:
        gfull = comm.all_gather(band[ls], axis)              # [2^ls, 2^ls]
        for lv in range(ls - 1, 1, -1):
            gfull = pool(gfull)
            full[lv] = gfull

    def chans(g6_):
        return tuple(g6_[..., c] for c in range(6))

    # ---------------- downward pass: M2L + L2L --------------------------
    local = None
    for lv in range(2, ls):                      # replicated coarse levels
        terms = _m2l_level(chans(full[lv]), corner, size, eps_sq, radius)
        if local is None:
            local = terms
        else:
            up = _l2l_upsample(local, size / (1 << lv))
            local = tuple(u + t for u, t in zip(up, terms))

    local_bucket = None
    for lv in range(ls, build_levels + 1):       # banded levels
        r_l = 1 << lv
        rb_l = r_l // p_dev                      # a power of two >= p >= 3
        # `_m2l_level`'s M2L on my rows with 2 qh halo rows a side; rb_l
        # is even, as the parent-level view needs.
        gx = _halo_window(band[lv].permute(2, 0, 1), 2 * qh, axis,
                          cols=0).permute(1, 2, 0)
        terms = m2l2(gx, corner, size, r_l, eps_sq, radius, row0=my * rb_l,
                     rows=rb_l, x0=my * rb_l - 2 * qh)
        if local is None:                        # ls == 2: no coarse prefix
            local = terms
        elif lv == ls:
            # My band's parent rows of the replicated level ls - 1,
            # re-centred to the band's children.
            rb_par = rb_l // 2
            par = tuple(x[my * rb_par:(my + 1) * rb_par] for x in local)
            up = _l2l_upsample(par, size / r_l)
            local = tuple(u + t for u, t in zip(up, terms))
        else:
            up = _l2l_upsample(local, size / r_l)
            local = tuple(u + t for u, t in zip(up, terms))
        if lv == levels:
            local_bucket = local                 # the bucket level's locals
    local_deep = local if deep else None
    local = local_bucket

    # ---------------- far + near field over the sorted window set -------
    s_l = size / res
    rows_w = rb + 2 * rr
    flat_nf = _outlier_flat_ids(flat, is_out, res * res)
    loc9 = torch.stack(local, 0).reshape(9, rb * res)
    work = {"replicated": False, "band_rows": rb, "window_rows": rows_w,
            "k3_launches": 0}

    def field_stage(src, valid_s):
        """Far field (L2P), near field (K3) and the overflow residual of my
        band over the sorted set `src` (indices into the N particles,
        `valid_s` False on padding): the band's contribution, [N, 2]."""
        ll = src.shape[0]
        srcc = torch.clamp(src, max=n - 1)
        flat_s = torch.where(valid_s, flat_nf[srcc], res * res + n)
        slot = torch.arange(ll, device=device) - sorted_first_occurrence(
            flat_s)
        in_cap = slot < near_cap
        pos_s = pos[srcc]
        mass_s = tree_mass[srcc]
        ci_s = ci[srcc]
        is_bulk_s = valid_s & (flat_s < res * res)

        wrow_nf = ci_s[:, 0] - row0 + rr
        in_win = is_bulk_s & (wrow_nf >= 0) & (wrow_nf < rows_w)
        col_s = ci_s[:, 1]
        brow = ci_s[:, 0] - row0
        tgt_band = is_bulk_s & (brow >= 0) & (brow < rb)
        g_mask = tgt_band & in_cap
        slot_c = torch.clamp(slot, max=near_cap - 1)

        # The window grid [rows_w, res, K] (my rows and rr halo rows a
        # side), its slots filled as `_bucket_grid` fills the whole grid,
        # and its counts from the same scatter.
        live = in_win & in_cap
        cells = rows_w * res
        wflat = torch.where(live, wrow_nf * res + col_s, cells)
        dest = wflat * near_cap + torch.where(live, slot, 0)

        def scat(v):
            b = torch.zeros(cells * near_cap + near_cap, dtype=dtype,
                            device=device)
            b[dest] = v
            return b[:cells * near_cap].reshape(rows_w, res, near_cap)

        bx, by = scat(pos_s[:, 0]), scat(pos_s[:, 1])
        bm = scat(torch.where(in_cap, mass_s, 0.0))
        if use_kernels:
            counts = torch.zeros(cells + 1, dtype=torch.int32,
                                 device=device)
            counts.index_add_(0, wflat, torch.ones_like(wflat,
                                                        dtype=torch.int32))
            counts = counts[:cells].reshape(rows_w, res)
            accx, accy = bucket_stencil(bx, by, bm, counts=counts, rr=rr,
                                        eps_sq=eps_sq, center_rows=rb)
            work["k3_launches"] += 1
        else:
            accx, accy = bucket_stencil_plain(bx, by, bm, rr, eps_sq, rb)
        gidx = (torch.clamp(brow, 0, rb - 1) * res + col_s) * near_cap \
            + slot_c
        acc_s = torch.stack(
            [torch.where(g_mask, a.reshape(-1)[gidx], 0.0)
             for a in (accx, accy)], -1)

        # ---- per-band overflow residual --------------------------------
        # Every (target, overflow-source) direction on exactly one rank:
        # (b) my band's targets <- the window's overflow sources; (c) my
        # band's overflow targets <- all in-cap sources (cheb <= rr). The
        # deep path covers the overflow targets instead.
        over_w = (~in_cap) & in_win
        n_over = int(over_w.sum())
        if not deep and n_over > 0:
            m_cap = min(ll, _OVERFLOW_CAP)
            m_small = min(ll, _OVERFLOW_SMALL)
            cap_k = m_cap if n_over > m_small or m_small >= m_cap \
                else m_small
            block = 32768 if device.type == "cuda" else 2048
            o_idx = torch.argsort((~over_w).to(torch.int32),
                                  stable=True)[:cap_k]
            o_valid = over_w[o_idx]
            o_pos = pos_s[o_idx]
            o_mass = torch.where(o_valid, mass_s[o_idx], 0.0)
            o_cell = ci_s[o_idx]
            dp = _near_masked_blocked(pos_s, ci_s, o_pos, o_mass, o_cell,
                                      eps_sq, rr, block)
            acc_s = acc_s + torch.where(tgt_band[:, None], dp, 0.0)
            o_band = (o_valid & (o_cell[:, 0] >= row0)
                      & (o_cell[:, 0] < row0 + rb))
            cap_mass = torch.where(in_cap & is_bulk_s, mass_s, 0.0)
            o_acc = _near_masked_blocked(o_pos, o_cell, pos_s, cap_mass,
                                         ci_s, eps_sq, rr, block)
            acc_s = acc_s.index_add(
                0, o_idx, torch.where(o_band[:, None], o_acc, 0.0))

        # ---- far-field L2P on my band's rows of the window set ----------
        lr = torch.clamp(brow, 0, rb - 1)
        cellx, celly = ci_s[:, 0], ci_s[:, 1]
        centx = corner[0] + (cellx.to(dtype) + 0.5) * s_l
        centy = corner[1] + (celly.to(dtype) + 0.5) * s_l
        gl = loc9[:, lr * res + celly]                         # [9, L]
        far_x, far_y = _taylor_eval(tuple(gl[i] for i in range(9)),
                                    pos_s[:, 0] - centx, pos_s[:, 1] - centy)
        far = torch.stack([far_x, far_y], -1)
        total = g_const * (torch.where(tgt_band[:, None], far, 0.0) + acc_s)
        out = torch.zeros((n + 1, 2), dtype=dtype, device=device)
        out.index_add_(0, torch.where(valid_s, src, n),
                       torch.where(valid_s[:, None], total, 0.0))
        return out[:n]

    in_win_u = ((~is_out) & (ci[:, 0] - row0 >= -rr)
                & (ci[:, 0] - row0 < rb + rr))
    c_cap = compact_capacity(n, rows_w, res)
    work["window_capacity"] = c_cap
    all_valid = torch.ones(n, dtype=torch.bool, device=device)
    if c_cap < n:
        n_win = int(in_win_u.sum())
        work["window_particles"] = n_win
    if c_cap < n and n_win <= c_cap:
        rank = torch.cumsum(in_win_u, 0) - 1
        widx = torch.full((c_cap + 1,), n, dtype=torch.int64, device=device)
        widx[torch.where(in_win_u & (rank < c_cap), rank, c_cap)] = \
            torch.arange(n, device=device)
        widx = widx[:c_cap]
        keys = torch.where(widx < n, flat_nf[torch.clamp(widx, max=n - 1)],
                           res * res + n)
        oc = torch.argsort(keys, stable=True)
        work["sorted_len"] = c_cap
        contrib = field_stage(widx[oc], widx[oc] < n)
    else:
        work["sorted_len"] = n
        contrib = field_stage(torch.argsort(flat_nf, stable=True), all_valid)

    lrow = ci[:, 0] - row0
    in_band = (lrow >= 0) & (lrow < rb) & ~is_out

    # ---------------- deep-overflow path (banded) -----------------------
    # The same targets as the single device (the occupancy over the whole
    # bucket grid is replicated bookkeeping); the deep L2P and the smoothed
    # aggregates run on my band's rows, over a compacted band set where it
    # fits, with rr-row halos for the aggregate windows.
    if deep:
        b_par = _deep_targets(flat_nf, flat, is_out, res, near_cap, radius)
        rrd = radius - 1
        # The cheb >= 2 aggregate ring folded into the deep locals; the
        # tiles slice the UN-folded local_deep. Halos exchange here, outside
        # every branch.
        if rrd >= 2:
            wring = _halo_window(band[build_levels].permute(2, 0, 1), rrd,
                                 axis)
            local_agg = _fold_aggregate_ring(
                local_deep, tuple(wring), corner, size, res_b, eps_sq,
                radius, row0=row0_b, rows=rb_b)
        else:
            local_agg = local_deep
        s_d = size / res_b
        rin = min(rrd, 1)
        gp = _halo_window(band[build_levels][..., :3].permute(2, 0, 1), rin,
                          axis).permute(1, 2, 0)  # [rb_b + 2rin, ..., 3]
        pay = _moment_payload(pos, tree_mass)
        locd = torch.stack(local_agg, 0).reshape(9, rb_b * res_b)

        def deep_eval(pos_s, pay3_s, ci_f_s):
            """g_const * (deep L2P + inner 3 x 3 aggregates) of rows."""
            lrow_d = torch.clamp(ci_f_s[:, 0] - row0_b, 0, rb_b - 1)
            cx = corner[0] + (ci_f_s[:, 0].to(dtype) + 0.5) * s_d
            cy = corner[1] + (ci_f_s[:, 1].to(dtype) + 0.5) * s_d
            gd = locd[:, lrow_d * res_b + ci_f_s[:, 1]]          # [9, C]
            fdx, fdy = _taylor_eval(tuple(gd[i] for i in range(9)),
                                    pos_s[:, 0] - cx, pos_s[:, 1] - cy)
            near_d = _deep_near_aggregates(pos_s, pay3_s, gp, ci_f_s,
                                           eps_sq, s_d, rin, row0=row0_b)
            return g_const * (torch.stack([fdx, fdy], -1) + near_d)

        c_deep = compact_capacity(n, rb, res)
        work["deep_capacity"] = c_deep
        compact_deep = False
        if c_deep < n:
            n_band = int(in_band.sum())
            work["deep_band_particles"] = n_band
            compact_deep = n_band <= c_deep
        if compact_deep:
            rank_d = torch.cumsum(in_band, 0) - 1
            didx = torch.full((c_deep + 1,), n, dtype=torch.int64,
                              device=device)
            didx[torch.where(in_band & (rank_d < c_deep), rank_d, c_deep)] = \
                torch.arange(n, device=device)
            didx = didx[:c_deep]
            valid_d = didx < n
            si = torch.clamp(didx, max=n - 1)
            vals = deep_eval(pos[si], pay[si, :3], ci_f[si])
            sel = valid_d & b_par[si]
            # Unique rows: a set is the full branch's where-replacement.
            contrib = torch.cat([contrib, contrib.new_zeros(1, 2)])
            contrib[torch.where(sel, si, n)] = vals
            contrib = contrib[:n]
        else:
            deep_part = torch.where(in_band[:, None],
                                    deep_eval(pos, pay[:, :3], ci_f), 0.0)
            contrib = torch.where((b_par & in_band)[:, None], deep_part,
                                  contrib)

        # ---- hot-zone tiles under banding ------------------------------
        # Tile selection and the per-tile chain are replicated (small
        # grids); my band's rows of every tile window of the level-D locals
        # (zeros elsewhere) and one psum assemble what the single device
        # slices from the whole grid. The tile grids' moments are scattered
        # per band, with the single device's halo sources, and psummed; the
        # refined targets are evaluated on my band's rows.
        tk, tt, tc = tile_params
        if tk:
            hh = radius
            ww = tt + 2 * hh
            _, tile_slot, orig = _tile_select(ci_f, b_par, build_levels, tt,
                                              tc, radius)
            locb = F.pad(torch.stack(local_deep, -1),
                         (0, 0, hh, hh))                 # [rb_b, res_b+2hh, 9]
            span = torch.arange(ww, device=device)
            grow = orig[:, 0, None] + span - row0_b      # [T, W] band rows
            ok = (grow >= 0) & (grow < rb_b)
            gcol = orig[:, 1, None] + hh + span          # [T, W]
            sl = locb[torch.clamp(grow, 0, rb_b - 1)[:, :, None],
                      gcol[:, None, :]]                  # [T, W, W, 9]
            local_w = comm.psum(torch.where(ok[:, :, None, None], sl, 0.0),
                                axis)

            geo = (corner, size, build_levels, radius, tk, tt, tc)
            kept = _kept_halo(_tile_candidates(ci_f, tile_slot, tt, tc,
                                               radius, res_b // tt),
                              _scatter_cap(n))
            g3k = _band_tile_scatter(
                _tile_scatter, pay, bulk_pos, ci_f, tile_slot, orig, geo,
                kept, in_band, si if compact_deep else None,
                valid_d if compact_deep else None, c_deep, axis)
            local_w = _tile_chain(local_w, g3k, orig, corner, size,
                                  build_levels, radius, eps_sq, tk, tt, tc)
            if compact_deep:
                refined_s, far_s, near_s = _tile_apply(
                    pos[si], pay[si], bulk_pos[si], ci_f[si], b_par[si],
                    local_w, g3k, tile_slot, orig, corner, size,
                    build_levels, radius, eps_sq, tk, tt, tc)
                sel = valid_d & refined_s
                contrib = torch.cat([contrib, contrib.new_zeros(1, 2)])
                contrib[torch.where(sel, si, n)] = g_const * (far_s + near_s)
                contrib = contrib[:n]
            else:
                refined, far_ref, near_ref = _tile_apply(
                    pos, pay, bulk_pos, ci_f, b_par, local_w, g3k, tile_slot,
                    orig, corner, size, build_levels, radius, eps_sq, tk, tt,
                    tc)
                ref_part = torch.where(in_band[:, None],
                                       g_const * (far_ref + near_ref), 0.0)
                contrib = torch.where((refined & in_band)[:, None],
                                      ref_part, contrib)

    # ---------------- exact forces ON outliers (index-range sharded) ----
    k_out = out_i.shape[0]
    ko_p = -(-k_out // p_dev)
    idx = my * ko_p + torch.arange(ko_p, device=device)
    valid = idx < k_out
    oi = out_i[torch.clamp(idx, max=k_out - 1)]
    non_heavy = torch.where(ext["is_heavy"], 0.0, mass)
    direct = allpairs_accelerations if use_kernels else \
        allpairs_accelerations_plain
    acc_out = direct(pos[oi], None, eps_sq=eps_sq, g_const=g_const,
                     src_pos=pos, src_mass=non_heavy)
    sel = valid & out_sel[torch.clamp(idx, max=k_out - 1)]
    contrib = contrib.index_add(0, oi, torch.where(sel[:, None], acc_out,
                                                   0.0))

    # ---------------- combine: psum of disjoint pieces + local terms ----
    acc_g = comm.psum(contrib, axis)
    rows = slice(my * n_l, (my + 1) * n_l)
    out_src_mass = torch.where(out_sel & ~ext["is_heavy"][out_i],
                               mass[out_i], 0.0)
    if use_kernels:
        acc_from_out_l = allpairs_accelerations_wide(
            pos_l, pos[out_i], out_src_mass, eps_sq=eps_sq, g_const=g_const)
    else:
        acc_from_out_l = allpairs_accelerations_plain(
            pos_l, None, eps_sq=eps_sq, g_const=g_const, src_pos=pos[out_i],
            src_mass=out_src_mass)
    acc_heavy_l = heavy_coupling(pos_l, ext["h_pos"], ext["h_mass"], eps_sq,
                                 g_const)
    banded_tree_accelerations.work = work
    return (acc_g[rows]
            + torch.where(is_out[rows][:, None], 0.0, acc_from_out_l)
            + acc_heavy_l)
