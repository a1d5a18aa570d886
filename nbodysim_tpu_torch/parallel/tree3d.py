"""The banded multi-device octree: the 3D tree code sharded by x-slabs (port
of `nbodysim_tpu.parallel.tree3d`).

The 3D instance of `parallel/tree.py`, whose docstring gives the design:
every pyramid level's x-slabs are banded over the 1-D mesh; each rank runs
the M2L (`kernels/m2l3.py`) and the near field (K7) on its own band, the
halo slabs move between ring neighbours (`comm.ppermute`, one exchange a
level), and the coarse levels that cannot band are all-gathered and
computed replicated. The cell sort, the bucket scatter, the near field and
the L2P run over a compacted per-band window set, the whole set sorted
where the window overfills it (a host branch on one count).

Decomposition of `physics/barneshut._bh_accelerations` (the octree's stages)
across the mesh:

  heavy coupling           -> local rows                      (after psum)
  bulk <- outliers (K4)    -> local rows                      (after psum)
  outliers <- all (K1)     -> outlier-index range per rank    (in psum)
  far field (M2L+L2L+L2P)  -> x-slab band per rank            (in psum)
  near field (K7)          -> x-slab band (+ halo slabs)      (in psum)
  overflow residual        -> per-band window overflow sets   (in psum)
  deep chain and tiles     -> deep-level slab bands           (in psum)

The near field is always the dense bucket grid through K7, as in the JAX
package's banded octree: where the single device would take the sparse
near field (`bh_nf_sparse`, the 3D merger), the banded octree runs K7 on
its band window instead, and its bucket-tier targets get the grid's near
field. Each contribution is computed on one rank into a full-length [N, 3]
buffer and one `psum` sums the pieces, so the result matches the single
device's octree to roundoff wherever the single device runs the dense grid.

`banded_tree3_accelerations.work` holds the last call's work counts on this
rank (band slabs, window slabs, window capacity, the length of the set it
sorted, K7's launches, the deep band's capacity): what falls with P.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.core.blocking import sorted_first_occurrence
from nbodysim_tpu_torch.kernels.allpairs import (
    allpairs_accelerations, allpairs_accelerations_plain,
    allpairs_accelerations_wide)
from nbodysim_tpu_torch.kernels.m2l3 import m2l3
from nbodysim_tpu_torch.kernels.nearfield import (
    bucket_stencil3, bucket_stencil3_plain)
from nbodysim_tpu_torch.parallel import comm
from nbodysim_tpu_torch.parallel.tree import (
    _band_tile_scatter, _kept_halo, compact_capacity)
from nbodysim_tpu_torch.physics.barneshut import (
    NEAR_CAP,
    _OVERFLOW_CAP,
    _OVERFLOW_SMALL,
    _bounding_box,
    _cell_ids,
    _compact_indices,
    _extract_heavy_outliers,
    _near_masked_blocked,
    _outlier_flat_ids,
    heavy_coupling,
)
from nbodysim_tpu_torch.physics.barneshut3d import (
    _deep_near_aggregates3,
    _deep_targets3,
    _fold_aggregate_ring3,
    _l2l_upsample3,
    _m2l_level3,
    _moment_payload3,
    _pool2x3,
    _resolve_deep_levels3,
    _resolve_levels3,
    _resolve_radius3,
    _resolve_tile_params3,
    _scatter_cap3,
    _synth_quad_channels3,
    _taylor_eval3,
    _tile_apply3,
    _tile_candidates3,
    _tile_chain3,
    _tile_scatter3,
    _tile_select3,
)


def banded_tree3_accelerations(pos_l, mass_l, config: SimConfig,
                               axis: comm.Axis,
                               use_kernels: bool | None = None
                               ) -> torch.Tensor:
    """Octree accelerations [N/P, 3] of the local shard (see module).

    Banding needs a power-of-two mesh whose finest band still holds the
    whole M2L halo; otherwise (P = 1, odd meshes, small grids) the octree
    runs replicated (`sharded.replicated_tree_accelerations`). use_kernels
    (default: the tensors lie on a CUDA device) routes the near field to
    K7 and the outlier couplings to K1 and K4, as `bh3_accelerations`
    does."""
    p_dev = axis.size
    n_l = pos_l.shape[0]
    n = n_l * p_dev
    levels = _resolve_levels3(config, n)
    radius = _resolve_radius3(config)
    res = 1 << levels
    if p_dev == 1 or (p_dev & (p_dev - 1)) or res // p_dev < 2 * radius - 1:
        from nbodysim_tpu_torch.parallel.sharded import (
            replicated_tree_accelerations)

        banded_tree3_accelerations.work = {"replicated": True}
        return replicated_tree_accelerations(pos_l, mass_l, config, axis)

    if use_kernels is None:
        use_kernels = pos_l.device.type == "cuda"
    pos = comm.all_gather(pos_l, axis)
    mass = comm.all_gather(mass_l, axis)
    deep = _resolve_deep_levels3(config, levels)
    return _banded_eval3(
        pos, mass, pos_l, levels=levels, radius=radius,
        eps_sq=float(config.eps_sq), g_const=float(config.g_const),
        near_cap=NEAR_CAP, axis=axis, use_kernels=use_kernels,
        deep_levels=deep,
        tile_params=_resolve_tile_params3(config, deep, radius))


banded_tree3_accelerations.work = {}


def _halo_window3(band: torch.Tensor, p: int, axis: comm.Axis,
                  faces: int) -> torch.Tensor:
    """An x-slab window of a band grid: band [rb, r, r, C] -> [rb + 2p,
    r + 2 faces, r + 2 faces, C]: the band, p halo slabs from each ring
    neighbour (zeros at the global edges, where ppermute delivers zeros:
    the single device's zero padding) and `faces` zero y/z faces."""
    p_dev = axis.size
    down = [(i, i + 1) for i in range(p_dev - 1)]    # receive from my - 1
    up = [(i + 1, i) for i in range(p_dev - 1)]      # receive from my + 1
    top = comm.ppermute_start(band[-p:].contiguous(), axis, down)
    bot = comm.ppermute_start(band[:p].contiguous(), axis, up)
    win = torch.cat([top.wait(), band, bot.wait()], 0)
    return F.pad(win, (0, 0) + (faces, faces) * 2) if faces else win


def _banded_eval3(pos, mass, pos_l, *, levels, radius, eps_sq, g_const,
                  near_cap, axis, use_kernels=False, deep_levels=0,
                  tile_params=(0, 0, 0)):
    n = pos.shape[0]
    device, dtype = pos.device, pos.dtype
    p_dev, my = axis.size, axis.index
    n_l = pos_l.shape[0]
    res = 1 << levels
    rb = res // p_dev              # bucket-level band slabs
    p = 2 * radius - 1             # M2L halo slabs
    qh = radius - 1                # the M2L's halo: 2 qh slabs
    rr = radius - 1                # near-field halo slabs
    row0 = my * rb
    # The deep chain bands like the bucket levels.
    deep = deep_levels if deep_levels > levels else 0
    build_levels = deep if deep else levels
    res_b = 1 << build_levels      # finest build resolution
    rb_b = res_b // p_dev
    row0_b = my * rb_b

    ext = _extract_heavy_outliers(pos, mass)
    is_out, out_i, out_sel = ext["is_out"], ext["out_i"], ext["out_sel"]
    tree_mass, bulk_pos = ext["tree_mass"], ext["bulk_pos"]

    corner, size = _bounding_box(bulk_pos)
    ci_f, _ = _cell_ids(bulk_pos, corner, size, res_b)           # [N, 3]
    ci = ci_f >> (build_levels - levels) if deep else ci_f
    flat = (ci[:, 0] * res + ci[:, 1]) * res + ci[:, 2]

    # ---------------- pyramid: banded build + coarse replication --------
    # The moment payload of every particle scattered into my band's slabs
    # at the finest build level (out-of-band slabs go to a dump row),
    # pooled up while the band still holds a halo; the coarsest banded
    # level is all-gathered and the rest pooled replicated. Deep mode
    # synthesizes the quadrupoles and pools in `_pool2x3`'s order, as
    # `_build_pyramid3(synth_quad=True)` does.
    wrow = ci_f[:, 0] - row0_b
    in_rows = (wrow >= 0) & (wrow < rb_b)
    cells_b = rb_b * res_b * res_b
    bflat = torch.where(in_rows, (wrow * res_b + ci_f[:, 1]) * res_b
                        + ci_f[:, 2], cells_b)
    nch = 4 if deep else 10
    g = torch.zeros((cells_b + 1, nch), dtype=dtype, device=device)
    g.index_add_(0, bflat, _moment_payload3(bulk_pos, tree_mass)[:, :nch])
    g = g[:cells_b].reshape(rb_b, res_b, res_b, nch)
    g10 = _synth_quad_channels3(g) if deep else g

    def pool(a):
        """2 x 2 x 2 sum-pool of a [x, r, r, 10] band, as `_build_pyramid3`
        pools the whole grid."""
        if deep:
            return _pool2x3(a)
        x, r = a.shape[0] // 2, a.shape[1] // 2
        return a.reshape(x, 2, r, 2, r, 2, 10).sum((1, 3, 5))

    shard_levels = [lv for lv in range(2, build_levels + 1)
                    if (1 << lv) % p_dev == 0 and (1 << lv) // p_dev >= p]
    ls = min(shard_levels)         # contiguous {ls..build}
    band = {build_levels: g10}     # [rb_l, r_l, r_l, 10] each
    for lv in range(build_levels - 1, ls - 1, -1):
        band[lv] = pool(band[lv + 1])

    full = {}
    if ls > 2:
        gfull = comm.all_gather(band[ls], axis)         # [2^ls]^3 x 10
        for lv in range(ls - 1, 1, -1):
            gfull = pool(gfull)
            full[lv] = gfull

    def chans(g10_):
        return tuple(g10_[..., c] for c in range(10))

    # ---------------- downward pass: M2L + L2L --------------------------
    local = None
    for lv in range(2, ls):                      # replicated coarse levels
        terms = _m2l_level3(chans(full[lv]), corner, size, eps_sq, radius)
        if local is None:
            local = terms
        else:
            up = _l2l_upsample3(local, size / (1 << lv))
            local = tuple(u + t for u, t in zip(up, terms))

    local_bucket = None
    for lv in range(ls, build_levels + 1):       # banded levels
        r_l = 1 << lv
        rb_l = r_l // p_dev                      # a power of two >= p >= 3
        # `_m2l_level3`'s M2L on my slabs with 2 qh halo slabs a side; rb_l
        # is even, as the parent-level view needs.
        gx = _halo_window3(band[lv], 2 * qh, axis, faces=0)
        terms = m2l3(gx, corner, size, r_l, eps_sq, radius, row0=my * rb_l,
                     rows=rb_l, x0=my * rb_l - 2 * qh)
        if local is None:                        # ls == 2: no coarse prefix
            local = terms
        elif lv == ls:
            # My band's parent slabs of the replicated level ls - 1,
            # re-centred to the band's children.
            rb_par = rb_l // 2
            par = tuple(x[my * rb_par:(my + 1) * rb_par] for x in local)
            up = _l2l_upsample3(par, size / r_l)
            local = tuple(u + t for u, t in zip(up, terms))
        else:
            up = _l2l_upsample3(local, size / r_l)
            local = tuple(u + t for u, t in zip(up, terms))
        if lv == levels:
            local_bucket = local                 # the bucket level's locals
    local_deep = local if deep else None
    local = local_bucket

    # ---------------- far + near field over the sorted window set -------
    s_l = size / res
    rows_w = rb + 2 * rr
    flat_nf = _outlier_flat_ids(flat, is_out, res ** 3)
    loc19 = torch.stack(local, 0).reshape(19, rb * res * res)
    work = {"replicated": False, "band_rows": rb, "window_rows": rows_w,
            "k7_launches": 0}

    def field_stage(src, valid_s):
        """Far field (L2P), near field (K7) and the overflow residual of my
        band over the sorted set `src` (indices into the N particles,
        `valid_s` False on padding): the band's contribution, [N, 3]."""
        ll = src.shape[0]
        srcc = torch.clamp(src, max=n - 1)
        flat_s = torch.where(valid_s, flat_nf[srcc], res ** 3 + n)
        slot = torch.arange(ll, device=device) - sorted_first_occurrence(
            flat_s)
        in_cap = slot < near_cap
        pos_s = pos[srcc]
        mass_s = tree_mass[srcc]
        ci_s = ci[srcc]
        is_bulk_s = valid_s & (flat_s < res ** 3)

        wrow_nf = ci_s[:, 0] - row0 + rr
        in_win = is_bulk_s & (wrow_nf >= 0) & (wrow_nf < rows_w)
        brow = ci_s[:, 0] - row0
        tgt_band = is_bulk_s & (brow >= 0) & (brow < rb)
        g_mask = tgt_band & in_cap
        slot_c = torch.clamp(slot, max=near_cap - 1)

        # The window grid [rows_w, res, res, K] (my slabs and rr halo slabs
        # a side), its slots filled as `_bucket_grid` fills the whole grid,
        # and its counts from the same scatter.
        live = in_win & in_cap
        cells = rows_w * res * res
        wflat = torch.where(
            live, (wrow_nf * res + ci_s[:, 1]) * res + ci_s[:, 2], cells)
        dest = wflat * near_cap + torch.where(live, slot, 0)

        def scat(v):
            b = torch.zeros(cells * near_cap + near_cap, dtype=dtype,
                            device=device)
            b[dest] = v
            return b[:cells * near_cap].reshape(rows_w, res, res, near_cap)

        grid = (scat(pos_s[:, 0]), scat(pos_s[:, 1]), scat(pos_s[:, 2]),
                scat(torch.where(in_cap, mass_s, 0.0)))
        if use_kernels:
            counts = torch.zeros(cells + 1, dtype=torch.int32, device=device)
            counts.index_add_(0, wflat, torch.ones_like(wflat,
                                                        dtype=torch.int32))
            counts = counts[:cells].reshape(rows_w, res, res)
            acc3 = bucket_stencil3(*grid, counts=counts, rr=rr,
                                   eps_sq=eps_sq, center_rows=rb)
            work["k7_launches"] += 1
        else:
            acc3 = bucket_stencil3_plain(*grid, rr, eps_sq, rb)
        gidx = (((torch.clamp(brow, 0, rb - 1) * res + ci_s[:, 1]) * res
                 + ci_s[:, 2]) * near_cap + slot_c)
        acc_s = torch.stack(
            [torch.where(g_mask, a.reshape(-1)[gidx], 0.0) for a in acc3],
            -1)

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

        # ---- far-field L2P on my band's slabs of the window set ---------
        lr = torch.clamp(brow, 0, rb - 1)
        cent = corner + (ci_s.to(dtype) + 0.5) * s_l
        d = pos_s - cent
        gl = loc19[:, (lr * res + ci_s[:, 1]) * res + ci_s[:, 2]]  # [19, L]
        ev = _taylor_eval3(tuple(gl[i] for i in range(19)), d[:, 0],
                           d[:, 1], d[:, 2])
        far = torch.stack(ev[:3], -1)
        total = g_const * (torch.where(tgt_band[:, None], far, 0.0) + acc_s)
        out = torch.zeros((n + 1, 3), dtype=dtype, device=device)
        out.index_add_(0, torch.where(valid_s, src, n),
                       torch.where(valid_s[:, None], total, 0.0))
        return out[:n]

    in_win_u = ((~is_out) & (ci[:, 0] - row0 >= -rr)
                & (ci[:, 0] - row0 < rb + rr))
    c_cap = compact_capacity(n, rows_w, res)
    work["window_capacity"] = c_cap
    compact = False
    if c_cap < n:
        n_win = int(in_win_u.sum())
        work["window_particles"] = n_win
        compact = n_win <= c_cap
    if compact:
        widx, _ = _compact_indices(in_win_u, c_cap)
        keys = torch.where(widx < n, flat_nf[torch.clamp(widx, max=n - 1)],
                           res ** 3 + n)
        oc = torch.argsort(keys, stable=True)
        work["sorted_len"] = c_cap
        contrib = field_stage(widx[oc], widx[oc] < n)
    else:
        work["sorted_len"] = n
        contrib = field_stage(torch.argsort(flat_nf, stable=True),
                              torch.ones(n, dtype=torch.bool, device=device))

    lrow = ci[:, 0] - row0
    in_band = (lrow >= 0) & (lrow < rb) & ~is_out

    # ---------------- deep-overflow path (banded) -----------------------
    # The same targets as the single device (the occupancy over the whole
    # bucket grid is replicated bookkeeping); the deep L2P and the smoothed
    # aggregates run on my band's slabs, over a compacted band set where it
    # fits, with rr-slab halos for the aggregate windows.
    if deep:
        b_par, _ = _deep_targets3(flat_nf, flat, is_out, res, near_cap,
                                  radius)
        rrd = radius - 1
        # The cheb >= 2 aggregate shell folded into the deep locals; the
        # tiles slice the UN-folded local_deep. Halos exchange here, outside
        # every branch.
        if rrd >= 2:
            wring = _halo_window3(band[build_levels], rrd, axis, faces=rrd)
            local_agg = _fold_aggregate_ring3(
                local_deep, tuple(wring[..., c] for c in range(10)), corner,
                size, res_b, eps_sq, radius, row0=row0_b, rows=rb_b)
        else:
            local_agg = local_deep
        s_d = size / res_b
        rin = min(rrd, 1)
        gpw = _halo_window3(band[build_levels][..., :4].contiguous(), rin,
                            axis, faces=rin)    # [rb_b + 2rin, ..., 4]
        pay = _moment_payload3(pos, tree_mass)
        locd = torch.stack(local_agg, 0).reshape(19, rb_b * res_b * res_b)

        def deep_eval(pos_s, pay4_s, ci_f_s):
            """g_const * (deep L2P + inner 3^3 aggregates) of rows."""
            lrow_d = torch.clamp(ci_f_s[:, 0] - row0_b, 0, rb_b - 1)
            cent_d = corner + (ci_f_s.to(dtype) + 0.5) * s_d
            d = pos_s - cent_d
            gd = locd[:, (lrow_d * res_b + ci_f_s[:, 1]) * res_b
                      + ci_f_s[:, 2]]                           # [19, C]
            evd = _taylor_eval3(tuple(gd[i] for i in range(19)), d[:, 0],
                                d[:, 1], d[:, 2])
            near_d = _deep_near_aggregates3(pos_s, pay4_s, gpw, ci_f_s,
                                            eps_sq, s_d, rin, row0=row0_b)
            return g_const * (torch.stack(evd[:3], -1) + near_d)

        c_deep = compact_capacity(n, rb, res)
        work["deep_capacity"] = c_deep
        compact_deep = False
        if c_deep < n:
            n_band = int(in_band.sum())
            work["deep_band_particles"] = n_band
            compact_deep = n_band <= c_deep
        if compact_deep:
            didx, _ = _compact_indices(in_band, c_deep)
            valid_d = didx < n
            si = torch.clamp(didx, max=n - 1)
            vals = deep_eval(pos[si], pay[si, :4], ci_f[si])
            sel = valid_d & b_par[si]
            # Unique rows: a set is the full branch's where-replacement.
            contrib = torch.cat([contrib, contrib.new_zeros(1, 3)])
            contrib[torch.where(sel, si, n)] = vals
            contrib = contrib[:n]
        else:
            deep_part = torch.where(in_band[:, None],
                                    deep_eval(pos, pay[:, :4], ci_f), 0.0)
            contrib = torch.where((b_par & in_band)[:, None], deep_part,
                                  contrib)

        # ---- hot-zone tiles under banding ------------------------------
        # Tile selection and the per-tile chain are replicated (small
        # grids); my band's slabs of every tile window of the level-D
        # locals (zeros elsewhere) and one psum assemble what the single
        # device slices from the whole grid. The tile grids' moments are
        # scattered per band, with the single device's halo sources, and
        # psummed; the refined targets are evaluated on my band's slabs.
        tk, tt, tc = tile_params
        if tk:
            hh = radius
            ww = tt + 2 * hh
            _, tile_slot, orig = _tile_select3(ci_f, b_par, build_levels, tt,
                                               tc, radius)
            span = torch.arange(ww, device=device)
            grow = orig[:, 0, None] + span - row0_b      # [T, W] band slabs
            ok = (grow >= 0) & (grow < rb_b)
            ix = torch.clamp(grow, 0, rb_b - 1)[:, :, None, None]
            iy = (orig[:, 1, None] + hh + span)[:, None, :, None]
            iz = (orig[:, 2, None] + hh + span)[:, None, None, :]
            okw = ok[:, :, None, None]
            local_w = comm.psum(torch.stack(
                [torch.where(okw, F.pad(lg, (hh,) * 4)[ix, iy, iz], 0.0)
                 for lg in local_deep], -1), axis)       # [T, W, W, W, 19]

            geo = (corner, size, build_levels, radius, tk, tt, tc)
            kept = _kept_halo(_tile_candidates3(ci_f, tile_slot, tt, tc,
                                                radius, res_b // tt),
                              _scatter_cap3(n))
            g4k = _band_tile_scatter(
                _tile_scatter3, pay, bulk_pos, ci_f, tile_slot, orig, geo,
                kept, in_band, si if compact_deep else None,
                valid_d if compact_deep else None, c_deep, axis)
            local_w = _tile_chain3(local_w, g4k, orig, corner, size,
                                   build_levels, radius, eps_sq, tk, tt, tc)
            if compact_deep:
                refined_s, far_s, near_s = _tile_apply3(
                    pos[si], pay[si], bulk_pos[si], ci_f[si], b_par[si],
                    local_w, g4k, tile_slot, orig, corner, size,
                    build_levels, radius, eps_sq, tk, tt, tc)
                sel = valid_d & refined_s
                contrib = torch.cat([contrib, contrib.new_zeros(1, 3)])
                contrib[torch.where(sel, si, n)] = g_const * (far_s + near_s)
                contrib = contrib[:n]
            else:
                refined, far_ref, near_ref = _tile_apply3(
                    pos, pay, bulk_pos, ci_f, b_par, local_w, g4k, tile_slot,
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
    banded_tree3_accelerations.work = work
    return (acc_g[rows]
            + torch.where(is_out[rows][:, None], 0.0, acc_from_out_l)
            + acc_heavy_l)
