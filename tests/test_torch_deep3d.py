"""PyTorch port, the 3D deep-overflow chain, its hot-zone tiles and the
sparse near field (`physics/barneshut3d.py`) against the JAX package on the
CPU.

The scene is the JAX tests' clustered blob (sigma 40 at (500, -300, 200),
half the bodies, in a +-2000 background; `scenes.blob.clustered_blob`,
drawn with numpy), at N = 4096 with levels 3 and deep 5. Integer and
boolean stages (the deep-path targets `b_par`, the tile ids, slots and
origins, the sub-level cells, the refined set, the compaction indices, the
halo cap of `_tile_scatter3`, `bh3_bucket_tier_count`) must equal JAX's
exactly. Float stages are held to 1e-5 * max|x| of JAX's function on the
same inputs, and the whole force evaluation to 1e-5 * max|a| of jitted
JAX in four cases: R = 2 with and without tiles, R = 3 (the aggregate
ring fold runs) and the sparse near field with tiles. Unlike in 2D, jitted
JAX serves as the reference: in 3D it differs from JAX run op by op by
~3e-6 * max|a| on this scene, and the port from jitted JAX by ~3e-6. The
port pools the synthesized grids in the JAX package's CPU order
(`_pool2x3` for the pyramid, `_pool_seq3` for the tiles).

Then the JAX package's contract tests (tests/test_deep_overflow.py), held
by the port: the chain is inert without overflow, background rows keep
exact-tier accuracy and the blob stays bounded (R = 2 and 3), and the
compacted passes equal the full ones bit for bit; the trimmed sparse pass
equals the padded one; 'auto' resolves the users' 3D scenes as JAX does.
"""

import functools
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import nbodysim_tpu as nb
from nbodysim_tpu.config import SimConfig as JaxConfig
from nbodysim_tpu.physics import barneshut as jb
from nbodysim_tpu.physics import barneshut3d as jb3
from nbodysim_tpu.physics import forces as jforces
import nbodysim_tpu_torch as nt
from nbodysim_tpu_torch.physics import barneshut as tb
from nbodysim_tpu_torch.physics import barneshut3d as tb3
from nbodysim_tpu_torch.physics import forces as tforces
from nbodysim_tpu_torch.scenes.blob import clustered_blob

from _torch_helpers import CPU, as_np, as_t

EPS_SQ = 1.0
N = 4096
# Two deep chains: R = 3 folds the aggregate ring (rr = 2), R = 2 does not.
# Tiles (k, t, T): 2 sub-levels of 4-cell tiles at R = 2; at R = 3 (a tile
# must span 2R) one sub-level of 8-cell tiles, which keeps the tiles' ring
# fold (98 offsets over 8 x 28^3 cells) quick.
CASES = {"R2": dict(levels=3, deep=5, radius=2, tiles=(2, 4, 8)),
         "R3": dict(levels=3, deep=5, radius=3, tiles=(1, 8, 8))}


def _blob(n, span=2000.0, seed=3):
    pos, mass = clustered_blob(n, center=(500.0, -300.0, 200.0), span=span,
                               seed=seed, device=CPU)
    return as_np(pos), as_np(mass)


def _lattice(n, seed=0):
    """n bodies on a jittered cubic lattice over +-2000: no cell of a
    level-4 grid (16^3 cells) comes near the 16-slot cap."""
    rng = np.random.default_rng(seed)
    side = round(n ** (1 / 3))
    cells = np.stack(np.meshgrid(*(np.arange(side),) * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    pos = (cells + rng.uniform(0.1, 0.9, cells.shape)) * (4000.0 / side)
    return ((pos - 2000.0).astype(np.float32),
            rng.uniform(0.1, 10.0, len(pos)).astype(np.float32))


SCENE = _blob(N)


def _j(x):
    """A port tensor as a JAX array (int64 indices as int32, as JAX's)."""
    a = as_np(x)
    return jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)


def _close(got, ref, rel=1e-5, rows=None):
    got, ref = as_np(got), np.asarray(ref)
    assert got.shape == ref.shape
    if rows is not None:
        got, ref = got[rows], ref[rows]
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _config(levels, deep, radius, tiles, n=N, tile_on=True, sparse=0):
    k, t, T = tiles
    return dict(n=n, dim=3, force_backend="bh", bh_levels=levels,
                bh_deep_levels=deep, bh_accept_radius=radius,
                bh_tile_levels=k if tile_on else 0, bh_tile_size=t,
                bh_tile_count=T, bh_nf_sparse=sparse)


# -- the whole evaluation ------------------------------------------------------

EVALS = {"R2-tiles": dict(case="R2"),
         "R2-no tiles": dict(case="R2", tile_on=False),
         "R3-no tiles": dict(case="R3", tile_on=False),
         "R2-tiles-sparse": dict(case="R2", sparse=1)}


def _eval_config(name):
    e = dict(EVALS[name])
    return _config(**CASES[e.pop("case")], **e)


@pytest.fixture(scope="module")
def jax_evals():
    """Jitted JAX `bh_accelerations` on the blob, per case."""
    pos, mass = SCENE
    return {name: np.asarray(jb.bh_accelerations(
        jnp.asarray(pos), jnp.asarray(mass), JaxConfig(**_eval_config(name))))
        for name in EVALS}


@functools.lru_cache(maxsize=None)
def _port_eval(name):
    pos, mass = SCENE
    return as_np(tb.bh_accelerations(as_t(pos), as_t(mass),
                                     nt.SimConfig(**_eval_config(name))))


@pytest.mark.parametrize("name", list(EVALS))
def test_bh3_accelerations_with_the_deep_chain_match_jax(jax_evals, name):
    got = _port_eval(name)
    assert np.isfinite(got).all()
    _close(got, jax_evals[name])
    if name == "R2-no tiles":
        # The same through `_bh_accelerations` and the plain route (the
        # CPU wrappers run the plain versions: equal bit for bit).
        pos, mass = SCENE
        c = CASES["R2"]
        plain = tb._bh_accelerations(
            as_t(pos), as_t(mass), levels=c["levels"], eps_sq=EPS_SQ,
            g_const=1.0, near_cap=tb.NEAR_CAP, radius=c["radius"],
            use_kernels=False, deep_levels=c["deep"])
        np.testing.assert_array_equal(as_np(plain), got)


# -- the stages, on the same inputs --------------------------------------------

class _Prelude:
    """The deep branch's inputs for one case, computed by the port: the
    extraction, the synthesized pyramid to `deep`, the locals at `deep`,
    the deep-path targets, the payload and the tile selection."""

    def __init__(self, levels, deep, radius, tiles):
        pos, mass = SCENE
        self.levels, self.deep, self.radius = levels, deep, radius
        self.pos, self.mass = as_t(pos), as_t(mass)
        ext = tb._extract_heavy_outliers(self.pos, self.mass)
        self.ext = ext
        self.bulk_pos, self.tree_mass = ext["bulk_pos"], ext["tree_mass"]
        (self.grids, self.corner, self.size, self.ci_f,
         _) = tb3._build_pyramid3(self.bulk_pos, self.tree_mass, deep,
                                  synth_quad=True)
        res = 1 << levels
        self.ci = self.ci_f >> (deep - levels)
        self.flat = (self.ci[:, 0] * res + self.ci[:, 1]) * res + self.ci[:, 2]
        self.flat_nf = tb._outlier_flat_ids(self.flat, ext["is_out"],
                                            res ** 3)
        self.b_par, self.hot = tb3._deep_targets3(
            self.flat_nf, self.flat, ext["is_out"], res, tb.NEAR_CAP, radius)
        local = None
        for lv in range(2, deep + 1):
            terms = tb3._m2l_level3(self.grids[lv], self.corner, self.size,
                                    EPS_SQ, radius)
            local = terms if local is None else tuple(
                u + t for u, t in zip(
                    tb3._l2l_upsample3(local, self.size / (1 << lv)), terms))
        self.local_deep = local
        self.payload = tb3._moment_payload3(self.pos, self.tree_mass)
        self.tiles = k, t, T = tiles
        self.tid, self.tile_slot, self.orig = tb3._tile_select3(
            self.ci_f, self.b_par, deep, t, T, radius)
        self.local_w = tb3._tile_windows3(local, self.orig, t, radius)
        self.geo = (self.corner, self.size, deep, radius, k, t, T)
        self.jgeo = (_j(self.corner), _j(self.size), deep, radius, k, t, T)

    def g4k(self):
        return tb3._tile_scatter3(self.payload, self.bulk_pos, self.ci_f,
                                  self.tile_slot, self.orig, *self.geo)


@functools.lru_cache(maxsize=None)
def _prelude(case):
    return _Prelude(**CASES[case])


@functools.lru_cache(maxsize=None)
def _jax_b_par3(levels, deep, radius):
    pos, mass = SCENE
    return tuple(np.asarray(a) for a in jax.jit(
        _jax_b_par3_traced, static_argnums=(2, 3, 4))(
            jnp.asarray(pos), jnp.asarray(mass), levels, deep, radius))


def _jax_b_par3_traced(pos, mass, levels, deep, radius):
    """JAX's deep-path targets and hot cells, as `_bh3_accelerations`
    computes them inline (nbodysim_tpu/physics/barneshut3d.py:1590-1606),
    from JAX's own extraction and pyramid, on the blob (jitted)."""
    ext = jb._extract_heavy_outliers(pos, mass)
    _, _, _, ci_f, _ = jb3._build_pyramid3(ext["bulk_pos"], ext["tree_mass"],
                                           deep, synth_quad=True)
    res = 1 << levels
    ci = ci_f >> (deep - levels)
    flat = (ci[:, 0] * res + ci[:, 1]) * res + ci[:, 2]
    flat_nf = jnp.where(ext["is_out"], res ** 3 + jnp.arange(pos.shape[0]),
                        flat)
    occ = jnp.zeros((res ** 3,), jnp.int32).at[flat_nf].add(1, mode="drop")
    hot = (occ > jb.NEAR_CAP).reshape(res, res, res)
    rr = radius - 1
    hotp = jnp.pad(hot, rr)
    bmask = jnp.zeros((res, res, res), bool)
    for ox in range(2 * rr + 1):
        for oy in range(2 * rr + 1):
            for oz in range(2 * rr + 1):
                bmask = bmask | hotp[ox:ox + res, oy:oy + res, oz:oz + res]
    b_par = bmask.reshape(-1)[flat] & ~ext["is_out"]
    return b_par, hot.reshape(-1), ci_f


@pytest.mark.parametrize("case", list(CASES))
def test_deep_targets_tiles_and_sub_cells_equal_jax(case):
    p = _prelude(case)
    jb_par, jhot, jci_f = _jax_b_par3(p.levels, p.deep, p.radius)
    np.testing.assert_array_equal(as_np(p.ci_f), np.asarray(jci_f))
    np.testing.assert_array_equal(as_np(p.hot), jhot)
    np.testing.assert_array_equal(as_np(p.b_par), jb_par)
    assert 0 < int(p.b_par.sum()) < N
    k, t, T = p.tiles
    jsel = jb3._tile_select3(jnp.asarray(jci_f), jnp.asarray(jb_par),
                             p.deep, t, T, p.radius)
    for got, ref in zip((p.tid, p.tile_slot, p.orig), jsel):
        np.testing.assert_array_equal(as_np(got), np.asarray(ref))
    # Cells at the tiles' sub-resolution, in JAX's f32 order.
    rf = (1 << p.deep) << k
    u = (_j(p.bulk_pos) - _j(p.corner)) / _j(p.size)
    jsub = jnp.clip((u * rf).astype(jnp.int32), 0, rf - 1)
    sub, _ = tb._cell_ids(p.bulk_pos, p.corner, p.size, rf)
    np.testing.assert_array_equal(as_np(sub), np.asarray(jsub))


def _tie_case():
    """Deep level 5, tiles of 4 (an 8^3 tile grid): ten tiles tie at 5
    targets across the top-8 boundary, two score higher, others lower, and
    non-target rows crowd other tiles."""
    deep, t = 5, 4
    nt_ = (1 << deep) // t
    rng = np.random.default_rng(4)
    scores = np.zeros(nt_ ** 3, np.int64)
    scores[[3, 10, 17, 40, 41, 50, 60, 62, 300, 511]] = 5
    scores[[22, 9]] = [7, 6]
    scores[[5, 33]] = [2, 4]
    rows, par = [], []
    for tile, s in enumerate(scores):
        tx, rest = divmod(tile, nt_ * nt_)
        ty, tz = divmod(rest, nt_)
        n_rows = s + 3 if s or tile % 7 == 0 else 0
        cells = rng.integers(0, t, (n_rows, 3)) + [tx * t, ty * t, tz * t]
        rows.append(cells)
        par += [True] * s + [False] * (n_rows - s)
    ci = np.concatenate(rows)
    order = rng.permutation(len(ci))
    return ci[order], np.asarray(par)[order], deep, t


@pytest.mark.parametrize("T", [8, 20])
def test_tile_select3_breaks_ties_as_lax_top_k(T):
    """T=8 cuts through the ten tied tiles; T=20 selects more tiles than
    have targets (score-0 tiles stay unselected and the sentinel T)."""
    ci, par, deep, t = _tie_case()
    got = tb3._tile_select3(as_t(ci), as_t(par), deep, t, T, 2)
    ref = jb3._tile_select3(jnp.asarray(ci.astype(np.int32)),
                            jnp.asarray(par), deep, t, T, 2)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(as_np(a), np.asarray(b))
    assert int(got[1][-1]) == T


def _masks(p):
    """The compactions' masks of the R = 2 chain, from the port's stages:
    the tile sources, the refined targets, the deep rows, the sparse near
    field's targets and sources."""
    k, t, T = p.tiles
    cand = (p.tile_slot[p.tid] < T) & p.b_par
    return {
        "tile sources": tb3._tile_src_mask3(p.ci_f, p.tile_slot, p.deep,
                                            p.radius, t, T),
        "refined": cand,
        "deep rows": p.b_par & ~cand,
        "sparse targets": ~p.b_par & ~p.ext["is_out"],
        "sparse sources": ~p.hot[p.flat],
    }


@pytest.mark.parametrize("mask", ["tile sources", "refined", "deep rows",
                                  "sparse targets", "sparse sources"])
def test_compaction_masks_and_indices_equal_jax(mask):
    """Each compaction's mask equals the JAX package's (the tile source
    mask by JAX's `_tile_src_mask3`, the others from JAX's own b_par and hot
    cells), and its indices equal JAX's `_compact_indices` at a cap that
    cuts it."""
    p = _prelude("R2")
    got = _masks(p)[mask]
    jb_par, jhot, _ = _jax_b_par3(p.levels, p.deep, p.radius)
    k, t, T = p.tiles
    jslot = _j(p.tile_slot)
    if mask == "tile sources":
        ref = np.asarray(jb3._tile_src_mask3(_j(p.ci_f), jslot, p.deep,
                                             p.radius, t, T))
    else:
        jcand = np.asarray(jslot[_j(p.tid)] < T) & jb_par
        ref = {"refined": jcand, "deep rows": jb_par & ~jcand,
               "sparse targets": ~jb_par & ~as_np(p.ext["is_out"]),
               "sparse sources": ~jhot[as_np(p.flat)]}[mask]
    np.testing.assert_array_equal(as_np(got), ref)
    cap = max(1, int(ref.sum()) * 2 // 3)
    sidx, count = tb._compact_indices(got, cap)
    jsidx, jcount = jb._compact_indices(jnp.asarray(ref), cap)
    np.testing.assert_array_equal(as_np(sidx), np.asarray(jsidx))
    assert int(count) == int(jcount) > cap


@pytest.mark.parametrize("scene", ["blob", "lattice"])
def test_bucket_tier_count_matches_jax(scene):
    pos, mass = SCENE if scene == "blob" else _lattice(4096)
    for cfg in ({"bh_levels": 4}, {"bh_levels": 4, "bh_deep_levels": -1},
                {"bh_levels": 3, "bh_deep_levels": 5,
                 "bh_accept_radius": 3}):
        got = tb3.bh3_bucket_tier_count(as_t(pos), as_t(mass), nt.SimConfig(
            n=len(pos), dim=3, **cfg))
        ref = jb3.bh3_bucket_tier_count(jnp.asarray(pos), jnp.asarray(mass),
                                        JaxConfig(n=len(pos), dim=3, **cfg))
        assert got == ref
    if scene == "blob":
        assert 0 < got < len(pos)


@pytest.mark.parametrize("channels", [4, 10])
def test_aggregate_window_eval3_matches_jax(channels):
    """Mono [M, 4] rows and 10-channel rows (monopole + quadrupole), each
    particle's own row subtracted from its home cell."""
    rng = np.random.default_rng(channels)
    r, rr, n = 8, 2, 1500
    side = r + 2 * rr
    g = rng.normal(size=(r, r, r, channels)).astype(np.float32)
    g[..., 0] = np.abs(g[..., 0]) * 5.0
    g[..., 1:4] *= 40.0
    g[2:4, 2:4, 2:4, 0] = 0.0                  # empty cells
    gp = np.pad(g, ((rr, rr),) * 3 + ((0, 0),))
    ci = rng.integers(0, r, (n, 3))
    pos = (rng.uniform(0.0, 1.0, (n, 3)) * 16.0).astype(np.float32)
    payload = (0.1 * g[ci[:, 0], ci[:, 1], ci[:, 2]]).astype(np.float32)
    base = ((ci[:, 0] + rr) * side + ci[:, 1] + rr) * side + ci[:, 2] + rr
    got = tb3._aggregate_window_eval3(as_t(gp.reshape(-1, channels)),
                                      as_t(base), side, as_t(payload),
                                      as_t(pos), 1.5, rr)
    ref = jb3._aggregate_window_eval3(
        jnp.asarray(gp.reshape(-1, channels)),
        jnp.asarray(base.astype(np.int32)), side, jnp.asarray(payload),
        jnp.asarray(pos), 1.5, rr)
    _close(got, ref)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("band", [False, True])
def test_deep_near_aggregates3_match_jax(case, band):
    """The deep path's inner window on the padded (m, sx, sy, sz) grid, and
    an x-slab band of it (row0 > 0, the banded tree's form)."""
    p = _prelude(case)
    rin = 1
    g4 = torch.stack(p.grids[p.deep][:4], -1)
    gp = torch.nn.functional.pad(g4, (0, 0) + (rin,) * 6)
    row0 = 0
    if band:
        row0, rows = 8, 16
        gp = gp[row0:row0 + rows + 2 * rin]
    s_d = p.size / (1 << p.deep)
    pay = p.payload[:, :4]
    got = tb3._deep_near_aggregates3(p.pos, pay, gp, p.ci_f, EPS_SQ, s_d,
                                     rr=rin, row0=row0)
    ref = jb3._deep_near_aggregates3(_j(p.pos), _j(pay), _j(gp), _j(p.ci_f),
                                     EPS_SQ, _j(s_d), rr=rin, row0=row0)
    rows_ok = as_np(p.b_par)
    if band:
        ix = as_np(p.ci_f[:, 0])
        rows_ok &= (ix >= row0) & (ix < row0 + 16)
    _close(got, ref, rows=rows_ok)


@pytest.mark.parametrize("radius", [3, 4])
@pytest.mark.parametrize("band", [False, True])
def test_fold_aggregate_ring3_matches_jax(radius, band):
    """The outer aggregate shell (rr = 2 and 3) folded into the deep
    locals, on the full deep grid and on an x-slab band."""
    p = _prelude("R3")
    rr = radius - 1
    r = 1 << p.deep
    window = tuple(torch.nn.functional.pad(g, (rr,) * 6)
                   for g in p.grids[p.deep])
    local, row0, rows = p.local_deep, 0, r
    if band:
        row0, rows = 10, 12
        window = tuple(w[row0:row0 + rows + 2 * rr] for w in window)
        local = tuple(a[row0:row0 + rows] for a in local)
    got = tb3._fold_aggregate_ring3(local, window, p.corner, p.size, r,
                                    EPS_SQ, radius, row0, rows)
    ref = jb3._fold_aggregate_ring3(
        tuple(map(_j, local)), tuple(map(_j, window)), _j(p.corner),
        _j(p.size), r, EPS_SQ, radius, jnp.int32(row0), rows)
    assert len(got) == 19
    for a, b in zip(got, ref):
        _close(a, b)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("compact", [False, True])
def test_tile_scatter3_matches_jax(case, compact):
    """All rows, and the compacted source rows with their mask (as
    `_tile_eval` passes them)."""
    p = _prelude(case)
    k, t, T = p.tiles
    args = [p.payload, p.bulk_pos, p.ci_f]
    kw = {}
    if compact:
        src = tb3._tile_src_mask3(p.ci_f, p.tile_slot, p.deep, p.radius,
                                  t, T)
        sidx, _ = tb._compact_indices(src, int(src.sum()) + 300)
        valid = sidx < N
        ss = torch.clamp(sidx, max=N - 1)
        args = [torch.where(valid[:, None], p.payload[ss], 0.0),
                p.bulk_pos[ss], p.ci_f[ss]]
        kw = {"src_mask": valid}
    got = tb3._tile_scatter3(*args, p.tile_slot, p.orig, *p.geo, **kw)
    ref = jb3._tile_scatter3(*map(_j, args), _j(p.tile_slot), _j(p.orig),
                             *p.jgeo, **{k_: _j(v) for k_, v in kw.items()})
    assert float(got[..., 0].sum()) > 0
    _close(got, ref)


def test_tile_scatter3_keeps_jaxs_halo_cap():
    """131,072 rows, 80% of them within `radius` of a face between two
    selected tiles: the halo sources outnumber the cap max(m // 4, 65536),
    so the rows past it drop, in index order, as in the JAX package."""
    deep, radius, k, t, T = 5, 2, 1, 4, 8
    rng = np.random.default_rng(12)
    m = 131_072
    nt_ = (1 << deep) // t
    # Selected: a 2 x 2 x 2 block of tiles; bodies in its face bands.
    block = [(tx, ty, tz) for tx in (2, 3) for ty in (3, 4) for tz in (1, 2)]
    tile_slot = np.full(nt_ ** 3 + 1, T, np.int64)
    for s, (tx, ty, tz) in enumerate(block):
        tile_slot[(tx * nt_ + ty) * nt_ + tz] = s
    orig = np.asarray([[tx * t - radius, ty * t - radius, tz * t - radius]
                       for tx, ty, tz in block], np.int64)
    home = np.asarray(block)[rng.integers(0, len(block), m)]
    edge = rng.random(m) < 0.8
    off = rng.uniform(0.0, t, (m, 3))
    band = np.where(rng.random(m) < 0.5, rng.uniform(0, radius, m),
                    rng.uniform(t - radius, t, m))
    axis = rng.integers(0, 3, m)
    off[edge, axis[edge]] = band[edge]
    cell = home * t + off
    size = np.float32(1 << deep)
    corner = np.zeros(3, np.float32)
    bulk = (cell * (size / (1 << deep))).astype(np.float32)
    ci_f, _ = tb._cell_ids(as_t(bulk), as_t(corner), as_t(size), 1 << deep)
    payload = rng.uniform(0.5, 2.0, (m, 10)).astype(np.float32)
    cands = tb3._tile_candidates3(ci_f, as_t(tile_slot), t, T, radius, nt_)
    reach = sum(as_np(c[0]).astype(np.float64) for c in cands[1:])
    cap = tb._halo_cap(m)
    assert cap == min(m, max(m // 4, 65536)) and (reach > 0).sum() > cap
    geo = (as_t(corner), as_t(size), deep, radius, k, t, T)
    got = tb3._tile_scatter3(as_t(payload), as_t(bulk), ci_f,
                             as_t(tile_slot), as_t(orig), *geo)
    ref = jb3._tile_scatter3(jnp.asarray(payload), jnp.asarray(bulk),
                             _j(ci_f), _j(as_t(tile_slot)), _j(as_t(orig)),
                             jnp.asarray(corner), jnp.asarray(size), deep,
                             radius, k, t, T)
    _close(got, ref)
    # The halo mass is that of the first `cap` on-edge rows, each counted
    # once per selected neighbour window it reaches.
    home_only = tb3._tile_scatter3(as_t(payload), as_t(bulk), ci_f,
                                   as_t(tile_slot), as_t(orig), *geo,
                                   src_mask=torch.zeros(m, dtype=torch.bool))
    first = np.flatnonzero(reach > 0)[:cap]
    expected = float((payload[first, 0] * reach[first]).sum())
    kept = float(got[..., 0].double().sum() - home_only[..., 0].double().sum())
    np.testing.assert_allclose(kept, expected, rtol=1e-5)
    assert expected < float((payload[:, 0] * reach).sum())


# JAX's tile apply, jitted (op by op, each primitive compiles at each
# shape).
_jax_tile_apply3 = jax.jit(jb3._tile_apply3,
                           static_argnums=(11, 12, 13, 14, 15, 16))


@pytest.mark.parametrize("case", list(CASES))
def test_tile_chain3_matches_jax(case):
    """The batched sub-level chain (and at R = 3 the tiles' ring fold)
    against JAX's vmapped one. At R = 2 JAX runs op by op: jitted, XLA's
    fused arithmetic moves 2 of the chain's 262,144 J terms by 4.4e-5
    relative, past 1e-5 * max (the synthesized quadrupoles amplify last
    bits; see the 2D tests), while the port sits within the bound of JAX
    run op by op."""
    p = _prelude(case)
    g4k = p.g4k()
    got = tb3._tile_chain3(p.local_w, g4k, p.orig, p.corner, p.size,
                           p.deep, p.radius, EPS_SQ, *p.tiles)
    args = (_j(p.local_w), _j(g4k), _j(p.orig), _j(p.corner), _j(p.size),
            p.deep, p.radius, EPS_SQ, *p.tiles)
    if case == "R2":
        with jax.disable_jit():
            ref = jb3._tile_chain3(*args)
    else:
        # At R = 3 jitted JAX is within the bound, and op by op its ring
        # fold's scan takes ~40 s here.
        ref = jax.jit(jb3._tile_chain3, static_argnums=range(5, 11))(*args)
    assert got.shape == ref.shape
    for c in range(19):
        _close(got[..., c], ref[..., c])


@pytest.mark.parametrize("case", list(CASES))
def test_tile_apply3_matches_jax(case):
    p = _prelude(case)
    g4k = p.g4k()
    local_w = tb3._tile_chain3(p.local_w, g4k, p.orig, p.corner, p.size,
                               p.deep, p.radius, EPS_SQ, *p.tiles)
    args = (p.pos, p.payload, p.bulk_pos, p.ci_f, p.b_par, local_w, g4k,
            p.tile_slot, p.orig)
    refined, far, near = tb3._tile_apply3(*args, *p.geo[:4], EPS_SQ,
                                          *p.geo[4:])
    jref, jfar, jnear = _jax_tile_apply3(*map(_j, args), *p.jgeo[:4],
                                         EPS_SQ, *p.jgeo[4:])
    np.testing.assert_array_equal(as_np(refined), np.asarray(jref))
    rows = as_np(refined)
    assert 0 < rows.sum() <= as_np(p.b_par).sum()
    _close(far, jfar, rows=rows)
    _close(near, jnear, rows=rows)


# -- the sparse near field -----------------------------------------------------

@pytest.mark.parametrize("src_cap", ["all sources", "compacted sources"])
def test_sparse_near_field_trimmed_equals_padded(monkeypatch, src_cap):
    """The port runs the sparse pass on its valid targets and compacted
    sources only; the JAX package pads both to static caps with zero-mass
    rows. Padding adds nothing, so the two agree within summation order
    (1e-6 * max|a|). At N = 4096 the source cap exceeds N (all sources);
    patched to 3000, the sources compact."""
    p = _prelude("R2")
    n = N
    if src_cap == "compacted sources":
        monkeypatch.setattr(tb3, "_nf_sparse_src_cap", lambda n: 3000)
    near, b_par = tb3._sparse_near_field3(
        p.pos, p.bulk_pos, p.tree_mass, p.ci, p.flat, p.hot, p.b_par,
        p.ext["is_out"], EPS_SQ, 1.0, p.radius)
    # The padded form, as the JAX package computes it.
    cand = ~p.b_par & ~p.ext["is_out"]
    cap = tb3._nf_sparse_cap(n)
    sidx, n_cand = tb._compact_indices(cand, cap)
    si = torch.clamp(sidx, max=n - 1)
    scap = tb3._nf_sparse_src_cap(n)
    sidx_s, n_srcs = tb._compact_indices(~p.hot[p.flat], scap)
    if scap < n and int(n_srcs) <= scap:
        ss = torch.clamp(sidx_s, max=n - 1)
        src = (p.bulk_pos[ss],
               torch.where(sidx_s < n, p.tree_mass[ss], 0.0), p.ci[ss])
    else:
        src = (p.bulk_pos, p.tree_mass, p.ci)
    padded = tb._near_masked_blocked(p.pos[si], p.ci[si], *src, EPS_SQ,
                                     p.radius - 1)
    ref = torch.zeros_like(p.pos)
    ref[sidx[sidx < n]] = padded[sidx < n]
    assert 0 < int(n_cand) <= cap
    np.testing.assert_allclose(as_np(near), as_np(ref), rtol=0,
                               atol=1e-6 * float(ref.abs().max()))
    np.testing.assert_array_equal(as_np(b_par), as_np(p.b_par))
    # Past the target cap the rest promote to the deep path.
    monkeypatch.setattr(tb3, "_nf_sparse_cap", lambda n: 100)
    _, promoted = tb3._sparse_near_field3(
        p.pos, p.bulk_pos, p.tree_mass, p.ci, p.flat, p.hot, p.b_par,
        p.ext["is_out"], EPS_SQ, 1.0, p.radius)
    assert int(promoted.sum()) == int(p.b_par.sum()) + int(n_cand) - 100


# -- the JAX package's contracts, held by the port -----------------------------

def _port(pos, mass, **kw):
    return as_np(tb._bh_accelerations(
        as_t(pos), as_t(mass), eps_sq=EPS_SQ, g_const=1.0,
        near_cap=tb.NEAR_CAP, **kw))


def _exact(pos, mass):
    return as_np(tforces.direct_accelerations(as_t(pos), as_t(mass),
                                              eps_sq=EPS_SQ))


def _rel_err(a, ref):
    return (np.linalg.norm(a - ref, axis=1)
            / (np.linalg.norm(ref, axis=1) + 1e-12))


def test_deep3d_chain_is_inert_without_overflow():
    """No overflowing cell: the deep branch selects nothing, and only the
    deeper (synthesized) pyramid's roundoff differs from the plain octree
    (JAX's test_deep3d_inert_and_bounded tolerances)."""
    pos, mass = _lattice(2048)
    assert tb3.bh3_near_overflow(as_t(pos), as_t(mass), nt.SimConfig(
        n=2048, dim=3, bh_levels=4)) == 0
    kw = dict(levels=4, radius=2)
    a0 = _port(pos, mass, deep_levels=0, **kw)
    a1 = _port(pos, mass, deep_levels=6, **kw)
    np.testing.assert_allclose(a1, a0, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("radius", [2, 3])
def test_deep3d_background_is_exact_tier_and_blob_bounded(radius):
    """JAX's test_deep3d_inert_and_bounded: N = 2048, levels 4, deep 6,
    no tiles; the background's median relative error < 3e-2 and max|a| <
    10x the exact one (at R = 3 the aggregate ring fold runs)."""
    n = 2048
    pos, mass = _blob(n)
    a = _port(pos, mass, levels=4, radius=radius, deep_levels=6)
    a_d = _exact(pos, mass)
    assert np.isfinite(a).all()
    assert np.median(_rel_err(a, a_d)[n // 2:]) < 3e-2
    assert (np.linalg.norm(a, axis=1).max()
            < 10.0 * np.linalg.norm(a_d, axis=1).max())


@pytest.mark.parametrize("cap", ["_refined_cap3", "_scatter_cap3",
                                 "_deep_rows_cap3", "_nf_sparse_src_cap"])
def test_compacted_passes_equal_the_full_pass(monkeypatch, cap):
    """Each compaction (the tile apply's targets, the tile scatter's
    sources, the deep rows, the sparse near field's sources) at a cap that
    engages (9n/10) and at one that overflows (16: the full-length
    fallback) equals the full pass bit for bit, as JAX's
    test_tile_apply_compaction_parity_3d and
    test_deep_rows_compaction_parity hold it. The full pass: every cap at
    N (at N = 4096 the sparse source cap is N already).

    The one exception is the sparse near field's engaged source
    compaction: it drops the hot cells' residents (zero terms under the
    cell mask) from the source blocks, so the blocks sum the same terms in
    another grouping; it is held to 1e-6 * max|a| (its fallback is bit for
    bit)."""
    pos, mass = SCENE
    c = CASES["R2"]
    k, t, T = c["tiles"]
    kw = dict(levels=c["levels"], radius=c["radius"], deep_levels=c["deep"],
              tile_levels=k, tile_size=t, tile_count=T,
              nf_sparse=cap == "_nf_sparse_src_cap")
    for name in ("_refined_cap3", "_scatter_cap3", "_deep_rows_cap3"):
        monkeypatch.setattr(tb3, name, lambda n: n)
    full = _port(pos, mass, **kw)
    assert np.isfinite(full).all()
    for fn in (lambda n: (9 * n) // 10, lambda n: 16):
        monkeypatch.setattr(tb3, cap, fn)
        got = _port(pos, mass, **kw)
        if cap == "_nf_sparse_src_cap" and fn(N) > 16:
            np.testing.assert_allclose(got, full, rtol=0,
                                       atol=1e-6 * np.abs(full).max())
            assert not np.array_equal(got, full)   # the compaction ran
        else:
            np.testing.assert_array_equal(got, full)


def test_deep3d_chain_convolutions_run_with_tf32_off(monkeypatch):
    """Fault F1: every M2L convolution of the 3D deep chain (the global
    levels and the tiles' sub-levels) runs with cuDNN's TF32 off; the
    chain has no matmul or einsum."""
    seen = []
    real_conv3d = torch.nn.functional.conv3d

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real_conv3d(*args, **kwargs)

    monkeypatch.setattr(tb3.F, "conv3d", spy)
    torch.backends.cudnn.allow_tf32 = True
    _port_eval.cache_clear()
    try:
        _port_eval("R2-tiles")
    finally:
        _port_eval.cache_clear()
    # Levels 2..deep, then the k tile sub-levels as one batch each.
    assert seen == [False] * (CASES["R2"]["deep"] - 1
                              + CASES["R2"]["tiles"][0])
    assert torch.backends.cudnn.allow_tf32 is True


@functools.lru_cache(maxsize=None)
def _users_scenes(n):
    """The users' 3D scenes of the deep chain at small N, from the JAX
    package's generators (the Plummer sphere, unvirialized, and the 3D
    galaxy merger), the clustered blob and a spread lattice."""
    cfg = JaxConfig(n=n, dim=3, force_backend="xla")
    plum = nb.init_scene("plummer", cfg, virialize=False)
    merger = nb.init_scene("galaxy_merger", cfg)
    return {"plummer": (np.asarray(plum.pos), np.asarray(plum.mass)),
            "merger": (np.asarray(merger.pos), np.asarray(merger.mass)),
            "blob": _blob(n, span=30000.0, seed=11),
            "lattice": _lattice(n)}


@pytest.mark.parametrize("scene,expected", [
    ("plummer", ("bh", -1, 0)), ("merger", ("bh", -1, 1)),
    ("blob", ("bh", -1, 0)), ("lattice", ("bh", 0, 0))])
def test_auto_resolution_matches_jax_on_users_scenes(monkeypatch, scene,
                                                     expected):
    """At N = 1M the Plummer sphere and the blob resolve to the deep chain
    with the dense near field (K7) and the 3D merger to the sparse near
    field. At N = 4096, with the auto threshold, the residual cap (512)
    and the sparse cap (256) patched small in both packages, each scene
    resolves as the JAX package's resolution does, with the warning that
    names the chain; Simulation builds and steps with it."""
    n = 4096
    for mod in (jforces, tforces):
        monkeypatch.setattr(mod, "BH3_AUTO_THRESHOLD", 1024)
    monkeypatch.setattr(jb, "_OVERFLOW_CAP", 512)
    monkeypatch.setattr(tb, "_OVERFLOW_CAP", 512)
    monkeypatch.setattr(jb3, "_NF_SPARSE_CAP", 256)
    monkeypatch.setattr(tb3, "_NF_SPARSE_CAP", 256)
    pos, mass = _users_scenes(n)[scene]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jcfg = jforces.resolve_config_for_state(
            jnp.asarray(pos), jnp.asarray(mass), JaxConfig(n=n, dim=3))
    cfg = nt.SimConfig(n=n, dim=3, enable_collisions=False)
    fields = ("force_backend", "bh_deep_levels", "bh_nf_sparse")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = tforces.resolve_config_for_state(as_t(pos), as_t(mass), cfg)
    warned = any("deep-overflow" in str(w.message) for w in caught)
    assert warned == (expected[1] == -1)
    assert tuple(getattr(got, f) for f in fields) == tuple(
        getattr(jcfg, f) for f in fields) == expected
    if scene == "merger":
        # One tile sub-level keeps the CPU step short (3 would chain 8
        # tiles of 96^3 cells).
        state = nt.ParticleState.create(as_t(pos), torch.zeros(n, 3),
                                        as_t(mass))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            sim = nt.Simulation(cfg.replace(bh_tile_levels=1), state=state,
                                device=CPU)
        assert sim.config.bh_nf_sparse == 1
        assert sim.check_capacity() is False
        sim.step()
        assert bool(torch.isfinite(sim.state.pos).all())
