"""PyTorch port, the 2D deep-overflow chain and its hot-zone tiles
(`physics/barneshut.py`) against the JAX package on the CPU.

Integer and boolean stages (the deep-path targets `b_par`, tile selection,
sub-level cells, the refined set, the compaction indices and the halo cap of
`_tile_scatter`) must equal JAX's exactly. Float stages are held to
1e-5 * max|x| of JAX's function on the same inputs, and the whole force
evaluation to 1e-5 * max|a|.

The whole evaluations are compared with the JAX package run op by op
(`jax.disable_jit()`). Jitted, the JAX package gives other last bits (XLA's
fused arithmetic), and the tile chain amplifies them: its quadrupoles are
synthesized as sx^2/m at absolute coordinates and centred by subtracting
~m c^2, so the refined rows of jitted JAX differ from op-by-op JAX by up to
2.4e-3 * max|a| on this scene (measured with levels 4, deep 8, R=2 and 3
tile levels), the port from op-by-op JAX by 2-4e-7. For the same reason
the port pools the synthesized grids in JAX's CPU order (`_pool_synth`).

Then the JAX package's contract tests (tests/test_deep_overflow.py), held
by the port: the chain is inert without overflow, background rows keep
exact-tier accuracy, tiles beat no tiles, and the compacted passes equal the
full ones bit for bit.
"""

import functools
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from nbodysim_tpu.config import SimConfig as JaxConfig
from nbodysim_tpu.physics import barneshut as jb
from nbodysim_tpu.physics import forces as jforces
import nbodysim_tpu_torch as nt
from nbodysim_tpu_torch.physics import barneshut as tb
from nbodysim_tpu_torch.physics import forces as tforces

from _torch_helpers import as_np, as_t

EPS_SQ = 1.0
N = 4096
TILES = dict(k=2, t=16, T=8)
# Two deep chains: R=3 folds the aggregate ring (rr = 2), R=2 does not.
CASES = {"R3": dict(levels=5, deep=7, radius=3),
         "R2": dict(levels=4, deep=8, radius=2)}


def _clustered(n, seed=3):
    """The JAX tests' `_clustered` scene drawn with numpy: two Gaussian
    blobs (sigma 60 and 40) holding half the bodies, a uniform background
    of +-4000 the other half (its rows last)."""
    rng = np.random.default_rng(seed)
    blob1 = 60.0 * rng.standard_normal((n // 4, 2)) + [1500.0, -700.0]
    blob2 = 40.0 * rng.standard_normal((n // 4, 2)) + [-2000.0, 1000.0]
    bg = rng.uniform(-4000.0, 4000.0, (n // 2, 2))
    pos = np.concatenate([blob1, blob2, bg]).astype(np.float32)
    return pos, rng.uniform(0.1, 10.0, n).astype(np.float32)


def _lattice(n, seed=0):
    """n bodies on a jittered square lattice over +-4000: no cell of a
    level-4 grid (16^2 cells) comes near the 16-slot cap."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(n))
    cells = np.stack(np.meshgrid(np.arange(side), np.arange(n // side),
                                 indexing="ij"), -1).reshape(-1, 2)
    pos = (cells + rng.uniform(0.1, 0.9, cells.shape)) * (8000.0 / side)
    return ((pos - 4000.0).astype(np.float32),
            rng.uniform(0.1, 10.0, len(pos)).astype(np.float32))


SCENE = _clustered(N)


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


def _config(levels, deep, radius, tiles, n=N):
    return dict(n=n, force_backend="bh", bh_levels=levels,
                bh_deep_levels=deep, bh_accept_radius=radius,
                bh_tile_levels=TILES["k"] if tiles else 0,
                bh_tile_size=TILES["t"], bh_tile_count=TILES["T"])


# -- the whole evaluation ------------------------------------------------------

EVALS = {f"{c}-{'tiles' if tiles else 'no tiles'}": (c, tiles)
         for c in CASES for tiles in (True, False)}


@pytest.fixture(autouse=True)
def _jax_op_by_op():
    """Every JAX call of this file runs op by op: the reference for the
    whole evaluations (see above), and the stage calls then reuse the
    primitives `jax_evals` compiled."""
    with jax.disable_jit():
        yield


@pytest.fixture(scope="module")
def jax_evals():
    """JAX's `bh_accelerations` op by op on the clustered scene, per case."""
    pos, mass = SCENE
    out = {}
    with jax.disable_jit():
        for name, (c, tiles) in EVALS.items():
            out[name] = np.asarray(jb.bh_accelerations(
                jnp.asarray(pos), jnp.asarray(mass),
                JaxConfig(**_config(**CASES[c], tiles=tiles))))
    return out


@functools.lru_cache(maxsize=None)
def _port_eval(name):
    c, tiles = EVALS[name]
    pos, mass = SCENE
    return as_np(tb.bh_accelerations(as_t(pos), as_t(mass),
                                     nt.SimConfig(**_config(**CASES[c],
                                                            tiles=tiles))))


@pytest.mark.parametrize("name", list(EVALS))
def test_bh_accelerations_with_the_deep_chain_match_jax(jax_evals, name):
    got = _port_eval(name)
    assert np.isfinite(got).all()
    _close(got, jax_evals[name])
    c, tiles = EVALS[name]
    if not tiles:
        # The same through `_bh_accelerations` and the plain route (the
        # CPU wrappers run the plain versions: equal bit for bit).
        pos, mass = SCENE
        plain = tb._bh_accelerations(
            as_t(pos), as_t(mass), eps_sq=EPS_SQ, g_const=1.0,
            near_cap=tb.NEAR_CAP, deep_levels=CASES[c]["deep"],
            levels=CASES[c]["levels"], radius=CASES[c]["radius"],
            use_kernels=False)
        np.testing.assert_array_equal(as_np(plain), got)


# -- the stages, on the same inputs ---------------------------------------------

class _Prelude:
    """The deep branch's inputs for one case, computed by the port: the
    extraction, the synthesized pyramid to `deep`, the locals at `deep`,
    the deep-path targets and the payload."""

    def __init__(self, levels, deep, radius):
        pos, mass = SCENE
        self.levels, self.deep, self.radius = levels, deep, radius
        self.pos, self.mass = as_t(pos), as_t(mass)
        ext = tb._extract_heavy_outliers(self.pos, self.mass)
        self.ext = ext
        self.bulk_pos, self.tree_mass = ext["bulk_pos"], ext["tree_mass"]
        (self.grids, self.corner, self.size, self.ci_f,
         _) = tb._build_pyramid(self.bulk_pos, self.tree_mass, deep,
                                synth_quad=True)
        res = 1 << levels
        ci = self.ci_f >> (deep - levels)
        self.flat = ci[:, 0] * res + ci[:, 1]
        self.flat_nf = tb._outlier_flat_ids(self.flat, ext["is_out"],
                                            res * res)
        self.b_par = tb._deep_targets(self.flat_nf, self.flat, ext["is_out"],
                                      res, tb.NEAR_CAP, radius)
        local = None
        for lv in range(2, deep + 1):
            terms = tb._m2l_level(self.grids[lv], self.corner, self.size,
                                  EPS_SQ, radius)
            local = terms if local is None else tuple(
                u + t for u, t in zip(
                    tb._l2l_upsample(local, self.size / (1 << lv)), terms))
        self.local_deep = local
        self.payload = tb._moment_payload(self.pos, self.tree_mass)
        k, t, T = TILES["k"], TILES["t"], TILES["T"]
        self.tid, self.tile_slot, self.orig = tb._tile_select(
            self.ci_f, self.b_par, deep, t, T, radius)
        H = radius
        locDp = torch.nn.functional.pad(torch.stack(local, -1),
                                        (0, 0, H, H, H, H))
        span = torch.arange(t + 2 * H)
        self.local_w = locDp[(self.orig[:, 0, None] + H + span)[:, :, None],
                             (self.orig[:, 1, None] + H + span)[:, None, :]]
        self.geo = (self.corner, self.size, deep, radius, k, t, T)
        self.jgeo = (_j(self.corner), _j(self.size), deep, radius, k, t, T)


@functools.lru_cache(maxsize=None)
def _prelude(case):
    return _Prelude(**CASES[case])


def _jax_b_par(pos, mass, levels, deep, radius):
    """JAX's deep-path targets, as `_bh_accelerations` computes them inline
    (nbodysim_tpu/physics/barneshut.py:1456-1520), from JAX's own
    extraction and pyramid."""
    ext = jb._extract_heavy_outliers(jnp.asarray(pos), jnp.asarray(mass))
    _, _, _, ci_f, _ = jb._build_pyramid(ext["bulk_pos"], ext["tree_mass"],
                                         deep, synth_quad=True)
    res = 1 << levels
    ci = ci_f >> (deep - levels)
    flat = ci[:, 0] * res + ci[:, 1]
    flat_nf = jnp.where(ext["is_out"], res * res + jnp.arange(len(pos)), flat)
    occ = jnp.zeros((res * res,), jnp.int32).at[flat_nf].add(1, mode="drop")
    hot = (occ > jb.NEAR_CAP).reshape(res, res)
    rr = radius - 1
    hotp = jnp.pad(hot, rr)
    bmask = jnp.zeros((res, res), bool)
    for ox in range(2 * rr + 1):
        for oy in range(2 * rr + 1):
            bmask = bmask | hotp[ox:ox + res, oy:oy + res]
    return np.asarray(bmask.reshape(-1)[flat] & ~ext["is_out"]), ci_f


@pytest.mark.parametrize("case", list(CASES))
def test_deep_targets_tiles_and_sub_cells_equal_jax(case):
    p = _prelude(case)
    jb_par, jci_f = _jax_b_par(*SCENE, p.levels, p.deep, p.radius)
    np.testing.assert_array_equal(as_np(p.ci_f), np.asarray(jci_f))
    np.testing.assert_array_equal(as_np(p.b_par), jb_par)
    assert 0 < int(p.b_par.sum()) < N
    k, t, T = TILES["k"], TILES["t"], TILES["T"]
    jsel = jb._tile_select(jci_f, jnp.asarray(jb_par), p.deep, t, T,
                           p.radius)
    for got, ref in zip((p.tid, p.tile_slot, p.orig), jsel):
        np.testing.assert_array_equal(as_np(got), np.asarray(ref))
    # Cells at the tiles' sub-resolution, in JAX's f32 order.
    rf = (1 << p.deep) << k
    u = (_j(p.bulk_pos) - _j(p.corner)) / _j(p.size)
    jsub = jnp.clip((u * rf).astype(jnp.int32), 0, rf - 1)
    sub, _ = tb._cell_ids(p.bulk_pos, p.corner, p.size, rf)
    np.testing.assert_array_equal(as_np(sub), np.asarray(jsub))


def _tie_case():
    """Deep level 6, tiles of 8 (an 8 x 8 tile grid): ten tiles tie at 5
    targets across the top-8 boundary, two score higher, others lower, and
    non-target rows crowd other tiles."""
    deep, t = 6, 8
    nt_ = (1 << deep) // t
    rng = np.random.default_rng(4)
    scores = np.zeros(nt_ * nt_, np.int64)
    scores[[3, 10, 17, 40, 41, 50, 60, 62, 63, 1]] = 5
    scores[[22, 9]] = [7, 6]
    scores[[5, 33]] = [2, 4]
    rows, par = [], []
    for tile, s in enumerate(scores):
        tx, ty = divmod(tile, nt_)
        cells = rng.integers(0, t, (s + 3, 2)) + [tx * t, ty * t]
        rows.append(cells)
        par += [True] * s + [False] * 3
    ci = np.concatenate(rows)
    order = rng.permutation(len(ci))
    return ci[order], np.asarray(par)[order], deep, t


@pytest.mark.parametrize("T", [8, 20])
def test_tile_select_breaks_ties_as_lax_top_k(T):
    """T=8 cuts through the ten tied tiles; T=20 selects more tiles than
    have targets (score-0 tiles stay unselected and the sentinel T)."""
    ci, par, deep, t = _tie_case()
    got = tb._tile_select(as_t(ci), as_t(par), deep, t, T, 3)
    ref = jb._tile_select(jnp.asarray(ci.astype(np.int32)),
                          jnp.asarray(par), deep, t, T, 3)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(as_np(a), np.asarray(b))
    assert int(got[1][-1]) == T


@pytest.mark.parametrize("cap", [2, 700, 4099])
def test_compact_indices_match_jax(cap):
    mask = np.random.default_rng(cap).random(4096) < 0.3
    sidx, count = tb._compact_indices(as_t(mask), cap)
    jsidx, jcount = jb._compact_indices(jnp.asarray(mask), cap)
    np.testing.assert_array_equal(as_np(sidx), np.asarray(jsidx))
    assert int(count) == int(jcount)


@pytest.mark.parametrize("channels", [3, 6])
def test_aggregate_window_eval_matches_jax(channels):
    """Mono [M, 3] rows and 6-channel rows (monopole + quadrupole), each
    particle's own row subtracted from its home cell."""
    rng = np.random.default_rng(channels)
    r, rr, n = 16, 2, 1500
    side = r + 2 * rr
    g = rng.normal(size=(r, r, channels)).astype(np.float32)
    g[..., 0] = np.abs(g[..., 0]) * 5.0
    g[..., 1:3] *= 40.0
    g[4:6, 4:6, 0] = 0.0                       # empty cells
    gp = np.pad(g, ((rr, rr), (rr, rr), (0, 0)))
    ci = rng.integers(0, r, (n, 2))
    pos = (rng.uniform(0.0, 1.0, (n, 2)) * 16.0).astype(np.float32)
    payload = (0.1 * g[ci[:, 0], ci[:, 1]]).astype(np.float32)
    base = (ci[:, 0] + rr) * side + ci[:, 1] + rr
    got = tb._aggregate_window_eval(as_t(gp.reshape(-1, channels)),
                                    as_t(base), side, as_t(payload),
                                    as_t(pos), 1.5, rr)
    ref = jb._aggregate_window_eval(jnp.asarray(gp.reshape(-1, channels)),
                                    jnp.asarray(base.astype(np.int32)), side,
                                    jnp.asarray(payload), jnp.asarray(pos),
                                    1.5, rr)
    _close(got, ref)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("band", [False, True])
def test_deep_near_aggregates_match_jax(case, band):
    """The deep path's inner window on the padded (m, sx, sy) grid, and a
    row band of it (row0 > 0, the banded tree's form)."""
    p = _prelude(case)
    rin = 1
    g3 = torch.stack(p.grids[p.deep][:3], -1)
    gp = torch.nn.functional.pad(g3, (0, 0, rin, rin, rin, rin))
    row0 = 0
    if band:
        row0, rows = 32, 48
        gp = gp[row0:row0 + rows + 2 * rin]
    s_d = p.size / (1 << p.deep)
    pay = p.payload[:, :3]
    got = tb._deep_near_aggregates(p.pos, pay, gp, p.ci_f, EPS_SQ, s_d,
                                   rr=rin, row0=row0)
    ref = jb._deep_near_aggregates(_j(p.pos), _j(pay), _j(gp), _j(p.ci_f),
                                   EPS_SQ, _j(s_d), rr=rin, row0=row0)
    _close(got, ref, rows=as_np(p.b_par))


@pytest.mark.parametrize("radius", [3, 4])
@pytest.mark.parametrize("band", [False, True])
def test_fold_aggregate_ring_matches_jax(radius, band):
    """The outer aggregate ring (rr = 2 and 3) folded into the deep
    locals, on the full deep grid and on a row band."""
    p = _prelude("R3")
    rr = radius - 1
    r = 1 << p.deep
    window = tuple(torch.nn.functional.pad(g, (rr, rr, rr, rr))
                   for g in p.grids[p.deep])
    local, row0, rows = p.local_deep, 0, r
    if band:
        row0, rows = 40, 24
        window = tuple(w[row0:row0 + rows + 2 * rr] for w in window)
        local = tuple(a[row0:row0 + rows] for a in local)
    got = tb._fold_aggregate_ring(local, window, p.corner, p.size, r,
                                  EPS_SQ, radius, row0, rows)
    ref = jb._fold_aggregate_ring(
        tuple(map(_j, local)), tuple(map(_j, window)), _j(p.corner),
        _j(p.size), r, EPS_SQ, radius, jnp.int32(row0), rows)
    assert len(got) == 9
    for a, b in zip(got, ref):
        _close(a, b)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("compact", [False, True])
def test_tile_scatter_matches_jax(case, compact):
    """All rows, and the compacted source rows with their mask (as
    `_tile_eval` passes them)."""
    p = _prelude(case)
    args = [p.payload, p.bulk_pos, p.ci_f]
    kw = {}
    if compact:
        src = tb._tile_src_mask(p.ci_f, p.tile_slot, p.deep, p.radius,
                                TILES["t"], TILES["T"])
        jsrc = jb._tile_src_mask(_j(p.ci_f), _j(p.tile_slot), p.deep,
                                 p.radius, TILES["t"], TILES["T"])
        np.testing.assert_array_equal(as_np(src), np.asarray(jsrc))
        sidx, _ = tb._compact_indices(src, 3000)
        valid = sidx < N
        ss = torch.clamp(sidx, max=N - 1)
        args = [torch.where(valid[:, None], p.payload[ss], 0.0),
                p.bulk_pos[ss], p.ci_f[ss]]
        kw = {"src_mask": valid}
    got = tb._tile_scatter(*args, p.tile_slot, p.orig, *p.geo, **kw)
    ref = jb._tile_scatter(*map(_j, args), _j(p.tile_slot), _j(p.orig),
                           *p.jgeo, **{k: _j(v) for k, v in kw.items()})
    assert float(got[..., 0].sum()) > 0
    _close(got, ref)


def test_tile_scatter_keeps_jaxs_halo_cap():
    """131,072 rows, 80% of them within `radius` of an edge between two
    selected tiles: the halo sources outnumber the cap max(m // 4, 65536),
    so the rows past it drop, in index order, as in the JAX package."""
    deep, radius, k, t, T = 6, 3, 2, 8, 8
    rng = np.random.default_rng(12)
    m = 131_072
    nt_ = (1 << deep) // t
    # Selected: a 2 x 4 block of tiles; bodies in its edge bands.
    block = [(tx, ty) for tx in (2, 3) for ty in (1, 2, 3, 4)]
    tile_slot = np.full(nt_ * nt_ + 1, T, np.int64)
    for s, (tx, ty) in enumerate(block):
        tile_slot[tx * nt_ + ty] = s
    orig = np.asarray([[tx * t - radius, ty * t - radius]
                       for tx, ty in block], np.int64)
    which = rng.integers(0, len(block), m)
    home = np.asarray(block)[which]
    edge = rng.random(m) < 0.8
    off = rng.uniform(0.0, t, (m, 2))
    band = np.where(rng.random(m) < 0.5, rng.uniform(0, radius, m),
                    rng.uniform(t - radius, t, m))
    off[edge, 0] = band[edge]
    cell = home * t + off
    size = np.float32(1 << deep)
    corner = np.zeros(2, np.float32)
    bulk = (cell * (size / (1 << deep))).astype(np.float32)
    ci_f, _ = tb._cell_ids(as_t(bulk), as_t(corner), as_t(size), 1 << deep)
    payload = rng.uniform(0.5, 2.0, (m, 6)).astype(np.float32)
    cands = tb._tile_candidates(ci_f, as_t(tile_slot), t, T, radius, nt_)
    on_edge = int((cands[1][0] | cands[2][0] | cands[3][0]).sum())
    cap = tb._halo_cap(m)
    assert cap == min(m, max(m // 4, 65536)) and on_edge > cap
    geo = (as_t(corner), as_t(size), deep, radius, k, t, T)
    got = tb._tile_scatter(as_t(payload), as_t(bulk), ci_f, as_t(tile_slot),
                           as_t(orig), *geo)
    ref = jb._tile_scatter(jnp.asarray(payload), jnp.asarray(bulk),
                           _j(ci_f), _j(as_t(tile_slot)), _j(as_t(orig)),
                           jnp.asarray(corner), jnp.asarray(size), deep,
                           radius, k, t, T)
    _close(got, ref)
    # The halo mass is that of the first `cap` on-edge rows, each counted
    # once per selected neighbour window it reaches.
    home_only = tb._tile_scatter(as_t(payload), as_t(bulk), ci_f,
                                 as_t(tile_slot), as_t(orig), *geo,
                                 src_mask=torch.zeros(m, dtype=torch.bool))
    reach = sum(as_np(c[0]).astype(np.float64) for c in cands[1:])
    first = np.flatnonzero(reach > 0)[:cap]
    expected = float((payload[first, 0] * reach[first]).sum())
    kept = float(got[..., 0].double().sum() - home_only[..., 0].double().sum())
    np.testing.assert_allclose(kept, expected, rtol=1e-5)
    assert expected < float((payload[:, 0] * reach).sum())


@pytest.mark.parametrize("case", list(CASES))
def test_tile_chain_matches_jax(case):
    p = _prelude(case)
    g3k = tb._tile_scatter(p.payload, p.bulk_pos, p.ci_f, p.tile_slot,
                           p.orig, *p.geo)
    got = tb._tile_chain(p.local_w, g3k, p.orig, p.corner, p.size,
                         p.deep, p.radius, EPS_SQ, TILES["k"], TILES["t"],
                         TILES["T"])
    ref = jb._tile_chain(_j(p.local_w), _j(g3k), _j(p.orig), _j(p.corner),
                         _j(p.size), p.deep, p.radius, EPS_SQ, TILES["k"],
                         TILES["t"], TILES["T"])
    assert got.shape == ref.shape
    for c in range(9):
        _close(got[..., c], ref[..., c])


@pytest.mark.parametrize("case", list(CASES))
def test_tile_apply_matches_jax(case):
    p = _prelude(case)
    g3k = tb._tile_scatter(p.payload, p.bulk_pos, p.ci_f, p.tile_slot,
                           p.orig, *p.geo)
    local_w = tb._tile_chain(p.local_w, g3k, p.orig, p.corner, p.size,
                             p.deep, p.radius, EPS_SQ, TILES["k"],
                             TILES["t"], TILES["T"])
    args = (p.pos, p.payload, p.bulk_pos, p.ci_f, p.b_par, local_w, g3k,
            p.tile_slot, p.orig)
    refined, far, near = tb._tile_apply(*args, *p.geo[:4], EPS_SQ,
                                        *p.geo[4:])
    jref, jfar, jnear = jb._tile_apply(*map(_j, args), *p.jgeo[:4], EPS_SQ,
                                       *p.jgeo[4:])
    np.testing.assert_array_equal(as_np(refined), np.asarray(jref))
    rows = as_np(refined)
    assert 0 < rows.sum() <= as_np(p.b_par).sum()
    _close(far, jfar, rows=rows)
    _close(near, jnear, rows=rows)


# -- the JAX package's contracts, held by the port ------------------------------

def _port(pos, mass, **cfg):
    return as_np(tb.bh_accelerations(as_t(pos), as_t(mass),
                                     nt.SimConfig(**{"n": len(pos), **cfg})))


def _exact(pos, mass):
    return as_np(tforces.direct_accelerations(as_t(pos), as_t(mass),
                                              eps_sq=EPS_SQ))


def _rel_err(a, ref):
    return (np.linalg.norm(a - ref, axis=1)
            / (np.linalg.norm(ref, axis=1) + 1e-12))


def test_deep_chain_is_inert_without_overflow():
    """No overflowing cell: the deep branch selects nothing, and only the
    deeper (synthesized) pyramid's roundoff differs from the plain tree."""
    pos, mass = _lattice(2048)
    assert tb.bh_near_overflow(as_t(pos), as_t(mass),
                               nt.SimConfig(n=2048, bh_levels=4)) == 0
    a0 = _port(pos, mass, force_backend="bh", bh_levels=4)
    a1 = _port(pos, mass, force_backend="bh", bh_levels=4, bh_deep_levels=8)
    np.testing.assert_allclose(a1, a0, rtol=1e-4, atol=1e-7)


def test_deep_chain_background_is_exact_tier_and_blobs_bounded():
    pos, mass = SCENE
    assert tb.bh_near_overflow(as_t(pos), as_t(mass),
                               nt.SimConfig(n=N, bh_levels=4)) > 1000
    a = as_np(tb._bh_accelerations(
        as_t(pos), as_t(mass), levels=4, eps_sq=EPS_SQ, g_const=1.0,
        near_cap=tb.NEAR_CAP, radius=3, deep_levels=9))
    a_d = _exact(pos, mass)
    assert np.isfinite(a).all()
    assert np.median(_rel_err(a, a_d)[N // 2:]) < 2e-2
    assert (np.linalg.norm(a, axis=1).max()
            < 10.0 * np.linalg.norm(a_d, axis=1).max())


def test_tiles_beat_no_tiles_and_are_inert_without_hot_cells():
    """The JAX test's configuration: levels 5, deep 7, 3 tile levels of
    16 cells."""
    pos, mass = SCENE
    a_d = _exact(pos, mass)
    cfg = _config(**CASES["R3"], tiles=True)
    e0 = np.median(_rel_err(_port(pos, mass, **{**cfg, "bh_tile_levels": 0}),
                            a_d))
    e3 = np.median(_rel_err(_port(pos, mass, **{**cfg, "bh_tile_levels": 3}),
                            a_d))
    assert e3 < 0.7 * e0, (e3, e0)
    up, um = _lattice(2048, seed=1)
    assert tb.bh_near_overflow(as_t(up), as_t(um), nt.SimConfig(
        n=2048, bh_levels=CASES["R3"]["levels"])) == 0
    cfg = _config(**CASES["R3"], tiles=True, n=2048)
    u3 = _port(up, um, **cfg)
    u0 = _port(up, um, **{**cfg, "bh_tile_levels": 0})
    np.testing.assert_allclose(u3, u0, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("cap", ["_refined_cap", "_scatter_cap",
                                 "_deep_rows_cap"])
def test_compacted_passes_equal_the_full_pass(monkeypatch, cap):
    """Each compaction (the tile apply's targets, the tile scatter's
    sources, the deep rows) at a cap that engages (9n/10) and at one that
    overflows (16, the full-length fallback) equals the full pass bit for
    bit."""
    pos, mass = SCENE
    cfg = _config(**CASES["R3"], tiles=True)
    full = _port_eval("R3-tiles")
    for fn in (lambda n: (9 * n) // 10, lambda n: 16):
        monkeypatch.setattr(tb, cap, fn)
        np.testing.assert_array_equal(_port(pos, mass, **cfg), full)


def test_deep_chain_convolutions_run_with_tf32_off(monkeypatch):
    """Fault F1: every M2L convolution of the deep chain (the global levels
    and the tiles' sub-levels) runs with cuDNN's TF32 off; the chain has no
    matmul or einsum."""
    seen = []
    real_conv2d = torch.nn.functional.conv2d

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real_conv2d(*args, **kwargs)

    monkeypatch.setattr(tb.F, "conv2d", spy)
    torch.backends.cudnn.allow_tf32 = True
    p = CASES["R3"]
    pos, mass = SCENE
    _port(pos, mass, **_config(**p, tiles=True))
    # Levels 2..deep, then the k tile sub-levels as one batch each.
    assert seen == [False] * (p["deep"] - 1 + TILES["k"])
    assert torch.backends.cudnn.allow_tf32 is True


def test_auto_resolution_enables_the_deep_chain(monkeypatch):
    """The JAX test's recipe: a small auto threshold and residual cap make
    the clustered scene's overflow switch the chain on; both packages pin
    the same configuration, with a warning naming it."""
    pos, mass = SCENE
    cfg = dict(n=N, force_backend="auto", bh_levels=4)
    monkeypatch.setattr(jforces, "BH_AUTO_THRESHOLD", 1024)
    monkeypatch.setattr(jb, "_OVERFLOW_CAP", 100)
    monkeypatch.setattr(tforces, "BH_AUTO_THRESHOLD", 1024)
    monkeypatch.setattr(tb, "_OVERFLOW_CAP", 100)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jcfg = jforces.resolve_config_for_state(
            jnp.asarray(pos), jnp.asarray(mass), JaxConfig(**cfg))
    with pytest.warns(RuntimeWarning, match="deep-overflow"):
        got = tforces.resolve_config_for_state(as_t(pos), as_t(mass),
                                               nt.SimConfig(**cfg))
    fields = ("force_backend", "bh_deep_levels", "bh_tile_levels",
              "bh_nf_sparse")
    assert tuple(getattr(got, f) for f in fields) == tuple(
        getattr(jcfg, f) for f in fields) == ("bh", -1, -1, 0)
