"""PyTorch port: the x-slab-banded multi-device octree (`parallel/tree3d.py`)
on gloo process groups of P = 8 and P = 2 CPU ranks: the 3D cases of
tests/test_tree_banded.py, on the JAX tests' own draws.

Every case is held to the port's single-device octree (`bh_accelerations`)
at the JAX tests' bound, 2e-5 * max|a| (5e-5 on the overflow and fallback
scenes); the deep chain with tiles also to the JAX package's banded octree
under `jax.shard_map` (in 3D jitted JAX is the reference: the port's
single-device chain is within ~3e-6 * max|a| of it,
tests/test_torch_deep3d.py). The JAX test of the Pallas near field becomes
K7's band-window launch form (on the uniform scene): its window grid and
counts checked on every call. The JAX tests' compiled-FLOP scaling becomes the port's work counts.

One spawn per mesh size runs every case inside its ranks, and the
single-device references after them, shared out over the ranks
(tests/_torch_dist.py): the plain near field costs ~9 s a level-5 octree
on one CPU thread. N <= 4096 and levels 3-5: the compact-window cases take
a band slack of 2 where the JAX tests take N = 8192 (the compaction cannot
pay for itself at N = 4096 with the default slack of 4).
"""

import numpy as np
import pytest

import jax
import nbodysim_tpu as nb
from nbodysim_tpu.config import SimConfig as JaxConfig
from nbodysim_tpu_torch.parallel.tree import compact_capacity

import _torch_dist
from _torch_helpers import jax_arrays
from test_tree_banded import _banded3 as jax_banded3
from test_tree_banded import _clustered, _uniform3


def _np(pm):
    return tuple(np.asarray(a) for a in pm)


def _cfg(**kw):
    return {"n": 4096, "dim": 3, "force_backend": "bh", "bh_levels": 5} | kw


def _scaled(pm, s):
    return (np.asarray(pm[0]) * np.array(s, np.float32), np.asarray(pm[1]))


def _wide_blob(n, seed=0):
    """JAX's uniform draw with half the bodies in a blob a fifth of its
    span: the hot tiles' edges hold more halo rows than a binding cap
    keeps."""
    pos, mass = (np.array(a) for a in _uniform3(n, seed=seed))
    pos[:n // 2] = pos[:n // 2] * 0.2 + np.array([300.0, -200.0, 100.0],
                                                 np.float32)
    return pos, mass


_PL = jax_arrays(nb.init_scene(
    "plummer", nb.SimConfig(n=4096, dim=3, force_backend="xla",
                            softening=10.0),
    total_mass=1e4, scale_radius=1000.0))
U0 = _np(_uniform3(4096))
TILES = (_np(_clustered(2048, dim=3)),
         _cfg(n=2048, bh_levels=4, bh_deep_levels=6, bh_tile_levels=2),
         2e-5, {})

# key -> (inputs, port config fields, bound, extra case arguments)
CASES8 = {
    "uniform": (U0, _cfg(), 2e-5, {"check_k7": True}),
    "plummer": ((_PL["pos"], _PL["mass"]), _cfg(softening=10.0), 2e-5, {}),
    "overflow_residual": (_scaled(_uniform3(4096, seed=3), [1.0, 1.0, 0.02]),
                          _cfg(bh_accept_radius=2), 5e-5, {}),
    "fallback_small_grid": (_np(_uniform3(512)), _cfg(n=512, bh_levels=3),
                            2e-5, {}),
    "compact_window": (_np(_uniform3(4096, seed=11)), _cfg(), 2e-5,
                       {"slack": 2}),
    "compact_fallback_slab": (_scaled(_uniform3(4096, seed=12),
                                      [0.02, 1.0, 1.0]), _cfg(), 5e-5,
                              {"slack": 2}),
    "deep": (_np(_clustered(4096, dim=3)),
             _cfg(bh_deep_levels=7, bh_tile_levels=0), 2e-5, {}),
    "deep_compact": (_np(_clustered(4096, dim=3, seed=5)),
                     _cfg(bh_deep_levels=7, bh_tile_levels=0), 5e-5,
                     {"slack": 2}),
}
CASES2 = {
    "two_device": (_np(_uniform3(2048, seed=5)), _cfg(n=2048, bh_levels=4),
                   2e-5, {}),
    "radius3_fold": (_np(_clustered(2048, dim=3, seed=6)),
                     _cfg(n=2048, bh_levels=4, bh_deep_levels=6,
                          bh_accept_radius=3, bh_tile_levels=0), 2e-5, {}),
    "tiles": TILES,
    # The tiles' halo-source cap binding (least cap 1: a quarter of the
    # rows scattered) after the single device's compacted scatter (1536
    # rows): the banded scatter must keep the single device's halo rows
    # (keeping its own quarter of all N misses by ~9% of max|a|).
    "tiles_halo_cap": (_wide_blob(2048), TILES[1], 2e-5,
                       {"halo_min": 1, "scatter_cap": 1536}),
    "tf32": TILES[:3] + ({"spy_conv": True},),
    # Each rank's work against P = 8's on the same input.
    "work": CASES8["compact_window"],
}
# The single-device references that show the scenes engage the deep chain
# and the tiles (what the JAX tests assert beside their comparisons).
ENGAGE = {
    "flat_of_deep": (CASES8["deep"][0], _cfg(bh_deep_levels=0)),
    "untiled": (TILES[0], TILES[1] | {"bh_tile_levels": 0}),
}


def _jobs(cases, extra_refs=()):
    jobs = [(k, "banded3", {"pos": pm[0], "mass": pm[1], "cfg": cfg} | kw)
            for k, (pm, cfg, _, kw) in cases.items()]
    refs = [("ref_" + k, "single_tree", {"pos": pm[0], "mass": pm[1],
                                         "cfg": cfg} | {
        a: v for a, v in kw.items() if a in ("halo_min", "scatter_cap")})
            for k, (pm, cfg, _, kw) in cases.items()
            if k not in ("tf32", "work")]
    refs += [("ref_" + k, "single_tree", {"pos": pm[0], "mass": pm[1],
                                          "cfg": cfg})
             for k, (pm, cfg) in extra_refs]
    return jobs, refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pg")
    jobs8, refs8 = _jobs(CASES8)
    jobs2, refs2 = _jobs(CASES2, ENGAGE.items())
    return {8: _torch_dist.run(8, jobs8, tmp, refs8),
            2: _torch_dist.run(2, jobs2, tmp, refs2)}


def _got(runs, p, key):
    for r in runs[p]:
        if key in r:
            out = r[key]
            assert out[0] == "ok", out[2] if len(out) > 2 else out
            return out[1]
    raise KeyError(key)


def _work(runs, p, key):
    return [r[key][1]["work"] for r in runs[p]]


@pytest.mark.parametrize("p,key", [(8, k) for k in CASES8]
                         + [(2, k) for k in CASES2 if k != "work"])
def test_banded3_matches_single_device_octree(runs, p, key):
    _, _, bound, _ = (CASES8 if p == 8 else CASES2)[key]
    got = _got(runs, p, key)["acc"]
    ref = _got(runs, p, "ref_" + ("tiles" if key == "tf32" else key))
    np.testing.assert_allclose(got, ref, atol=bound * np.abs(ref).max())


def test_banded3_deep_chain_and_tiles_match_jax_banded(runs, eight_devices):
    """The deep chain with its tiles against the JAX package's banded
    octree under shard_map at P = 2 (the JAX test's scene and sizes)."""
    pm, cfg, bound, _ = TILES
    ref = jax_banded3(pm[0], pm[1], JaxConfig(**cfg), n_dev=2)
    got = _got(runs, 2, "tiles")["acc"]
    np.testing.assert_allclose(got, ref, atol=bound * np.abs(ref).max())


def test_deep_chain_and_tiles_engage(runs):
    """The scenes exercise what they are for: the deep chain changes the
    forces against the plain octree, and the tiles against the untiled
    deep chain (the port's single-device octrees)."""
    for key, base in (("deep", "flat_of_deep"), ("tiles", "untiled")):
        p = 8 if key == "deep" else 2
        a = _got(runs, p, "ref_" + key)
        a0 = _got(runs, 2, "ref_" + base)
        assert np.abs(a - a0).max() > 1e-3 * np.abs(a).max(), key


def test_branches_taken(runs):
    """Each scene takes the branch it is here for, on at least one rank:
    banded or replicated, compact or whole-set sort, the residual, the deep
    band's compaction and its fallback, the tiles."""
    assert all(w["replicated"] for w in _work(runs, 8, "fallback_small_grid"))
    assert not any(w["replicated"] for w in _work(runs, 8, "uniform"))
    assert all(w["sorted_len"] == 4096 for w in _work(runs, 8, "uniform"))
    assert compact_capacity(4096, 32 // 8 + 2, 32, slack=2) < 4096
    assert all(w["sorted_len"] == w["window_capacity"] < 4096
               for w in _work(runs, 8, "compact_window"))
    mixed = [w["sorted_len"] for w in _work(runs, 8, "compact_fallback_slab")]
    assert 4096 in mixed and min(mixed) < 4096
    deep = [w["deep_band_particles"] <= w["deep_capacity"]
            for w in _work(runs, 8, "deep_compact")]
    assert True in deep and False in deep
    assert all("deep_capacity" in w for w in _work(runs, 2, "tiles"))
    assert all(w["window_rows"] == w["band_rows"] + 4
               for w in _work(runs, 2, "radius3_fold"))


def test_k7_band_window_counts_contract(runs):
    """K7's band-window launch form: on every rank the window grid has
    center_rows + 2rr x-slabs, its counts the grid's cell shape, and every
    slot at or above its cell's count empty (checked on each call)."""
    for r in runs[8]:
        rep = r["uniform"][1]["report"]
        assert rep["k7_calls"] == 1 and rep["k7_bad"] == 0, rep
        assert r["uniform"][1]["work"]["k7_launches"] == 1


def test_banded3_convolutions_run_with_tf32_off(runs):
    """Fault F1: every M2L convolution of the banded octree (the
    replicated coarse levels, the banded levels, the tiles' sub-levels)
    runs with cuDNN's TF32 off, and the flag is restored."""
    for r in runs[2]:
        rep = r["tf32"][1]["report"]
        # Levels 2..deep (6), then the 2 tile sub-levels as one batch each.
        assert rep["tf32"] == [False] * (6 - 1 + 2)
        assert rep["tf32_after"] is True


def test_work_counts_fall_with_mesh_size(runs):
    """The port's own scaling evidence (the JAX tests read XLA's compiled
    FLOPs): on one input, each rank's band slabs, window slabs and window
    capacity and sorted length fall from P = 2 to P = 8 (band slack 2),
    and the forces agree."""
    w2, w8 = _work(runs, 2, "work"), _work(runs, 8, "compact_window")
    for key in ("band_rows", "window_rows", "window_capacity",
                "sorted_len"):
        assert max(w[key] for w in w8) < min(w[key] for w in w2), key
    a2 = _got(runs, 2, "work")["acc"]
    a8 = _got(runs, 8, "compact_window")["acc"]
    np.testing.assert_allclose(a8, a2, atol=2e-5 * np.abs(a2).max())
