"""PyTorch port: the banded multi-device FMM (`parallel/tree.py`) on gloo
process groups of P = 2 and P = 8 CPU ranks, against the port's
single-device tree (`bh_accelerations`) at the JAX tests' bound,
2e-5 * max|a| (5e-5 on the overflow and fallback scenes;
tests/test_tree_banded.py), and on the plain scenes against the JAX
package's single-chip tree as well: the 2D cases of tests/test_tree_banded.py.

The deep chain is held to the port's own single-device eval, not to jitted
JAX: the synthesized quadrupoles amplify last bits (PERF.md, section 7).
The JAX tests' compiled-FLOP scaling cases become the port's own work
counts (window capacity, band rows, sorted length), which must fall with
P.

One spawn per mesh size runs every case inside its ranks
(tests/_torch_dist.py); each case is its own test here. N <= 4096: the
compact-window cases take a finer grid (levels 7) where the JAX tests take
N = 8192 at levels 6.
"""

import numpy as np
import pytest
import torch

import nbodysim_tpu as nb
import nbodysim_tpu_torch as nt
from nbodysim_tpu.physics.barneshut import bh_accelerations as jax_bh
from nbodysim_tpu_torch.parallel.tree import compact_capacity
from nbodysim_tpu_torch.physics.barneshut import bh_accelerations

import _torch_dist
from _torch_helpers import jax_arrays

N = 4096


def _uniform(n, span=1000.0, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-span, span, (n, 2)).astype(np.float32)
    mass = rng.uniform(0.1, 10.0, n).astype(np.float32)
    return pos, mass


def _clustered(n, seed=0, frac=0.5):
    """A fraction of the bodies in a tight blob (it overflows the buckets
    and engages the deep chain), the rest uniform."""
    pos, mass = _uniform(n, seed=seed)
    k = int(n * frac)
    pos[:k] = pos[:k] * 0.01 + np.array([300.0, -200.0], np.float32)
    return pos, mass


def _cfg(**kw):
    return {"n": N, "force_backend": "bh"} | kw


_DISC = jax_arrays(nb.init_scene(
    "uniform_disc", nb.SimConfig(n=N, bh_levels=6, force_backend="bh")))
_PL = jax_arrays(nb.init_scene(
    "plummer", nb.SimConfig(n=N, force_backend="xla", softening=10.0),
    total_mass=1e4, scale_radius=1000.0))
U0 = _uniform(N)
STRIP = (U0[0] * np.array([1.0, 0.02], np.float32), U0[1])
XSTRIP = (_uniform(N, seed=12)[0] * np.array([0.02, 1.0], np.float32),
          _uniform(N, seed=12)[1])
CL = _clustered(N)
CL2 = _clustered(2048, seed=7)
BLOB78 = _clustered(N, seed=9, frac=7 / 8)

# key -> (inputs, port config fields, bound, extra case arguments)
CASES8 = {
    "uniform": (U0, _cfg(bh_levels=6), 2e-5, {}),
    "heavy_disc": ((_DISC["pos"], _DISC["mass"]), _cfg(bh_levels=6), 2e-5,
                   {}),
    "plummer": ((_PL["pos"], _PL["mass"]), _cfg(bh_levels=6, softening=10.0),
                2e-5, {}),
    "overflow_residual": (STRIP, _cfg(bh_levels=6, bh_accept_radius=2),
                          5e-5, {}),
    "deep": (CL, _cfg(bh_levels=6, bh_deep_levels=8), 2e-5, {}),
    "deep_compact": (CL, _cfg(bh_levels=7, bh_deep_levels=9), 5e-5, {}),
    "deep_compact_fallback": (BLOB78, _cfg(bh_levels=7, bh_deep_levels=9),
                              5e-5, {}),
    "tiles_compact": (CL, _cfg(bh_levels=7, bh_deep_levels=9,
                               bh_tile_levels=3, bh_tile_size=16), 2e-5, {}),
    "fallback_small_grid": ((U0[0][:512], U0[1][:512]),
                            _cfg(n=512, bh_levels=4), 2e-5, {}),
    "compact_window": (_uniform(N, seed=11), _cfg(bh_levels=7), 2e-5, {}),
    "compact_fallback_band": (XSTRIP, _cfg(bh_levels=7), 5e-5, {}),
    "k3_counts": (CL, _cfg(bh_levels=7), 2e-5, {"check_k3": True}),
    "work": (_uniform(N, seed=21), _cfg(bh_levels=7), 2e-5, {}),
}
CASES2 = {
    "deep_two": (CL2, _cfg(n=2048, bh_levels=5, bh_deep_levels=7), 2e-5, {}),
    "uniform_two": (_uniform(2048, seed=5), _cfg(n=2048, bh_levels=5), 2e-5,
                    {}),
    "tiles_two": (CL, _cfg(bh_levels=5, bh_deep_levels=7, bh_tile_levels=3,
                           bh_tile_size=16), 2e-5, {}),
    "tf32": (CL, _cfg(bh_levels=5, bh_deep_levels=7, bh_tile_levels=3,
                      bh_tile_size=16), 2e-5, {"spy_conv": True}),
    # Slack 0: a capacity of 1024 rows, below every band's window.
    "slack_forces_fallback": (_uniform(N, seed=13), _cfg(bh_levels=6), 2e-5,
                              {"slack": 0}),
    "work": CASES8["work"],
}


def _jobs(cases):
    return [(key, "banded", {"pos": pm[0], "mass": pm[1], "cfg": cfg} | kw)
            for key, (pm, cfg, _, kw) in cases.items()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pg")
    return {8: _torch_dist.run(8, _jobs(CASES8), tmp),
            2: _torch_dist.run(2, _jobs(CASES2), tmp)}


def _single(pm, cfg):
    return bh_accelerations(torch.tensor(pm[0]), torch.tensor(pm[1]),
                            nt.SimConfig(**cfg)).numpy()


def _got(runs, p, key):
    out = runs[p][0][key]
    assert out[0] == "ok", out[2] if len(out) > 2 else out
    return out[1]


@pytest.mark.parametrize("p,key", [(8, k) for k in CASES8 if k != "work"]
                         + [(2, k) for k in CASES2 if k != "work"])
def test_banded_matches_single_device_tree(runs, p, key):
    pm, cfg, bound, _ = (CASES8 if p == 8 else CASES2)[key]
    got = _got(runs, p, key)
    ref = _single(pm, cfg)
    np.testing.assert_allclose(got["acc"], ref,
                               atol=bound * np.abs(ref).max())


@pytest.mark.parametrize("key", ["uniform", "heavy_disc", "plummer"])
def test_banded_matches_jax_single_chip_tree(runs, key):
    pm, cfg, _, _ = CASES8[key]
    got = _got(runs, 8, key)["acc"]
    jcfg = nb.SimConfig(**cfg)
    ref = np.asarray(jax_bh(pm[0], pm[1], jcfg))
    # The single-device trees' own bound (tests/test_torch_barneshut.py).
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


def test_branches_taken(runs):
    """Each scene takes the branch it is here for, on at least one rank:
    banded or replicated, compact or whole-set sort, residual, deep
    compaction and its fallback."""
    def work(p, key):
        return [r[key][1]["work"] for r in runs[p]]

    assert all(w["replicated"] for w in work(8, "fallback_small_grid"))
    assert not any(w["replicated"] for w in work(8, "uniform"))
    assert all(w["sorted_len"] == N for w in work(8, "uniform"))
    compact = work(8, "compact_window")
    assert all(w["sorted_len"] == w["window_capacity"] < N for w in compact)
    mixed = [w["sorted_len"] for w in work(8, "compact_fallback_band")]
    assert N in mixed and min(mixed) < N
    assert all(w["window_capacity"] < w["window_particles"]
               and w["sorted_len"] == N
               for w in work(2, "slack_forces_fallback"))
    deep = [w["deep_band_particles"] <= w["deep_capacity"]
            for w in work(8, "deep_compact_fallback")]
    assert True in deep and False in deep
    assert all("deep_capacity" in w for w in work(2, "tiles_two"))


def test_deep_chain_and_tiles_engage():
    """The scenes exercise what they are for: the deep chain changes the
    forces against the plain tree, and the tiles against the untiled deep
    chain (the port's single-device trees)."""
    a_deep = _single(CL, _cfg(bh_levels=6, bh_deep_levels=8))
    a_flat = _single(CL, _cfg(bh_levels=6, bh_deep_levels=0))
    assert np.abs(a_deep - a_flat).max() > 1e-3 * np.abs(a_deep).max()
    tiles = _cfg(bh_levels=5, bh_deep_levels=7, bh_tile_levels=3,
                 bh_tile_size=16)
    a_t = _single(CL, tiles)
    a_0 = _single(CL, tiles | {"bh_tile_levels": 0})
    assert np.abs(a_t - a_0).max() > 1e-3 * np.abs(a_t).max()


def test_k3_band_window_counts_contract(runs):
    """K3's band-window launch form: on every rank the window grid has
    center_rows + 2rr rows, its counts the grid's cell shape, and every
    slot at or above its cell's count empty (checked on each call)."""
    reports = [r["k3_counts"][1]["report"] for r in runs[8]]
    assert all(rep["k3_calls"] == 1 and rep["k3_bad"] == 0
               for rep in reports), reports
    assert all(r["k3_counts"][1]["work"]["k3_launches"] == 1
               for r in runs[8])


def test_banded_convolutions_run_with_tf32_off(runs):
    """Fault F1: every M2L convolution of the banded eval (the replicated
    coarse levels, the banded levels, the tiles' sub-levels) runs with
    cuDNN's TF32 off, and the flag is restored."""
    for r in runs[2]:
        rep = r["tf32"][1]["report"]
        # Levels 2..deep (7), then the 3 tile sub-levels as one batch each.
        assert rep["tf32"] == [False] * (7 - 1 + 3)
        assert rep["tf32_after"] is True


def test_work_counts_fall_with_mesh_size(runs):
    """The port's own scaling evidence (the JAX tests read XLA's compiled
    FLOPs): on one input, each rank's band rows, window rows, window
    capacity and sorted length fall from P = 2 to P = 8."""
    w2 = [r["work"][1]["work"] for r in runs[2]]
    w8 = [r["work"][1]["work"] for r in runs[8]]
    for key in ("band_rows", "window_rows", "window_capacity",
                "sorted_len"):
        assert max(w[key] for w in w8) < min(w[key] for w in w2), key
    a2, a8 = (_got(runs, p, "work")["acc"] for p in (2, 8))
    np.testing.assert_allclose(a8, a2, atol=2e-5 * np.abs(a2).max())


def test_compact_capacity_op_model():
    """The per-band sorted length C ~ slack * n * rows_w / res = O(n / P)
    + halo, far below n at scale and shrinking with P (the JAX test's
    numbers), and the same function as the JAX package's."""
    from nbodysim_tpu.parallel.tree import compact_capacity as jax_cc

    n, levels, radius = 1 << 20, 9, 3
    res = 1 << levels
    caps = [compact_capacity(n, res // p + 2 * (radius - 1), res)
            for p in (8, 16, 32)]
    assert caps[0] < (3 * n) // 5
    assert caps == sorted(caps, reverse=True)
    assert caps[-1] < n // 6
    assert compact_capacity(n, res // 4 + 4, res) == n
    assert compact_capacity(4096, 64 // 8 + 4, 64) == 4096
    assert compact_capacity(N, 128 // 8 + 4, 128) < N   # levels 7 compacts
    for args in [(n, 68, 512), (4096, 20, 128), (8192, 12, 64), (100, 3, 8),
                 (1 << 17, 36, 256)]:
        assert compact_capacity(*args) == jax_cc(*args), args
