"""PyTorch port: the banded multi-device collision broad phases
(`parallel/collisions.py`: the bucket grid banded by grid rows, the block
pass by blocks, the sorted hash by sorted-target chunks, their residual) on
gloo process groups of P = 8 and P = 2 CPU ranks: the cases of
tests/test_collisions_banded.py, on the JAX tests' own draws.

Every case is held to the port's single-device pass (`resolve_collisions`)
at the JAX tests' bound, 2e-5 of max|dp| and max|dv| (5e-5 where the
residual or the window's full-sort fallback engages); one case of each
broad phase also to the JAX package's banded pass under `jax.shard_map` on
the 8 virtual CPU devices. The JAX tests' compiled-FLOP scaling cases
become the port's own work counts (band rows, window rows and capacity,
sorted length, band blocks, chunk rows), which must fall with P. A sharded
step with the banded bucket pass conserves momentum to 1e-5 * sum m|v|.

One spawn per mesh size runs every case inside its ranks, and the
single-device references after them, shared out over the ranks
(tests/_torch_dist.py). N <= 4096 but for the uneven-band case (the JAX
test's N = 4864: 19 blocks over 8 ranks); the compact-window case engages
the compaction at N = 4096 (res 64, 10 window rows of 64).
"""

import numpy as np
import pytest

import jax
from jax.sharding import PartitionSpec as P
from nbodysim_tpu.config import SimConfig as JaxConfig
from nbodysim_tpu.parallel import make_mesh as jax_mesh
from nbodysim_tpu.parallel.collisions import (
    sharded_collision_deltas as jax_sharded_deltas)
from nbodysim_tpu_torch.parallel.tree import compact_capacity

import _torch_dist
from _torch_helpers import jax_arrays
from test_collisions_banded import _clustered, _overlapping, _with_big


def _st(jax_state):
    return jax_arrays(jax_state)


def _bucket(n, **kw):
    return {"n": n, "collision_broad_phase": "bucket",
            "collision_grid_res": 64} | kw


def _hash(n, dim=3, **kw):
    return {"n": n, "dim": dim, "collision_broad_phase": "hash",
            "collision_cell_size": 0.0} | kw


def _block(n, **kw):
    return {"n": n, "collision_broad_phase": "block",
            "collision_cell_size": 0.0} | kw


def _x_strip(st):
    """Every body in a thin x-strip: few row bands hold them all."""
    return st.replace(pos=st.pos * np.array([0.01, 1.0], np.float32))


U2 = _st(_overlapping(4096))
U3 = _overlapping(4096, dim=3, r_lo=8.0, r_hi=30.0)
WORK = _st(_overlapping(4096, seed=21))

# key -> (state, port config fields, bound)
CASES8 = {
    "bucket_uniform": (U2, _bucket(4096), 2e-5),
    "bucket_big": (_st(_with_big(_overlapping(4096, seed=1))), _bucket(4096),
                   2e-5),
    "bucket_overflow": (_st(_clustered(4096, seed=2)),
                        _bucket(4096, collision_max_neighbors=8), 5e-5),
    "bucket_compact": (_st(_overlapping(4096, seed=3)), _bucket(4096), 2e-5),
    "bucket_compact_fallback": (_st(_x_strip(_overlapping(4096, seed=4))),
                                _bucket(4096), 5e-5),
    "bucket_res_not_divisible": (_st(_overlapping(2048, seed=6)),
                                 _bucket(2048, collision_grid_res=100), 2e-5),
    "hash3_uniform": (_st(U3), _hash(4096), 2e-5),
    "hash3_big": (_st(_with_big(_overlapping(4096, dim=3, seed=1, r_lo=8.0,
                                             r_hi=30.0))), _hash(4096),
                  2e-5),
    "hash3_overflow": (_st(_clustered(4096, dim=3, seed=2)),
                       _hash(4096, collision_max_neighbors=8), 5e-5),
    "hash2_clustered": (_st(_clustered(4096, seed=7)),
                        _hash(4096, dim=2), 2e-5),
    "block2": (U2, _block(4096), 2e-5),
    "block3": (_st(U3), _block(4096, dim=3), 2e-5),
    "block_big": (_st(_with_big(_overlapping(4096, seed=1))), _block(4096),
                  2e-5),
    "block_clustered": (_st(_clustered(4096, seed=2)), _block(4096), 5e-5),
    "block_uneven": (_st(_overlapping(4864, seed=11)), _block(4864), 2e-5),
    "dense_small": (_st(_overlapping(1024, seed=8)),
                    {"n": 1024, "collision_broad_phase": "dense"}, 2e-5),
}
CASES2 = {
    "bucket_two": (_st(_overlapping(2048, seed=5)), _bucket(2048), 2e-5),
    "hash_two": (_st(_overlapping(2048, dim=3, seed=5, r_lo=8.0, r_hi=30.0)),
                 _hash(2048), 2e-5),
    "block_two": (_st(_overlapping(2048, seed=5)), _block(2048), 2e-5),
}
# The same input at both mesh sizes: each rank's work must fall with P.
WORK_CASES = {"work_bucket": _bucket(4096), "work_block": _block(4096),
              "work_hash": _hash(4096, dim=2)}
# One case of each broad phase against the JAX package's banded pass.
JAX_KEYS = ["bucket_overflow", "hash3_big", "block2"]

MOMENTUM = _st(_overlapping(2048, seed=9))
MOMENTUM_CFG = _bucket(2048, integrator="leapfrog_kdk", enable_boundary=False,
                       enable_velocity_clamp=False)


def _jobs(cases):
    jobs = [(k, "collision_work", {"state": st, "cfg": cfg})
            for k, (st, cfg, _) in cases.items()]
    jobs += [(k, "collision_work", {"state": WORK, "cfg": cfg})
             for k, cfg in WORK_CASES.items()]
    refs = [("ref_" + k, "single_collision", {"state": st, "cfg": cfg})
            for k, (st, cfg, _) in cases.items()]
    return jobs, refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pg")
    jobs8, refs8 = _jobs(CASES8)
    jobs8.append(("momentum", "steps", {"state": MOMENTUM, "prime": True,
                                        "cfg": MOMENTUM_CFG}))
    refs8 += [("ref_" + k, "single_collision", {"state": WORK, "cfg": cfg})
              for k, cfg in WORK_CASES.items()]
    jobs2, refs2 = _jobs(CASES2)
    return {8: _torch_dist.run(8, jobs8, tmp, refs8),
            2: _torch_dist.run(2, jobs2, tmp, refs2)}


def _got(runs, p, key):
    for r in runs[p]:
        if key in r:
            out = r[key]
            assert out[0] == "ok", out[2] if len(out) > 2 else out
            return out[1]
    raise KeyError(key)


def _close(got, ref, bound):
    """The JAX tests' check: the reference pass must be active, and both
    deltas (`got`: a banded case's dict) within `bound` of its max."""
    got = (got["dp"], got["dv"])
    dp_s, dv_s = ref
    assert np.abs(dp_s).max() > 0 or np.abs(dv_s).max() > 0
    np.testing.assert_allclose(got[0], dp_s,
                               atol=bound * max(np.abs(dp_s).max(), 1e-12))
    np.testing.assert_allclose(got[1], dv_s,
                               atol=bound * max(np.abs(dv_s).max(), 1e-12))


@pytest.mark.parametrize("p,key", [(8, k) for k in CASES8]
                         + [(2, k) for k in CASES2])
def test_banded_matches_single_device_pass(runs, p, key):
    bound = (CASES8 if p == 8 else CASES2)[key][2]
    _close(_got(runs, p, key), _got(runs, p, "ref_" + key), bound)


@pytest.mark.parametrize("key", JAX_KEYS)
def test_banded_matches_jax_banded_pass(runs, key, eight_devices):
    """The JAX package's banded pass under shard_map on the 8 virtual CPU
    devices, the same draws, the JAX tests' bound."""
    st, cfg, bound = CASES8[key]
    jcfg = JaxConfig(**cfg)
    fn = jax.jit(jax.shard_map(
        lambda p, v, m, r: jax_sharded_deltas(p, v, m, r, jcfg, "shards"),
        mesh=jax_mesh(8), in_specs=(P("shards"),) * 4,
        out_specs=(P("shards"), P("shards")), check_vma=False))
    ref = tuple(np.asarray(a) for a in fn(
        *(st[f] for f in ("pos", "vel", "mass", "radius"))))
    _close(_got(runs, 8, key), ref, bound)


def test_banded_work_counts_fall_with_mesh_size(runs):
    """The port's scaling evidence (the JAX tests read XLA's compiled
    FLOPs): on one input, every rank's band rows, window rows, window
    capacity and sorted length (bucket), band blocks (block) and chunk rows
    (hash) fall from P = 2 to P = 8, and the deltas agree across the two
    mesh sizes."""
    keys = {"work_bucket": ("band_rows", "window_rows", "window_capacity",
                            "sorted_len"),
            "work_block": ("band_blocks",), "work_hash": ("chunk_rows",)}
    for case, fields in keys.items():
        w2 = [r[case][1]["work"] for r in runs[2]]
        w8 = [r[case][1]["work"] for r in runs[8]]
        assert not any(w["replicated"] for w in w2 + w8), case
        for f in fields:
            assert max(w[f] for w in w8) < min(w[f] for w in w2), (case, f)
        got2, got8 = (_got(runs, p, case) for p in (2, 8))
        ref = _got(runs, 8, "ref_" + case)
        for got in (got2, got8):
            _close(got, ref, 2e-5)


def test_branches_taken(runs):
    """Each scene takes the branch it is here for, on the ranks it should:
    the compacted window (and, on the x-strip, the whole-set sort on some
    ranks but not all), the residual's banded passes over the whole
    overflow set, a rank with one block and one with none (19 blocks over
    8 ranks of 3), and the replicated pass where the rows do not split."""
    def work(key):
        return [r[key][1]["work"] for r in runs[8]]

    assert compact_capacity(4096, 64 // 8 + 2, 64) < 4096
    for key in ("bucket_compact", "work_bucket"):
        assert all(w["sorted_len"] == w["window_capacity"] < 4096
                   for w in work(key)), key
    mixed = [w["sorted_len"] for w in work("bucket_compact_fallback")]
    assert 4096 in mixed and min(mixed) < 4096
    for key in ("bucket_overflow", "hash3_overflow"):
        assert sum(w["overflow_rows"] for w in work(key)) == 4096, key
        assert all(w["residual_rows"] == 512 for w in work(key)), key
    assert "overflow_rows" not in work("bucket_uniform")[0]
    assert [w["band_blocks"] for w in work("block_uneven")] == \
        [3] * 6 + [1, 0]
    assert all(w["replicated"] for w in work("bucket_res_not_divisible"))
    assert not any(w["replicated"] for w in work("hash2_clustered"))


def test_sharded_step_banded_collisions_conserve_momentum(runs):
    """One sharded leapfrog step with the banded bucket pass conserves the
    total momentum: every impulse has its Jacobi counterpart across the
    ranks (the JAX test's bound, 1e-5 * sum m|v|)."""
    got = _got(runs, 8, "momentum")
    m = MOMENTUM["mass"][:, None]
    p0 = (m * MOMENTUM["vel"]).sum(0)
    p1 = (m * got["vel"]).sum(0)
    assert got["frame"] == 1
    scale = float(np.abs(m * MOMENTUM["vel"]).sum())
    assert np.abs(p1 - p0).max() < 1e-5 * scale
    assert np.abs(got["pos"] - MOMENTUM["pos"]).max() > 0
