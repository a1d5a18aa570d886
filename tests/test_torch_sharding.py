"""PyTorch port: the multi-device step (`nbodysim_tpu_torch.parallel`) on
gloo process groups of P = 2 and P = 8 CPU ranks, against the JAX package's
sharded step on its 8 virtual CPU devices and against the single-device
steps (the cases of tests/test_sharding.py but its `test_graft_entry`).

One spawn per mesh size runs every case of this module inside its ranks
(tests/_torch_dist.py; the workers import no JAX); each case is its own
test here. Bounds are tests/test_sharding.py's: positions 1e-6 * max|x|,
velocities 1e-3 (2e-6 * max|x| and 2e-5 * max|v| across mesh sizes);
checkpoints resumed on the same mesh match bit for bit.
"""

import numpy as np
import pytest
import torch

import nbodysim_tpu as nb
import nbodysim_tpu_torch as nt
from nbodysim_tpu.parallel import make_mesh as jax_mesh
from nbodysim_tpu.parallel import make_sharded_step as jax_sharded_step
from nbodysim_tpu.parallel import prime_accelerations_sharded as jax_prime_sh
from nbodysim_tpu.parallel import shard_state as jax_shard
from nbodysim_tpu.parallel.sharded import (
    make_sharded_rollout as jax_sharded_rollout)
from nbodysim_tpu.physics.integrators import make_step as jax_make_step
from nbodysim_tpu.physics.integrators import (
    prime_accelerations as jax_prime)

import _torch_dist
from _torch_helpers import CPU, as_np, jax_arrays, rand_cloud

N = 256


def _jcfg(**kw):
    return nb.SimConfig(**({"n": N, "force_backend": "xla"} | kw))


def _tcfg(**kw):
    """The port's config fields (a dict: the workers build the SimConfig)."""
    return {"n": N, "force_backend": "torch"} | kw


DISC = jax_arrays(nb.init_scene("uniform_disc", _jcfg()))
DISC64 = jax_arrays(nb.init_scene("uniform_disc", _jcfg(n=64)))
DISC257 = jax_arrays(nb.init_scene("uniform_disc", _jcfg(n=257)))
DISC512 = jax_arrays(nb.init_scene("uniform_disc", _jcfg(n=512)))
_PL_CFG = _jcfg(integrator="leapfrog_kdk", enable_collisions=False)
PLUMMER = jax_arrays(jax_prime(nb.init_scene("plummer", _PL_CFG), _PL_CFG))


def _zero_mass_cloud():
    """The dense colliding cloud with every 16th body massless: K2's row
    form must still move those targets (the rect pass K5 would not)."""
    pos, vel, mass, radius = rand_cloud(N, 2, seed=5)
    mass[::16] = 0.0
    return {"pos": pos, "vel": vel, "mass": mass, "radius": radius}


CLOUD = _zero_mass_cloud()
_C = rand_cloud(N, 2, seed=6)
CLOUD_STATE = {"pos": _C[0], "vel": _C[1], "acc": np.zeros_like(_C[0]),
               "mass": _C[2], "radius": _C[3], "frame": np.int32(0)}
# The banded passes' cases run on the colliding cloud: the disc's bodies
# deep inside its radius-200 centre make the pair math ill-conditioned.
BANDED_CFG = {
    "bucket": _tcfg(collision_broad_phase="bucket", collision_grid_res=64),
    "block": _tcfg(collision_broad_phase="block", collision_cell_size=0.0),
    "hash": _tcfg(collision_broad_phase="hash", collision_cell_size=0.0),
}
OCTREE_BANDED_CFG = {"n": 4096, "dim": 3, "force_backend": "bh",
                     "bh_levels": 4}
BLOB3 = np.random.default_rng(11).uniform(-1000, 1000, (4096, 3)).astype(
    np.float32)
MASS3 = np.random.default_rng(12).uniform(0.1, 10, 4096).astype(np.float32)

JOBS8 = [
    ("step", "steps", {"state": DISC, "cfg": _tcfg()}),
    ("leapfrog", "steps", {"state": PLUMMER, "cfg": _tcfg(
        integrator="leapfrog_kdk", enable_collisions=False)}),
    ("rollout", "steps", {"state": DISC, "cfg": _tcfg(
        enable_collisions=False), "n_steps": 10, "rollout": True}),
    ("divide", "shard_validates", {"state": DISC257}),
    ("bh", "steps", {"state": DISC512, "prime": True, "cfg": _tcfg(
        n=512, force_backend="bh", enable_collisions=False,
        integrator="leapfrog_kdk")}),
    ("dense_zero_mass", "dense_deltas", CLOUD),
    ("bucket_replicated", "collision_deltas", {
        "state": CLOUD_STATE, "cfg": _tcfg(collision_broad_phase="bucket",
                                           collision_grid_res=12)}),
    ("bucket_banded", "collision_deltas", {"state": CLOUD_STATE,
                                           "cfg": BANDED_CFG["bucket"]}),
    ("block_banded", "collision_deltas", {"state": CLOUD_STATE,
                                          "cfg": BANDED_CFG["block"]}),
    ("hash_banded", "collision_deltas", {"state": CLOUD_STATE,
                                         "cfg": BANDED_CFG["hash"]}),
    ("octree_replicated", "accelerations", {"pos": BLOB3, "mass": MASS3,
                                            "cfg": {"n": 4096, "dim": 3,
                                                    "force_backend": "bh",
                                                    "bh_levels": 4}}),
]


@pytest.fixture(scope="module")
def ck_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("ck")


@pytest.fixture(scope="module")
def runs8(ck_dir):
    jobs = JOBS8 + [("checkpoint", "checkpoint_resume", {
        "state": DISC, "path": str(ck_dir / "ck8"),
        "cfg": _tcfg(integrator="leapfrog_kdk")})]
    return _torch_dist.run(8, jobs, ck_dir)


def _jax_checkpoint(ck_dir):
    """A checkpoint the JAX package writes from its 8-device sharded state
    (leapfrog, after one step), and its own next 3 steps."""
    from nbodysim_tpu.io.checkpoint import save_checkpoint as jax_save

    cfg = _jcfg(integrator="leapfrog_kdk")
    mesh = jax_mesh(8)
    ss = jax_prime_sh(jax_shard(nb.ParticleState(**DISC), mesh), cfg, mesh)
    step = jax_sharded_step(cfg, mesh)
    ss = step(ss)
    path = jax_save(str(ck_dir / "ck_jax"), ss, cfg)
    for _ in range(3):
        ss = step(ss)
    return path, ss


@pytest.fixture(scope="module")
def jax_ck(ck_dir, eight_devices):
    return _jax_checkpoint(ck_dir)


@pytest.fixture(scope="module")
def runs2(runs8, ck_dir, jax_ck):
    path = _ok(runs8, "checkpoint")["path"]
    return _torch_dist.run(2, [
        ("subset", "steps", {"state": DISC64, "cfg": _tcfg(n=64)}),
        ("other_mesh", "resume_other_mesh", {"path": path, "n_steps": 3}),
        ("jax_file", "resume_other_mesh", {"path": jax_ck[0], "n_steps": 3}),
        ("bucket_banded", "collision_deltas", {"state": CLOUD_STATE,
                                               "cfg": BANDED_CFG["bucket"]}),
        ("octree_banded", "accelerations", {"pos": BLOB3, "mass": MASS3,
                                            "cfg": OCTREE_BANDED_CFG}),
    ], ck_dir)


def _ok(runs, key):
    got = runs[0][key]
    assert got[0] == "ok", got[2] if len(got) > 2 else got
    return got[1]


def _error(runs, key):
    got = runs[0][key]
    assert got[0] == "error", f"{key} ran: {got}"
    # Every rank raised the same error.
    assert all(r[key][:2] == got[:2] for r in runs), [r[key][:2] for r in runs]
    return got[1]


def _jax_sharded(cfg, arrays, p, n_steps=1):
    mesh = jax_mesh(p)
    state = nb.ParticleState(**{k: np.asarray(v) for k, v in arrays.items()})
    ss = jax_shard(state, mesh)
    step = jax_sharded_step(cfg, mesh)
    for _ in range(n_steps):
        ss = step(ss)
    return ss


def _close_pos_vel(got, ref, vel_atol=1e-3):
    scale = float(np.abs(np.asarray(ref.pos)).max())
    np.testing.assert_allclose(got["pos"], np.asarray(ref.pos),
                               atol=scale * 1e-6)
    np.testing.assert_allclose(got["vel"], np.asarray(ref.vel),
                               atol=vel_atol)


def test_sharded_matches_single_chip_and_jax(runs8, eight_devices):
    got = _ok(runs8, "step")
    state = nb.ParticleState(**DISC)
    _close_pos_vel(got, jax_make_step(_jcfg())(state))
    _close_pos_vel(got, _jax_sharded(_jcfg(), DISC, 8))
    one = nt.make_step(nt.SimConfig(**_tcfg()))(
        nt.ParticleState.from_numpy(DISC, CPU))
    _close_pos_vel(got, one)
    assert got["frame"] == 1


def test_sharded_leapfrog_matches(runs8, eight_devices):
    got = _ok(runs8, "leapfrog")
    state = nb.ParticleState(**PLUMMER)
    ref = jax_make_step(_PL_CFG)(state)
    scale = float(np.abs(np.asarray(ref.pos)).max())
    np.testing.assert_allclose(got["pos"], np.asarray(ref.pos),
                               atol=scale * 1e-6)
    jsh = _jax_sharded(_PL_CFG, PLUMMER, 8)
    np.testing.assert_allclose(got["pos"], np.asarray(jsh.pos),
                               atol=scale * 1e-6)


def test_sharded_rollout(runs8, eight_devices):
    got = _ok(runs8, "rollout")
    assert got["frame"] == 10
    assert np.all(np.isfinite(got["pos"]))
    cfg = _jcfg(enable_collisions=False)
    mesh = jax_mesh(8)
    ref = jax_sharded_rollout(cfg, mesh, 10)(
        jax_shard(nb.ParticleState(**DISC), mesh))
    # Ten steps apart from the same state: the single-device rollouts'
    # bound (tests/test_torch_step.py).
    scale = float(np.abs(np.asarray(ref.pos)).max())
    np.testing.assert_allclose(got["pos"], np.asarray(ref.pos),
                               atol=scale * 1e-4)


def test_shard_state_validates_divisibility(runs8):
    assert _error(runs8, "divide").startswith("ValueError")
    assert "divide" in _error(runs8, "divide")


def test_mesh_subset(runs2, eight_devices):
    """The sharded step on a 2-rank mesh."""
    got = _ok(runs2, "subset")
    ref = jax_make_step(_jcfg(n=64))(nb.ParticleState(**DISC64))
    scale = float(np.abs(np.asarray(ref.pos)).max())
    np.testing.assert_allclose(got["pos"], np.asarray(ref.pos),
                               atol=scale * 1e-6)


def test_sharded_bh_backend(runs8, eight_devices):
    """force_backend='bh' under the sharded step: N=512 at 8 ranks cannot
    band (res 16 / 8 < the halo), so the tree runs replicated."""
    got = _ok(runs8, "bh")
    cfg = _jcfg(n=512, force_backend="bh", enable_collisions=False,
                integrator="leapfrog_kdk")
    state = nb.ParticleState(**DISC512)
    ref = jax_make_step(cfg)(jax_prime(state, cfg))
    scale = float(np.abs(np.asarray(ref.pos)).max())
    np.testing.assert_allclose(got["pos"], np.asarray(ref.pos),
                               atol=scale * 1e-6)
    mesh = jax_mesh(8)
    jsh = jax_sharded_step(cfg, mesh)(
        jax_prime_sh(jax_shard(state, mesh), cfg, mesh))
    np.testing.assert_allclose(got["pos"], np.asarray(jsh.pos),
                               atol=scale * 1e-6)


def test_gathered_dense_pass_moves_zero_mass_targets(runs8, eight_devices):
    """K2's row-range form: each rank's rows against all of them, sources'
    mass > 0 the only mask. The JAX package's gathered pass is the
    reference; massless targets are moved too."""
    import jax
    from jax.sharding import PartitionSpec as P

    from nbodysim_tpu.parallel.collisions import gathered_dense_deltas

    dp, dv = _ok(runs8, "dense_zero_mass")
    mesh = jax_mesh(8)
    fn = jax.jit(jax.shard_map(
        lambda p, v, m, r: gathered_dense_deltas(p, v, m, r, _jcfg(),
                                                 "shards"),
        mesh=mesh, in_specs=(P("shards"),) * 4,
        out_specs=(P("shards"), P("shards")), check_vma=False))
    jdp, jdv = fn(*(CLOUD[k] for k in ("pos", "vel", "mass", "radius")))
    scale = max(float(np.abs(np.asarray(jdv)).max()), 10.0)
    np.testing.assert_allclose(dp, np.asarray(jdp), atol=1e-5 * scale)
    np.testing.assert_allclose(dv, np.asarray(jdv), atol=1e-5 * scale)
    massless = CLOUD["mass"] == 0.0
    assert np.abs(dv[massless]).max() > 0.0


def test_replicated_bucket_pass_matches_jax(runs8, eight_devices):
    """A bucket grid whose rows do not split over 8 ranks (res 12) runs
    replicated, as the JAX package runs it, on the dense colliding cloud
    (the disc's bodies deep inside its radius-200 centre make the pair
    math ill-conditioned: the packages' single-device passes differ there
    already)."""
    from nbodysim_tpu.parallel.collisions import sharded_collision_deltas
    import jax
    from jax.sharding import PartitionSpec as P

    dp, dv = _ok(runs8, "bucket_replicated")
    cfg = _jcfg(collision_broad_phase="bucket", collision_grid_res=12)
    fn = jax.jit(jax.shard_map(
        lambda p, v, m, r: sharded_collision_deltas(p, v, m, r, cfg,
                                                    "shards"),
        mesh=jax_mesh(8), in_specs=(P("shards"),) * 4,
        out_specs=(P("shards"), P("shards")), check_vma=False))
    jdp, jdv = fn(*(CLOUD_STATE[k] for k in ("pos", "vel", "mass",
                                             "radius")))
    scale = max(float(np.abs(np.asarray(jdv)).max()), 10.0)
    np.testing.assert_allclose(dp, np.asarray(jdp), atol=1e-5 * scale)
    np.testing.assert_allclose(dv, np.asarray(jdv), atol=1e-5 * scale)


@pytest.mark.parametrize("key,runs_name", [
    ("bucket_banded", "runs8"), ("bucket_banded", "runs2"),
    ("block_banded", "runs8"), ("hash_banded", "runs8"),
    ("octree_banded", "runs2")])
def test_banded_branches_match(key, runs_name, request):
    """Where the JAX package enters a banded broad phase (bucket with
    res % P == 0, block or hash, P > 1) or the banded octree (P = 2, a
    16^3 grid: 8 slabs a band), the port runs its banded counterpart,
    held to the single-device pass or octree (the JAX banded tests'
    bounds: 2e-5 of max|dp|, max|dv|; 2e-5 * max|a|)."""
    got = _ok(request.getfixturevalue(runs_name), key)
    if key == "octree_banded":
        ref = as_np(nt.compute_accelerations(
            torch.from_numpy(BLOB3), torch.from_numpy(MASS3),
            nt.SimConfig(**OCTREE_BANDED_CFG)))
        np.testing.assert_allclose(got, ref, atol=2e-5 * np.abs(ref).max())
        return
    from nbodysim_tpu_torch.physics.collisions import resolve_collisions

    st = nt.ParticleState.from_numpy(CLOUD_STATE, CPU)
    out = resolve_collisions(st, nt.SimConfig(**BANDED_CFG[key.split("_")[0]]))
    for g, ref in zip(got, (as_np(out.pos - st.pos), as_np(out.vel - st.vel))):
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(g, ref, atol=2e-5 * np.abs(ref).max())


def test_octree_replicated_where_it_cannot_band(runs8):
    """3D at 8 ranks on a 16^3 grid: 16 / 8 slabs < the halo, so the octree
    runs replicated and equals the single-device octree."""
    got = _ok(runs8, "octree_replicated")
    cfg = nt.SimConfig(n=4096, dim=3, force_backend="bh", bh_levels=4)
    ref = as_np(nt.compute_accelerations(torch.from_numpy(BLOB3),
                                         torch.from_numpy(MASS3), cfg))
    np.testing.assert_allclose(got, ref, atol=2e-5 * np.abs(ref).max())


def test_sharded_checkpoint_resume_bitwise(runs8):
    """Save a sharded state (gathered, written by rank 0), load it onto the
    same mesh, resume: bit for bit the uninterrupted sharded run."""
    got = _ok(runs8, "checkpoint")
    assert got["n"] == N
    assert got["out"]["frame"] == got["ref"]["frame"] == 6
    for f in ("pos", "vel", "acc", "mass", "radius"):
        assert np.array_equal(got["out"][f], got["ref"][f]), f


def test_sharded_checkpoint_loads_in_jax(runs8, eight_devices):
    """The port's sharded checkpoint is the JAX package's format: its
    load_checkpoint_sharded takes it, and three JAX sharded steps land on
    the port's."""
    from nbodysim_tpu.io import load_checkpoint_sharded

    got = _ok(runs8, "checkpoint")
    mesh = jax_mesh(8)
    js, jcfg = load_checkpoint_sharded(got["path"], mesh)
    assert jcfg.n == N and int(js.frame) == 3
    step = jax_sharded_step(jcfg.replace(force_backend="xla"), mesh)
    for _ in range(3):
        js = step(js)
    scale = float(np.abs(np.asarray(js.pos)).max())
    np.testing.assert_allclose(got["ref"]["pos"], np.asarray(js.pos),
                               atol=2e-6 * scale)


def test_sharded_checkpoint_reshard_other_mesh(runs8, runs2):
    """Written at 8 ranks, resumed at 2: the state does not depend on the
    mesh; the collectives' sum order does (tests/test_sharding.py's
    bounds)."""
    ref = _ok(runs8, "checkpoint")["ref"]
    got = _ok(runs2, "other_mesh")
    assert got["frame"] == ref["frame"]
    scale = np.abs(ref["pos"]).max()
    np.testing.assert_allclose(got["pos"], ref["pos"], atol=2e-6 * scale)
    vscale = max(np.abs(ref["vel"]).max(), 1e-12)
    np.testing.assert_allclose(got["vel"], ref["vel"], atol=2e-5 * vscale)


def test_sharded_step_at_one_rank_is_make_step_bitwise(tmp_path):
    """P = 1 over gloo in this process: the sharded step (ring of one hop,
    the gathered dense pass over every row) is `make_step` bit for bit."""
    import torch.distributed as dist

    from nbodysim_tpu_torch.parallel import (
        make_mesh, make_sharded_step, shard_state)

    cfg = nt.SimConfig(**_tcfg())
    state = nt.ParticleState.from_numpy(DISC, CPU)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(device_type="cpu")
        ss = shard_state(state, mesh)
        step = make_sharded_step(cfg, mesh)
        ref = state
        one = nt.make_step(cfg)
        for _ in range(3):
            ss, ref = step(ss), one(ref)
    finally:
        dist.destroy_process_group()
    for f in ("pos", "vel", "acc", "mass", "radius", "frame"):
        assert torch.equal(getattr(ss, f), getattr(ref, f)), f


def test_make_mesh_needs_the_card_unless_asked():
    """The entry point defaults to the card and raises without one."""
    from nbodysim_tpu_torch.parallel import make_mesh

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh()


def test_jax_sharded_checkpoint_loads_in_the_port(runs2, jax_ck):
    """The other direction: a checkpoint the JAX package wrote from its
    sharded state, loaded onto a 2-rank mesh by the port's
    load_checkpoint_sharded ("pallas"/"xla" backends mapped back), and
    three steps land on the JAX package's own (across mesh sizes and
    packages: tests/test_sharding.py's cross-mesh bounds)."""
    got = _ok(runs2, "jax_file")
    ref = jax_ck[1]
    assert got["frame"] == int(ref.frame) == 4
    scale = float(np.abs(np.asarray(ref.pos)).max())
    np.testing.assert_allclose(got["pos"], np.asarray(ref.pos),
                               atol=2e-6 * scale)
    vscale = max(float(np.abs(np.asarray(ref.vel)).max()), 1e-12)
    np.testing.assert_allclose(got["vel"], np.asarray(ref.vel),
                               atol=2e-5 * vscale)
