"""Multi-process workers for the port's sharding and banded parity tests
(tests/test_torch_sharding.py, tests/test_torch_tree_banded.py,
tests/test_torch_collisions_banded.py, tests/test_torch_tree3_banded.py).

A test module builds its numpy inputs from a seed, spawns one gloo process
group of P ranks on the CPU for all of its cases (`run`), and compares what
comes back with the JAX package in the parent. This module imports nothing
of JAX: the workers import it by name.

A case is a function here, registered in CASES, called on every rank as
fn(mesh, axis, **inputs); it returns picklable (numpy) results, gathered
whole where they are per-particle. A case that raises is reported as
("error", "<type>: <message>") and the next case runs.
"""

from __future__ import annotations

import traceback

import numpy as np
import torch

import nbodysim_tpu_torch as nt
from nbodysim_tpu_torch.parallel import comm

CPU = torch.device("cpu")
CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def run(world_size: int, jobs, workdir, refs=()):
    """Run jobs [(key, case name, inputs dict)] on `world_size` gloo ranks
    meeting at a file under `workdir` (a test's tmp_path); then `refs`,
    jobs of the same form that use no collective (the single-device
    references), shared out over the ranks, each run on one of them.
    Returns [per-rank {key: ("ok", result) or ("error", text)}]; a ref's
    key is in the dict of the rank that ran it."""
    return comm.spawn(_run_jobs, world_size, (jobs, refs), timeout_s=60.0,
                      workdir=str(workdir))


def _run_jobs(rank, jobs, refs=()):
    from nbodysim_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device_type="cpu")
    axis = comm.mesh_axis(mesh, "shards")
    mine = [r for i, r in enumerate(refs) if i % axis.size == rank]
    out = {}
    for key, name, inputs in list(jobs) + mine:
        try:
            out[key] = ("ok", CASES[name](mesh, axis, **inputs))
        except Exception as e:  # reported to the parent's test
            out[key] = ("error", f"{type(e).__name__}: {e}",
                        traceback.format_exc())
    return out


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def _state(arrays) -> nt.ParticleState:
    return nt.ParticleState.from_numpy(arrays, CPU)


def _whole(sharded) -> dict:
    from nbodysim_tpu_torch.parallel.sharded import gather_state

    g = gather_state(sharded)
    return {f: getattr(g, f).numpy() for f in
            ("pos", "vel", "acc", "mass", "radius")} | {
        "frame": int(g.frame)}


def _local(a: np.ndarray, axis) -> torch.Tensor:
    n_l = a.shape[0] // axis.size
    return torch.from_numpy(np.ascontiguousarray(
        a[axis.index * n_l:(axis.index + 1) * n_l]))


# ---------------------------------------------------------------------------
# The sharded step
# ---------------------------------------------------------------------------

@case
def steps(mesh, axis, state, cfg, n_steps=1, prime=False, rollout=False):
    """`n_steps` sharded steps (or one rollout) from a whole state."""
    from nbodysim_tpu_torch.parallel import (
        make_sharded_step, prime_accelerations_sharded, shard_state)
    from nbodysim_tpu_torch.parallel.sharded import make_sharded_rollout

    config = nt.SimConfig(**cfg)
    ss = shard_state(_state(state), mesh)
    if prime:
        ss = prime_accelerations_sharded(ss, config, mesh)
    if rollout:
        ss = make_sharded_rollout(config, mesh, n_steps)(ss)
    else:
        step = make_sharded_step(config, mesh)
        for _ in range(n_steps):
            ss = step(ss)
    return _whole(ss)


@case
def shard_validates(mesh, axis, state):
    from nbodysim_tpu_torch.parallel import shard_state

    shard_state(_state(state), mesh)


@case
def dense_deltas(mesh, axis, pos, vel, mass, radius):
    """The gathered dense pass's deltas of every rank's rows, whole."""
    from nbodysim_tpu_torch.parallel.collisions import gathered_dense_deltas

    dp, dv = gathered_dense_deltas(
        _local(pos, axis), _local(vel, axis), _local(mass, axis),
        _local(radius, axis), nt.SimConfig(n=pos.shape[0]), axis)
    return (comm.all_gather(dp, axis).numpy(),
            comm.all_gather(dv, axis).numpy())


@case
def collision_deltas(mesh, axis, state, cfg):
    """One sharded collision pass of a whole state, its deltas whole."""
    from nbodysim_tpu_torch.parallel.collisions import (
        sharded_collision_deltas)

    st = _state(state)
    dp, dv = sharded_collision_deltas(
        *(_local(getattr(st, f).numpy(), axis)
          for f in ("pos", "vel", "mass", "radius")),
        nt.SimConfig(**cfg), axis)
    return (comm.all_gather(dp, axis).numpy(),
            comm.all_gather(dv, axis).numpy())


@case
def accelerations(mesh, axis, pos, mass, cfg):
    """The sharded force dispatch on a whole (pos, mass), whole."""
    from nbodysim_tpu_torch.parallel.sharded import sharded_accelerations

    acc = sharded_accelerations(_local(pos, axis), _local(mass, axis),
                                nt.SimConfig(**cfg), axis)
    return comm.all_gather(acc, axis).numpy()


@case
def checkpoint_resume(mesh, axis, state, cfg, path, n_before=3,
                      n_after=3):
    """Sharded run: n_before steps, save, n_after more (the reference);
    then load the file onto the mesh and take n_after steps. Returns the
    reference, the resumed run and the checkpoint's path."""
    from nbodysim_tpu_torch.io import load_checkpoint_sharded, save_checkpoint
    from nbodysim_tpu_torch.parallel import (
        make_sharded_step, prime_accelerations_sharded, shard_state)

    config = nt.SimConfig(**cfg)
    ss = prime_accelerations_sharded(shard_state(_state(state), mesh),
                                     config, mesh)
    step = make_sharded_step(config, mesh)
    for _ in range(n_before):
        ss = step(ss)
    written = save_checkpoint(path, ss, config)
    ref = ss
    for _ in range(n_after):
        ref = step(ref)
    rs, cfg2 = load_checkpoint_sharded(written, mesh)
    step2 = make_sharded_step(cfg2, mesh)
    out = rs
    for _ in range(n_after):
        out = step2(out)
    return {"ref": _whole(ref), "out": _whole(out), "path": written,
            "n": cfg2.n}


@case
def resume_other_mesh(mesh, axis, path, n_steps=1):
    """Load a checkpoint written on another mesh and step it."""
    from nbodysim_tpu_torch.io import load_checkpoint_sharded
    from nbodysim_tpu_torch.parallel import make_sharded_step

    ss, config = load_checkpoint_sharded(path, mesh)
    step = make_sharded_step(config, mesh)
    for _ in range(n_steps):
        ss = step(ss)
    return _whole(ss)


@case
def collision_work(mesh, axis, state, cfg):
    """`collision_deltas` with this rank's work counts."""
    from nbodysim_tpu_torch.parallel.collisions import (
        sharded_collision_deltas)

    dp, dv = collision_deltas(mesh, axis, state, cfg)
    return {"dp": dp, "dv": dv,
            "work": dict(sharded_collision_deltas.work)}


@case
def single_collision(mesh, axis, state, cfg):
    """A reference: one single-device collision pass, its deltas."""
    from nbodysim_tpu_torch.physics.collisions import resolve_collisions

    st = _state(state)
    out = resolve_collisions(st, nt.SimConfig(**cfg))
    return (out.pos - st.pos).numpy(), (out.vel - st.vel).numpy()


class _TileCaps:
    """Overrides of the 3D tiles' caps that change results, in this
    process: the least halo-source cap (`_HALO_MIN`) and the scatter's
    compaction capacity (`_scatter_cap3`, a fixed row count)."""

    def __init__(self, halo_min=None, scatter_cap=None):
        self.halo_min, self.scatter_cap = halo_min, scatter_cap

    def __enter__(self):
        from nbodysim_tpu_torch.parallel import tree3d
        from nbodysim_tpu_torch.physics import barneshut as tb
        from nbodysim_tpu_torch.physics import barneshut3d as tb3

        self.saved = (tb._HALO_MIN, tb3._scatter_cap3, tree3d._scatter_cap3)
        if self.halo_min is not None:
            tb._HALO_MIN = self.halo_min
        if self.scatter_cap is not None:
            cap = self.scatter_cap
            tb3._scatter_cap3 = tree3d._scatter_cap3 = lambda n: min(n, cap)

    def __exit__(self, *exc):
        from nbodysim_tpu_torch.parallel import tree3d
        from nbodysim_tpu_torch.physics import barneshut as tb
        from nbodysim_tpu_torch.physics import barneshut3d as tb3

        tb._HALO_MIN, tb3._scatter_cap3, tree3d._scatter_cap3 = self.saved


@case
def single_tree(mesh, axis, pos, mass, cfg, halo_min=None, scatter_cap=None):
    """A reference: the single-device tree (`bh_accelerations`), with the
    tiles' caps overridden (`_TileCaps`)."""
    from nbodysim_tpu_torch.physics.barneshut import bh_accelerations

    with _TileCaps(halo_min, scatter_cap):
        return bh_accelerations(torch.from_numpy(pos), torch.from_numpy(mass),
                                nt.SimConfig(**cfg)).numpy()


# ---------------------------------------------------------------------------
# The banded tree
# ---------------------------------------------------------------------------

@case
def banded(mesh, axis, pos, mass, cfg, slack=None, check_k3=False,
           spy_conv=False):
    """Banded tree accelerations of a whole (pos, mass), whole, with this
    rank's work counts. slack overrides `_BAND_SLACK`; check_k3 routes the
    near field through the K3 wrapper (its plain version on the CPU) and
    checks the window grid's counts contract on every call; spy_conv
    records cuDNN's TF32 flag at every M2L convolution."""
    from nbodysim_tpu_torch.parallel import tree
    from nbodysim_tpu_torch.physics import barneshut as tb

    config = nt.SimConfig(**cfg)
    saved = (tree._BAND_SLACK, tree.bucket_stencil, tb.F.conv2d,
             torch.backends.cudnn.allow_tf32)
    report = {"k3_calls": 0, "k3_bad": 0, "tf32": []}

    def k3(bx, by, bm, *, counts, rr, eps_sq, center_rows):
        report["k3_calls"] += 1
        occ = torch.arange(bx.shape[-1]) < counts[..., None].long()
        # Slots at or above a count empty; the in-window slots below it.
        if bool((bx[~occ] != 0).any() or (by[~occ] != 0).any()
                or (bm[~occ] != 0).any()):
            report["k3_bad"] += 1
        if tuple(counts.shape) != tuple(bx.shape[:-1]) or \
                bx.shape[0] != center_rows + 2 * rr:
            report["k3_bad"] += 1
        return saved[1](bx, by, bm, counts=counts, rr=rr, eps_sq=eps_sq,
                        center_rows=center_rows)

    def conv2d(*a, **kw):
        report["tf32"].append(torch.backends.cudnn.allow_tf32)
        return saved[2](*a, **kw)

    try:
        if slack is not None:
            tree._BAND_SLACK = slack
        if check_k3:
            tree.bucket_stencil = k3
        if spy_conv:
            tb.F.conv2d = conv2d
            torch.backends.cudnn.allow_tf32 = True
        acc = tree.banded_tree_accelerations(
            _local(pos, axis), _local(mass, axis), config, axis,
            use_kernels=True if check_k3 else None)
        report["tf32_after"] = torch.backends.cudnn.allow_tf32
    finally:
        (tree._BAND_SLACK, tree.bucket_stencil, tb.F.conv2d,
         torch.backends.cudnn.allow_tf32) = saved
    return {"acc": comm.all_gather(acc, axis).numpy(),
            "work": dict(tree.banded_tree_accelerations.work),
            "report": report}


@case
def banded3(mesh, axis, pos, mass, cfg, slack=None, check_k7=False,
            spy_conv=False, halo_min=None, scatter_cap=None):
    """The octree's multi-device dispatch on a whole (pos, mass), whole,
    with this rank's work counts. slack overrides `_BAND_SLACK`; check_k7
    routes the near field through the K7 wrapper (its plain version on the
    CPU) and checks the window grid's counts contract on every call;
    spy_conv records cuDNN's TF32 flag at every M2L convolution; halo_min
    and scatter_cap override the tiles' caps (`_TileCaps`)."""
    from nbodysim_tpu_torch.parallel import tree, tree3d
    from nbodysim_tpu_torch.physics import barneshut3d as tb3

    config = nt.SimConfig(**cfg)
    saved = (tree._BAND_SLACK, tree3d.bucket_stencil3, tb3.F.conv3d,
             torch.backends.cudnn.allow_tf32)
    report = {"k7_calls": 0, "k7_bad": 0, "tf32": []}

    def k7(bx, by, bz, bm, *, counts, rr, eps_sq, center_rows):
        report["k7_calls"] += 1
        occ = torch.arange(bx.shape[-1]) < counts[..., None].long()
        # Slots at or above a count empty; the in-window slots below it.
        if any(bool((a[~occ] != 0).any()) for a in (bx, by, bz, bm)):
            report["k7_bad"] += 1
        if tuple(counts.shape) != tuple(bx.shape[:-1]) or \
                bx.shape[0] != center_rows + 2 * rr:
            report["k7_bad"] += 1
        return saved[1](bx, by, bz, bm, counts=counts, rr=rr, eps_sq=eps_sq,
                        center_rows=center_rows)

    def conv3d(*a, **kw):
        report["tf32"].append(torch.backends.cudnn.allow_tf32)
        return saved[2](*a, **kw)

    try:
        if slack is not None:
            tree._BAND_SLACK = slack
        if check_k7:
            tree3d.bucket_stencil3 = k7
        if spy_conv:
            tb3.F.conv3d = conv3d
            torch.backends.cudnn.allow_tf32 = True
        with _TileCaps(halo_min, scatter_cap):
            acc = tree3d.banded_tree3_accelerations(
                _local(pos, axis), _local(mass, axis), config, axis,
                use_kernels=True if check_k7 else None)
        report["tf32_after"] = torch.backends.cudnn.allow_tf32
    finally:
        (tree._BAND_SLACK, tree3d.bucket_stencil3, tb3.F.conv3d,
         torch.backends.cudnn.allow_tf32) = saved
    return {"acc": comm.all_gather(acc, axis).numpy(),
            "work": dict(tree3d.banded_tree3_accelerations.work),
            "report": report}
