"""Multi-device execution: the particle axis sharded over a 1-D mesh (port of
`nbodysim_tpu.parallel.sharded`).

One process per device, joined by `torch.distributed`: each rank holds its
shard of the particle arrays, rows [r * N/P, (r + 1) * N/P), as plain local
tensors, and the step spells out every collective (`parallel/comm.py`), as
the JAX package's `shard_map` body does:

  * forces: the exact path is a ring (`ring_accelerations`): P hops of K1
    with the local shard as targets and a rotating source shard, the next
    shard's transfer issued before the current hop's kernel; the tree code
    runs banded by grid rows (`parallel/tree.py`), or replicated
    (`replicated_tree_accelerations`) where the grid cannot band;
  * collisions: below the dense threshold every rank all-gathers the
    particle arrays and resolves its own rows against all of them with K2's
    row-range form (`parallel/collisions.py`).

The reference step order (kick, clamp, boundary, drift, collide) holds per
shard. At P = 1 every collective is a copy, and the step is the single-device
step bit for bit.

Entry points take a mesh from `make_mesh`, which runs on the card (NCCL)
unless the caller asks for the CPU (gloo). A rank's state is a
`ShardedState`: a `ParticleState` of its local rows that also carries its
mesh, so `io.checkpoint.save_checkpoint` can gather it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.core.state import ParticleState
from nbodysim_tpu_torch.parallel import comm
from nbodysim_tpu_torch.physics.integrators import (
    apply_soft_boundary,
    clamp_velocity,
)


@dataclasses.dataclass(frozen=True)
class ShardedState(ParticleState):
    """One rank's shard of a ParticleState (its rows of every per-particle
    field, the frame replicated) and the mesh it is sharded over."""

    mesh: Any = None
    axis_name: str = "shards"


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "shards",
              device_type: str = "cuda"):
    """1-D `DeviceMesh` named `axis_name` over the particle axis, one rank
    per device: on the card unless `device_type="cpu"`.

    Without a process group, it starts one from the environment
    (`torchrun`'s RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) over NCCL
    (gloo for the CPU). With one, it uses it as it is, whatever its
    backend. The mesh spans every rank; the card is required for
    "cuda" and its absence raises."""
    from torch.distributed.device_mesh import init_device_mesh

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: device_type 'cuda' requested but "
            "torch.cuda.is_available() is False; pass device_type='cpu'")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(
            f"requested {n_devices} devices, only {world} available")
    if n_devices != world:
        raise ValueError(
            f"the mesh spans every rank of the process group: requested "
            f"{n_devices} of {world}; start {n_devices} ranks instead")
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device_type, (n_devices,),
                            mesh_dim_names=(axis_name,))


def mesh_device(mesh) -> torch.device:
    """This rank's device on `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_state(state: ParticleState, mesh,
                axis_name: str = "shards") -> ShardedState:
    """This rank's shard of a state every rank holds whole: rows
    [r * N/P, (r + 1) * N/P) of each per-particle field on the rank's
    device, the frame replicated."""
    ax = comm.mesh_axis(mesh, axis_name)
    if state.n % ax.size != 0:
        raise ValueError(
            f"particle count {state.n} must divide the mesh size {ax.size}; "
            f"pad the scene or choose n as a multiple of the device count")
    n_l = state.n // ax.size
    rows = slice(ax.index * n_l, (ax.index + 1) * n_l)
    device = mesh_device(mesh)

    def local(name):
        return getattr(state, name)[rows].to(device).contiguous()

    return ShardedState(
        pos=local("pos"), vel=local("vel"), acc=local("acc"),
        mass=local("mass"), radius=local("radius"),
        frame=state.frame.to(device).clone(), mesh=mesh, axis_name=axis_name)


def gather_state(state: ShardedState) -> ParticleState:
    """The whole state, on every rank (each field all-gathered)."""
    ax = comm.mesh_axis(state.mesh, state.axis_name)
    return ParticleState(
        **{f: comm.all_gather(getattr(state, f), ax)
           for f in ("pos", "vel", "acc", "mass", "radius")},
        frame=state.frame)


def _local_acc_fn(config: SimConfig, device) -> Callable:
    """Accelerations on targets from separate sources, per ring hop: K1
    where the exact backend resolves to "cuda" on `device`, its plain
    version otherwise (an explicit "bh" reaching the ring included)."""
    from nbodysim_tpu_torch.physics.forces import resolve_backend

    # n = 0: the exact path's choice for this device, whatever N is.
    if resolve_backend(config, 0, 2, device) == "cuda":
        from nbodysim_tpu_torch.kernels.allpairs import (
            allpairs_accelerations)

        def acc(tgt_pos, src_pos, src_mass):
            return allpairs_accelerations(
                tgt_pos, None, eps_sq=config.eps_sq, g_const=config.g_const,
                src_pos=src_pos, src_mass=src_mass)
    else:
        from nbodysim_tpu_torch.physics.forces import direct_accelerations

        def acc(tgt_pos, src_pos, src_mass):
            return direct_accelerations(
                tgt_pos, None, eps_sq=config.eps_sq, g_const=config.g_const,
                src_pos=src_pos, src_mass=src_mass)
    return acc


def replicated_tree_accelerations(pos_l, mass_l, config: SimConfig,
                                  axis: comm.Axis) -> torch.Tensor:
    """The tree code replicated: all-gather the particles, evaluate the
    whole tree on every rank, keep the local rows. Correct at any mesh
    size; not compute-scaled."""
    from nbodysim_tpu_torch.physics.barneshut import bh_accelerations

    pos_g = comm.all_gather(pos_l, axis)
    mass_g = comm.all_gather(mass_l, axis)
    acc_g = bh_accelerations(pos_g, mass_g, config)
    n_l = pos_l.shape[0]
    return acc_g[axis.index * n_l:(axis.index + 1) * n_l]


def sharded_accelerations(pos_l, mass_l, config: SimConfig,
                          axis: comm.Axis) -> torch.Tensor:
    """Force dispatch inside the sharded step: the exact backends go
    through the ring; the tree code through the banded FMM (2D) or the
    octree's dispatch (3D)."""
    from nbodysim_tpu_torch.physics.forces import resolve_backend

    n_global = pos_l.shape[0] * axis.size
    if resolve_backend(config, n_global, pos_l.shape[1],
                       pos_l.device) == "bh":
        if pos_l.shape[1] == 3:
            from nbodysim_tpu_torch.parallel.tree3d import (
                banded_tree3_accelerations)

            return banded_tree3_accelerations(pos_l, mass_l, config, axis)
        from nbodysim_tpu_torch.parallel.tree import (
            banded_tree_accelerations)

        return banded_tree_accelerations(pos_l, mass_l, config, axis)
    return ring_accelerations(pos_l, mass_l, config, axis)


def ring_accelerations(pos_l, mass_l, config: SimConfig,
                       axis: comm.Axis) -> torch.Tensor:
    """Accelerations on the local targets from all N sources by a P-hop
    source ring: hop 0 takes the local shard; each later hop the shard
    received from the previous rank, whose transfer was issued before the
    last hop's kernel. Sources travel as one [N/P, D + 1] block."""
    p = axis.size
    perm = [(i, (i + 1) % p) for i in range(p)]
    acc_fn = _local_acc_fn(config, pos_l.device)
    dim = pos_l.shape[1]
    src = torch.cat([pos_l, mass_l[:, None]], 1)
    acc = torch.zeros_like(pos_l)
    for hop in range(p):
        nxt = comm.ppermute_start(src, axis, perm) if hop + 1 < p else None
        acc = acc + acc_fn(pos_l, src[:, :dim], src[:, dim])
        if nxt is not None:
            src = nxt.wait()
    return acc


def prime_accelerations_sharded(state: ShardedState, config: SimConfig,
                                mesh=None,
                                axis_name: Optional[str] = None
                                ) -> ShardedState:
    """Fill state.acc with a(t0) through the sharded force path: needed
    before the first sharded leapfrog step (a sharded state built from a
    scene carries zeros)."""
    mesh = state.mesh if mesh is None else mesh
    ax = comm.mesh_axis(mesh, axis_name or config.mesh_axis)
    return state.replace(
        acc=sharded_accelerations(state.pos, state.mass, config, ax))


def make_sharded_step(config: SimConfig, mesh,
                      axis_name: Optional[str] = None
                      ) -> Callable[[ShardedState], ShardedState]:
    """The multi-device step (forces, integration, collisions) on a rank's
    ShardedState. Cross-shard coupling happens only in the force dispatch
    and the collision pass; leapfrog carries acc as the single-device
    integrator does."""
    axis_name = axis_name or config.mesh_axis
    ax = comm.mesh_axis(mesh, axis_name)
    # dt rounded to the config dtype, as `make_step` takes it.
    dt = float(torch.tensor(config.dt, dtype=config.dtype))

    def step(state: ShardedState) -> ShardedState:
        pos, vel, mass, radius = (state.pos, state.vel, state.mass,
                                  state.radius)
        if config.integrator == "leapfrog_kdk":
            half = 0.5 * dt
            vel_h = vel + state.acc * half
            pos_new = pos + vel_h * dt
            acc = sharded_accelerations(pos_new, mass, config, ax)
            vel_new = vel_h + acc * half
        else:
            acc = sharded_accelerations(pos, mass, config, ax)
            vel_new = vel + acc * dt
            pos_new = pos

        if config.enable_velocity_clamp:
            vel_new = clamp_velocity(vel_new, config.max_velocity)
        if config.enable_boundary:
            vel_new = apply_soft_boundary(pos_new, vel_new, dt, config)
        if config.integrator != "leapfrog_kdk":
            pos_new = pos_new + vel_new * dt

        if config.enable_collisions:
            from nbodysim_tpu_torch.parallel.collisions import (
                sharded_collision_deltas)

            for _ in range(max(1, config.collision_iterations)):
                dpos, dvel = sharded_collision_deltas(
                    pos_new, vel_new, mass, radius, config, ax)
                pos_new = pos_new + dpos
                vel_new = vel_new + dvel

        return ShardedState(
            pos=pos_new, vel=vel_new, acc=acc, mass=mass, radius=radius,
            frame=state.frame + 1, mesh=mesh, axis_name=axis_name)

    return step


def make_sharded_rollout(config: SimConfig, mesh, num_steps: int,
                         axis_name: Optional[str] = None
                         ) -> Callable[[ShardedState], ShardedState]:
    """`num_steps` sharded steps in a Python loop."""
    step = make_sharded_step(config, mesh, axis_name)

    def rollout(state: ShardedState) -> ShardedState:
        for _ in range(num_steps):
            state = step(state)
        return state

    return rollout
