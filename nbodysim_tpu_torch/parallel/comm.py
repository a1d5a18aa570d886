"""The collectives of the multi-device step: the only module that moves
data between ranks with `torch.distributed`, and `spawn`, which starts a
local run of P ranks.

The JAX package's multi-chip code runs inside one `shard_map` and names its
collectives by mesh axis (`lax.all_gather`, `lax.ppermute`, `lax.psum`,
`lax.axis_index`). Here each device is a process; an `Axis` (the process
group of a 1-D `DeviceMesh`, its size and this process's index on it) takes
the place of the axis name, and the functions below take the place of the
`lax` collectives, with the same semantics:

  * `all_gather(x, axis)`  — tiled: the shards concatenated along dim 0;
  * `ppermute(x, axis, perm)` — perm is a list of (source, destination)
    pairs; a process that receives nothing gets zeros, as JAX's edges do;
    sends and receives go out as one `batch_isend_irecv` of matched pairs,
    so the ring and the halos cannot deadlock. `ppermute_start` returns a
    handle whose `wait()` gives the result, so a caller can compute while
    the transfer runs (the ring does);
  * `psum(x, axis)` — `all_reduce(SUM)`.

Gloo carries point-to-point transfers of host memory only, so with a gloo
group a CUDA tensor's transfer is staged through host memory and back (the
compute stays on the card); `HOST_STAGED` names every collective that was,
and for the others gloo's own CUDA path is tried first and its refusal
(a RuntimeError raised before any data moves) sends that collective through
host memory from then on.

`spawn(fn, world_size, args)` runs fn(rank, *args) in `world_size` fresh
processes joined into one process group (gloo by default; any backend
`init_process_group` takes), waits for all of them, and returns their
results in rank order; a failure in any rank raises here. Multi-host runs
start their ranks with `torchrun` instead, and `sharded.make_mesh` joins
them.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from typing import Any, Callable, List, NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist

# Collectives that went through host memory in this process (gloo + CUDA).
HOST_STAGED: set = set()


class Axis(NamedTuple):
    """One mesh axis as the collectives see it."""
    group: object           # torch.distributed ProcessGroup
    size: int
    index: int


def mesh_axis(mesh, axis_name: str) -> Axis:
    """The Axis of `mesh` named `axis_name` for this process."""
    group = mesh.get_group(axis_name)
    return Axis(group, dist.get_world_size(group), dist.get_rank(group))


def axis_size(axis: Axis) -> int:
    return axis.size


def axis_index(axis: Axis) -> int:
    return axis.index


def _staged(kind: str, x: torch.Tensor, group) -> bool:
    """Whether collective `kind` on `x` goes through host memory."""
    if x.device.type == "cpu" or dist.get_backend(group) != "gloo":
        return False
    if kind == "send/recv":
        HOST_STAGED.add(kind)
        return True
    return kind in HOST_STAGED


def _gloo_or_host(kind: str, x: torch.Tensor, group, op):
    """op(x) on x's device; through host memory where gloo refuses it."""
    if not _staged(kind, x, group):
        try:
            return op(x)
        except RuntimeError:
            if x.device.type == "cpu" or dist.get_backend(group) != "gloo":
                raise
            HOST_STAGED.add(kind)
    return op(x.cpu()).to(x.device)


def all_gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Tiled all-gather along dim 0 (`lax.all_gather(..., tiled=True)`)."""
    def op(t):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(axis.size)]
        dist.all_gather(parts, t, group=axis.group)
        return torch.cat(parts, 0)

    return _gloo_or_host("all_gather", x, axis.group, op)


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum over the axis (`lax.psum`)."""
    def op(t):
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=axis.group)
        return t

    return _gloo_or_host("all_reduce", x, axis.group, op)


class _Pending:
    """An issued ppermute: `wait()` returns the received tensor."""

    def __init__(self, works, buf: torch.Tensor, device, sent=None):
        # `sent` keeps the outgoing buffer alive until the transfer ends.
        self._works, self._buf, self._device = works, buf, device
        self._sent = sent

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        return self._buf.to(self._device)


def ppermute_start(x: torch.Tensor, axis: Axis,
                   perm: Sequence[Tuple[int, int]]) -> _Pending:
    """Issue `lax.ppermute(x, perm)` along the axis and return its handle."""
    me = axis.index
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"perm {perm} sends or receives twice at {me}")
    device = x.device
    if src and src[0] == me:           # a self edge moves nothing
        return _Pending([], x.clone(), device)
    host = _staged("send/recv", x, axis.group)
    payload = (x.cpu() if host else x).contiguous()
    buf = torch.zeros_like(payload)
    ops: List[dist.P2POp] = []
    if dst:
        ops.append(dist.P2POp(dist.isend, payload,
                              dist.get_global_rank(axis.group, dst[0]),
                              axis.group))
    if src:
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(axis.group, src[0]),
                              axis.group))
    works = dist.batch_isend_irecv(ops) if ops else []
    return _Pending(works, buf, device, payload)


def ppermute(x: torch.Tensor, axis: Axis,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """`lax.ppermute(x, perm)`: zeros where nothing is received."""
    return ppermute_start(x, axis, perm).wait()


def _spawned(rank: int, fn: Callable, world_size: int, backend: str,
             workdir: str, timeout_s: float, threads: int, args) -> None:
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(workdir, "group"),
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn: Callable, world_size: int, args: Sequence = (), *,
          backend: str = "gloo", timeout_s: float = 60.0,
          threads: int = 1, workdir: str | None = None) -> List[Any]:
    """Run fn(rank, *args) in `world_size` new processes (the "spawn"
    start method) joined into one process group of `backend` with a
    `timeout_s` collective timeout and `threads` torch threads each;
    returns the ranks' results in rank order. The group meets at a file
    (`init_method="file://..."`, no TCP port) and the results are pickled,
    both in a fresh directory inside `workdir` (default: the system's
    temporary directory). fn must be importable by module and name. Any
    rank's failure raises in the caller, after every rank has ended."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(dir=workdir) as scratch:
        mp.spawn(_spawned, args=(fn, world_size, backend, scratch,
                                 timeout_s, threads, tuple(args)),
                 nprocs=world_size, join=True)
        out = []
        for rank in range(world_size):
            with open(os.path.join(scratch, f"result_{rank}.pkl"),
                      "rb") as f:
                out.append(pickle.load(f))
    return out
