"""Checkpoint / resume (port of `nbodysim_tpu.io.checkpoint`).

One format for both packages: the particle SoA and the config as a single
.npz with the JAX package's keys and format version. The config JSON names
the backends as the JAX package does ("pallas" for the port's "cuda",
"xla" for "torch"), so the JAX package's `load_checkpoint` accepts a
checkpoint the port wrote; loading maps them back and drops the fields
the port lacks (`pallas_interpret`). Resume is bitwise-deterministic where
the step is (tests/test_torch_checkpoint_cli.py).

Checkpoints do not depend on a mesh: `save_checkpoint` of a rank's
`parallel.sharded.ShardedState` gathers the whole state and rank 0 writes
it, and `load_checkpoint_sharded` places a file onto any mesh whose size
divides N (tests/test_torch_sharding.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.core.state import ParticleState, resolve_device

_FORMAT_VERSION = 1

# The port's backend names -> the JAX package's, as the file holds them.
_BACKEND_TO_FILE = {"cuda": "pallas", "torch": "xla"}
_BACKEND_FROM_FILE = {v: k for k, v in _BACKEND_TO_FILE.items()}
_BACKEND_FIELDS = ("force_backend", "collision_backend")
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


def save_checkpoint(path: str, state: ParticleState,
                    config: Optional[SimConfig] = None) -> str:
    """Write state (+ config) to a .npz checkpoint; returns the real path
    (np.savez appends '.npz' when missing, so the suffix is normalized).
    A sharded state is gathered, and written once, by rank 0; every rank
    of its mesh must call this."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    mesh = getattr(state, "mesh", None)
    if mesh is not None:
        # A rank's shard: every rank takes part in the gather, rank 0
        # writes, and the others return once the file is complete.
        import torch.distributed as dist

        from nbodysim_tpu_torch.parallel.sharded import gather_state

        whole = gather_state(state)
        if dist.get_rank() == 0:
            save_checkpoint(path, whole, config)
        dist.barrier(group=mesh.get_group(state.axis_name))
        return path
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"version": np.int32(_FORMAT_VERSION), **state.to_numpy()}
    if config is not None:
        cfg = dataclasses.asdict(config)
        cfg["dtype"] = str(config.dtype).removeprefix("torch.")
        for field in _BACKEND_FIELDS:
            cfg[field] = _BACKEND_TO_FILE.get(cfg[field], cfg[field])
        payload["config_json"] = np.frombuffer(
            json.dumps(cfg).encode(), dtype=np.uint8)
    np.savez(path, **payload)
    return path


def load_checkpoint(
    path: str, device="cuda",
) -> Tuple[ParticleState, Optional[SimConfig]]:
    """Read a checkpoint (written by either package) onto `device`, the
    card unless the caller asks for another; returns (state,
    config-or-None)."""
    device = resolve_device(device)
    with np.load(path) as z:
        version = int(z["version"])
        if version > _FORMAT_VERSION:
            raise ValueError(f"checkpoint version {version} is newer than "
                             f"supported {_FORMAT_VERSION}")
        state = ParticleState.from_numpy(
            {k: z[k] for k in ("pos", "vel", "acc", "mass", "radius",
                               "frame")}, device)
        config = None
        if "config_json" in z:
            cfg = json.loads(bytes(z["config_json"]).decode())
            cfg["dtype"] = _DTYPES[cfg["dtype"]]
            for field in _BACKEND_FIELDS:
                if field in cfg:
                    cfg[field] = _BACKEND_FROM_FILE.get(cfg[field],
                                                        cfg[field])
            # Same-version schema drift, as the JAX loader tolerates it:
            # fields this build lacks are dropped, missing ones default.
            names = {f.name for f in dataclasses.fields(SimConfig)}
            config = SimConfig(**{k: v for k, v in cfg.items()
                                  if k in names})
    return state, config


def load_checkpoint_sharded(path: str, mesh, axis_name: str = "shards"):
    """Load a checkpoint onto `mesh`: every rank reads the file and keeps
    its shard (`parallel.sharded.shard_state`), on its device of the mesh.
    Same-mesh resume is bit for bit the uninterrupted run; another mesh
    size resumes to the collectives' roundoff. Returns (state, config)."""
    from nbodysim_tpu_torch.parallel.sharded import mesh_device, shard_state

    state, config = load_checkpoint(path, device=mesh_device(mesh))
    return shard_state(state, mesh, axis_name), config
