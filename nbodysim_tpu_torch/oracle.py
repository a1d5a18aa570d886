"""ctypes bindings for the native C++ parity oracle (port of
`nbodysim_tpu.oracle`).

`native/oracle.cpp` is an independent scalar implementation of the
simulator's physics (exact direct-sum gravity in double, the reference step
order, the pairwise collision response): the second check the port's
physics is held to, beside the JAX package. The library is built on demand
with g++ into the gitignored `build/` at the repository root: compiled to a
temporary name and moved into place, so processes that build it at the same
time never load a partial file. The functions take tensors (or anything
numpy accepts) and return numpy arrays.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

_ROOT = Path(__file__).resolve().parent.parent
_SRC = _ROOT / "native" / "oracle.cpp"
_BUILD_DIR = _ROOT / "build" / "oracle"
_LIB = _BUILD_DIR / "liboracle.so"

_lib: Optional[ctypes.CDLL] = None


def build_oracle(force: bool = False) -> str:
    """Compile the oracle library if it is missing or older than its source;
    returns its path."""
    if force or not _LIB.exists() or (
            _LIB.stat().st_mtime < _SRC.stat().st_mtime):
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", tmp,
                            str(_SRC)], check=True, capture_output=True)
            os.replace(tmp, _LIB)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return str(_LIB)


def _get() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_oracle())
        f32p = ctypes.POINTER(ctypes.c_float)
        c_int, c_float = ctypes.c_int, ctypes.c_float
        lib.nb_direct_acc.restype = None
        lib.nb_direct_acc.argtypes = [
            f32p, f32p, c_int, c_int, c_float, c_float, f32p]
        lib.nb_potential_energy.restype = ctypes.c_double
        lib.nb_potential_energy.argtypes = [
            f32p, f32p, c_int, c_int, c_float, c_float]
        lib.nb_resolve_pair.restype = c_int
        lib.nb_resolve_pair.argtypes = [
            f32p, f32p, f32p, f32p, c_float, c_float, c_float, c_float,
            c_int, c_float]
        lib.nb_step.restype = None
        lib.nb_step.argtypes = [
            f32p, f32p, f32p, f32p, c_int, c_int] + [c_float] * 9 + [c_int]
        _lib = lib
    return _lib


def _f32(a) -> np.ndarray:
    """A C-contiguous f32 numpy copy of a tensor or array-like."""
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.array(a, dtype=np.float32, order="C")


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def oracle_accelerations(pos, mass, eps_sq: float,
                         g: float = 1.0) -> np.ndarray:
    """Exact direct-sum softened accelerations [N, D]."""
    pos, mass = _f32(pos), _f32(mass)
    n, dim = pos.shape
    out = np.zeros_like(pos)
    _get().nb_direct_acc(_ptr(pos), _ptr(mass), n, dim, eps_sq, g, _ptr(out))
    return out


def oracle_potential_energy(pos, mass, eps_sq: float,
                            g: float = 1.0) -> float:
    """Exact softened potential energy."""
    pos, mass = _f32(pos), _f32(mass)
    n, dim = pos.shape
    return float(_get().nb_potential_energy(_ptr(pos), _ptr(mass), n, dim,
                                            eps_sq, g))


def oracle_resolve_pair(
    p1, p2, v1, v2, m1, m2, r1, r2, impulse: float = 1.5
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, bool]:
    """One pair's collision response; returns (p1, p2, v1, v2, hit)."""
    p1, p2, v1, v2 = map(_f32, (p1, p2, v1, v2))
    dim = p1.shape[0]
    hit = _get().nb_resolve_pair(
        _ptr(p1), _ptr(p2), _ptr(v1), _ptr(v2),
        float(m1), float(m2), float(r1), float(r2), dim, impulse)
    return p1, p2, v1, v2, bool(hit)


def oracle_step(state, config) -> Tuple[np.ndarray, np.ndarray]:
    """One reference-semantics euler_symplectic step of a ParticleState;
    returns (pos, vel)."""
    pos, vel = _f32(state.pos), _f32(state.vel)
    mass, radius = _f32(state.mass), _f32(state.radius)
    n, dim = pos.shape
    flags = ((1 if config.enable_velocity_clamp else 0)
             | (2 if config.enable_boundary else 0)
             | (4 if config.enable_collisions else 0))
    _get().nb_step(
        _ptr(pos), _ptr(vel), _ptr(mass), _ptr(radius), n, dim,
        config.dt, config.eps_sq, config.g_const, config.max_velocity,
        config.boundary_radius, config.boundary_soft_frac,
        config.boundary_force, config.boundary_damping,
        config.collision_impulse, flags)
    return pos, vel
