"""Build and load the port's CUDA kernels.

Every `nbodysim_tpu_torch/csrc/*.cu` file (with the `*.cuh` headers it
includes) exports plain C functions that take
device pointers, sizes, scalars and a stream, and return `cudaGetLastError()`.
At first use each source is compiled by its own `nvcc` for Hopper (`sm_90a`),
all of them at once, and the objects are linked into one shared library under
`build/` at the repository root, cached by a hash of the sources and flags,
and loaded with `ctypes`. Only the sources in this checkout are built;
nothing is fetched.

`--use_fast_math` is deliberately absent: the collision kernel divides and
takes `sqrtf` in its time-of-impact math, which must stay IEEE-rounded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_vp = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
_ll = ctypes.c_longlong
# Every pointer and the stream are c_void_p: left undeclared, ctypes would
# pass them as 32-bit ints and cut the address.
SIGNATURES = {
    # tgt, src, src_mass, out, scratch, n, s, dim, splits, k, eps_sq, g,
    # stream
    "nb_allpairs_accelerations": (_vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i,
                                  _i, _f, _f, _vp),
    # pos, mass, partial (f64), out, n, dim, splits, k, eps_sq, stream
    "nb_allpairs_potential": (_vp, _vp, _vp, _vp, _i, _i, _i, _i, _f, _vp),
    # pos, vel, mass, radius, out, n, row0, n_rows, dim, impulse, stream
    "nb_collision_deltas": (_vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _f,
                            _vp),
    # tpos, tvel, tmass, trad, tcell, spos, svel, smass, srad, scell, out,
    # scratch, n, s, dim, splits, max_cheb, impulse, stream
    "nb_rect_pair_deltas": (_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                            _vp, _vp, _vp, _i, _i, _i, _i, _i, _f, _vp),
    # planes, keys, w_lo, w_hi, dpos, dvel, n_tot, dim, t_blk, row0, n_loc,
    # impulse, stream
    "nb_block_collide": (_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i,
                         _f, _vp),
    # the same and counts[7] (uint64) before the stream
    "nb_block_collide_count": (_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i,
                               _i, _f, _vp, _vp),
    # bx, by, bm, counts, ax, ay, center_rows, res, cap, rr, eps_sq, stream
    "nb_bucket_stencil": (_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _f,
                          _vp),
    # bx, by, bz, bm, counts, ax, ay, az, center_rows, res, cap, rr, eps_sq,
    # stream
    "nb_bucket_stencil3": (_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i,
                           _i, _i, _f, _vp),
    # dim, shape[3] (host memory)
    "nb_nearfield_tile": (_i, _vp),
    # g, its strides (batch, x, y, z, channel), batch, X, x0, r, row0, rows,
    # corner, size, eps_sq, radius, wtab, out, stream
    "nb_m2l3": (_vp, _ll, _ll, _ll, _ll, _ll, _i, _i, _i, _i, _i, _i, _vp,
                _vp, _f, _i, _vp, _vp, _vp),
    # radius
    "nb_m2l3_table_floats": (_i,),
    # g, its strides (batch, x, y, channel), batch, X, x0, r, row0, rows,
    # corner, size, eps_sq, radius, out, stream
    "nb_m2l2": (_vp, _ll, _ll, _ll, _ll, _i, _i, _i, _i, _i, _i, _vp, _vp,
                _f, _i, _vp, _vp),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin); the CUDA "
        "kernels of nbodysim_tpu_torch are built from source at first use")


def build() -> Path:
    """Compile the kernels if no library for the current sources exists;
    returns the library's path. Raises with nvcc's output on failure."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for arg in NVCC_FLAGS:
        digest.update(arg.encode())
    for src in sorted(CSRC.glob("*.cu*")):   # the headers (.cuh) too
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib = BUILD_DIR / f"libnbodysim_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sources:
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            with open(obj.with_suffix(".log"), "w") as out:
                jobs.append((cmd, obj, subprocess.Popen(
                    cmd, stdout=out, stderr=subprocess.STDOUT)))
        # Every compile is waited for, failed or not.
        codes = [proc.wait() for _, _, proc in jobs]
        logs = [f"{' '.join(cmd)}\n{obj.with_suffix('.log').read_text()}"
                for cmd, obj, _ in jobs]
        failed = [log for log, code in zip(logs, codes) if code != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        so = Path(tmp) / "lib.so"
        link = [nvcc, *GENCODE, "-shared", "-o", str(so),
                *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(link)}\n"
                f"{proc.stdout}{proc.stderr}")
        lib.with_suffix(".log").write_text(
            "".join(logs) + f"{' '.join(link)}\n"
            f"seconds {time.perf_counter() - t0:.3f}\n")
        os.replace(so, lib)  # atomic: concurrent builders never see a partial
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.nb_error_string.argtypes = (ctypes.c_int,)
    lib.nb_error_string.restype = ctypes.c_char_p
    return lib


def f32_args(device: torch.device, *tensors: torch.Tensor):
    """The kernels' operands: each tensor on `device`, f32 and contiguous
    (the kernels index row-major [N, D] f32). Raises on another device."""
    for t in tensors:
        if t.device != device:
            raise ValueError(f"tensor on {t.device}, expected {device}")
    return [t.to(torch.float32).contiguous() for t in tensors]


def check(status: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        text = library().nb_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({text}) at launch")
