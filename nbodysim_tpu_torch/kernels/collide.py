"""K2: dense all-pairs collision narrow phase — CUDA kernel, wrapper, plain
version.

Replaces the TPU kernel `nbodysim_tpu/kernels/collide.py:_collide_kernel`
(wrapper `allpairs_collision_deltas`). The kernel is `csrc/collide.cu`; its
header says what bounds it on the H100 and how its design answers that.

  * `allpairs_collision_deltas` — the wrapper: Jacobi (dpos, dvel) for every
    particle. On a CUDA tensor it launches the kernel (or raises); on a CPU
    tensor, and only there, it runs the plain version.
    `allpairs_collision_deltas.launches` counts kernel launches.
  * `collision_deltas_plain` — the same function in plain torch, blocked,
    built on `_pair_deltas` (the port of `physics/collisions._pair_deltas`).

The TPU wrapper sorted particles by a coarse cell key so that its per-tile
skip fired; the CUDA kernel branches per pair and takes particles in the
order given.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nbodysim_tpu_torch.core.blocking import pairwise_blocked


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_c a[..., c] * b[..., c], in column order with each product and sum
    rounded (the order the CUDA kernel uses, so branch decisions agree)."""
    s = a[..., 0] * b[..., 0]
    for c in range(1, a.shape[-1]):
        s = s + a[..., c] * b[..., c]
    return s


def _pair_deltas(
    d: torch.Tensor,        # [..., D]  x_j - x_i
    v: torch.Tensor,        # [..., D]  v_j - v_i
    w1: torch.Tensor,       # [...]     m_j / (m_i + m_j)
    r: torch.Tensor,        # [...]     r_i + r_j
    valid: torch.Tensor,    # [...]     candidate mask
    impulse: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-candidate (dpos_i, dvel_i) for particle i; masked, NaN-safe."""
    d_sq = _dot(d, d)
    r_sq = r * r
    overlap = (d_sq <= r_sq) & valid

    d_dot_v = _dot(d, v)
    v_sq = _dot(v, v)

    separating = overlap & (d_dot_v >= 0.0) & (d_sq > 0.0)
    approaching = overlap & (d_dot_v < 0.0)

    # --- separating: positional de-penetration --------------------------
    safe_dist = torch.sqrt(torch.where(d_sq > 0.0, d_sq, 1.0))
    tmp_sep = d * (r / safe_dist - 1.0)[..., None]
    dpos_sep = -tmp_sep * w1[..., None]

    # --- approaching: TOI rewind + impulse ------------------------------
    safe_v_sq = torch.where(v_sq > 0.0, v_sq, 1.0)
    disc = torch.clamp_min(d_dot_v * d_dot_v - v_sq * (d_sq - r_sq), 0.0)
    t = (d_dot_v + torch.sqrt(disc)) / safe_v_sq
    d_new = d - v * t[..., None]
    d_new_sq = _dot(d_new, d_new)
    safe_d_new_sq = torch.where(d_new_sq > 0.0, d_new_sq, 1.0)
    scale = impulse * _dot(d_new, v) / safe_d_new_sq
    dvel_imp = d_new * scale[..., None] * w1[..., None]
    dpos_imp = dvel_imp * t[..., None]

    dpos = torch.where(
        separating[..., None], dpos_sep,
        torch.where(approaching[..., None], dpos_imp, 0.0))
    dvel = torch.where(approaching[..., None], dvel_imp, 0.0)
    return dpos, dvel


def collision_deltas_plain(
    pos: torch.Tensor,
    vel: torch.Tensor,
    mass: torch.Tensor,
    radius: torch.Tensor,
    *,
    impulse: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch Jacobi deltas (dpos, dvel), [N, D] each; temps bounded at
    [1024, 4096, D]. Self pairs are no-ops in the pair math (d = v = 0)."""

    def kernel(tgt, src):
        tp, tv, tm, tr = tgt
        sp, sv, sm, sr = src
        d = sp[None, :, :] - tp[:, None, :]
        v = sv[None, :, :] - tv[:, None, :]
        msum = tm[:, None] + sm[None, :]
        w1 = sm[None, :] / torch.where(msum > 0.0, msum, 1.0)
        r = tr[:, None] + sr[None, :]
        valid = (sm > 0.0)[None, :]   # zero-mass sources are inert
        dpos, dvel = _pair_deltas(d, v, w1, r, valid, impulse)
        return dpos.sum(1), dvel.sum(1)

    fields = (pos, vel, mass, radius)
    dim = pos.shape[1]
    return pairwise_blocked(kernel, fields, fields,
                            out_dims=((dim,), (dim,)), dtype=pos.dtype)


def allpairs_collision_deltas(
    pos: torch.Tensor,
    vel: torch.Tensor,
    mass: torch.Tensor,
    radius: torch.Tensor,
    *,
    impulse: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Jacobi collision deltas (dpos, dvel) on all particles, [N, D] f32."""
    if pos.device.type == "cpu":
        return collision_deltas_plain(pos, vel, mass, radius, impulse=impulse)
    if pos.device.type != "cuda":
        raise ValueError(f"no K2 kernel for device {pos.device}")
    from nbodysim_tpu_torch.kernels._build import check, f32_args, library

    device = pos.device
    p, v, m, r = f32_args(device, pos, vel, mass, radius)
    n, dim = p.shape
    if dim not in (2, 3) or v.shape != (n, dim) or m.shape != (n,) \
            or r.shape != (n,):
        raise ValueError(
            f"shapes {tuple(p.shape)}, {tuple(v.shape)}, {tuple(m.shape)}, "
            f"{tuple(r.shape)}: expected [N, D], [N, D], [N], [N], D in 2, 3")
    if n * dim >= 2 ** 31:
        raise ValueError("K2 indexes with 32-bit ints: N * D must be < 2^31")
    if n == 0:
        return torch.zeros_like(p), torch.zeros_like(p)
    dpos = torch.empty_like(p)
    dvel = torch.empty_like(p)
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.nb_collision_deltas(
            p.data_ptr(), v.data_ptr(), m.data_ptr(), r.data_ptr(),
            dpos.data_ptr(), dvel.data_ptr(), n, dim, float(impulse), stream)
    check(status, "nb_collision_deltas")
    allpairs_collision_deltas.launches += 1
    return dpos, dvel


allpairs_collision_deltas.launches = 0
