"""K2 and K5: the collision narrow phase of targets against sources — CUDA
kernel, wrappers, plain versions.

Replaces the TPU kernels `nbodysim_tpu/kernels/collide.py:_collide_kernel`
(wrapper `allpairs_collision_deltas`, K2) and `_rect_kernel` (wrapper
`rect_pair_deltas`, K5). Both are one CUDA kernel, `csrc/collide.cu`,
instantiated with and without K5's masks; its header says what bounds it on
the H100 and how its design answers that.

  * `allpairs_collision_deltas` — K2's wrapper: Jacobi (dpos, dvel) for every
    particle against all of them, or, with `rows`, for a target row range
    against all of them (the multi-device step's gathered dense pass). On a
    CUDA tensor it launches the kernel (or raises); on a CPU tensor, and only
    there, it runs the plain version. `allpairs_collision_deltas.launches`
    counts kernel launches.
  * `collision_deltas_plain` — the same function in plain torch, blocked,
    built on `_pair_deltas` (the port of `physics/collisions._pair_deltas`),
    with the same `rows`.
  * `rect_pair_deltas` — K5's wrapper: target-side deltas of n targets
    against m separate sources, masked to both masses > 0 and, unless
    `max_cheb` is None, to a Chebyshev cell distance <= `max_cheb`; the exact
    big-body and overflow passes of the large-N broad phases. Its own count,
    `rect_pair_deltas.launches`.
  * `rect_pair_deltas_plain` — K5's plain version: the body of the JAX
    package's `_cheb_pair_deltas_blocked` over [2048, 2048] blocks.
  * `staged_sources` — the sources as the kernel stages them: radius NaN
    where the mass is <= 0 (such a source fails every overlap test, which
    is the plain version's mass mask), padded to whole tiles with inert
    sources; plain torch, for the tests that hold the staging exact.

The TPU wrapper of K2 sorted particles by a coarse cell key so that its
per-tile skip fired; the CUDA kernel tests a batch of sources without a
branch and resolves only the batches with a hit, in the order given. K5's
packed [N, 16] IO and its float compare of cells were TPU layouts; the
kernel takes the fields as they are and compares int32 cells.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nbodysim_tpu_torch.core.blocking import pairwise_blocked


TILE = 256          # sources a pass of the kernel stages (kTile)
PAD_POS = 1e18      # where its padding sources sit (kPadPos)
BLOCK_TARGETS = 64  # 2 targets a thread, 32 threads a slice


def staged_sources(pos: torch.Tensor, vel: torch.Tensor, mass: torch.Tensor,
                   radius: torch.Tensor, tile: int = TILE
                   ) -> Tuple[torch.Tensor, ...]:
    """(pos, vel, mass, radius) rounded up to a whole `tile` of rows: the
    radius is NaN where the mass is <= 0, and the padding rows sit at
    PAD_POS with zero velocity and mass and a NaN radius."""
    s = pos.shape[0]
    pad = -(-s // tile) * tile - s
    nan = torch.full_like(radius, float("nan"))
    r = torch.where(mass > 0.0, radius, nan)
    return (torch.cat([pos, pos.new_full((pad, pos.shape[1]), PAD_POS)]),
            torch.cat([vel, vel.new_zeros((pad, vel.shape[1]))]),
            torch.cat([mass, mass.new_zeros(pad)]),
            torch.cat([r, r.new_full((pad,), float("nan"))]))


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
    rows: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch Jacobi deltas (dpos, dvel), [N, D] each; temps bounded at
    [1024, 4096, D]. Self pairs are no-ops in the pair math (d = v = 0).
    With rows = (row0, n_rows), only the targets [row0, row0 + n_rows)
    against all N sources: [n_rows, D] each."""

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
    targets = fields
    if rows is not None:
        row0, n_rows = _check_rows(rows, pos.shape[0])
        targets = tuple(f[row0:row0 + n_rows] for f in fields)
    dim = pos.shape[1]
    return pairwise_blocked(kernel, targets, fields,
                            out_dims=((dim,), (dim,)), dtype=pos.dtype)


def _check_rows(rows: Tuple[int, int], n: int) -> Tuple[int, int]:
    """(row0, n_rows) of a target row range inside [0, n)."""
    row0, n_rows = int(rows[0]), int(rows[1])
    if row0 < 0 or n_rows < 0 or row0 + n_rows > n:
        raise ValueError(f"target rows [{row0}, {row0 + n_rows}) outside "
                         f"[0, {n})")
    return row0, n_rows


def allpairs_collision_deltas(
    pos: torch.Tensor,
    vel: torch.Tensor,
    mass: torch.Tensor,
    radius: torch.Tensor,
    *,
    impulse: float,
    rows: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Jacobi collision deltas (dpos, dvel) on all particles, [N, D] f32.
    With rows = (row0, n_rows), K2's row-range form: the targets
    [row0, row0 + n_rows) against all N sources, [n_rows, D] each (a rank's
    own rows of the all-gathered arrays in the multi-device step)."""
    if pos.device.type == "cpu":
        return collision_deltas_plain(pos, vel, mass, radius, impulse=impulse,
                                      rows=rows)
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
    row0, n_rows = (0, n) if rows is None else _check_rows(rows, n)
    if n_rows == 0:
        return p.new_zeros((0, dim)), p.new_zeros((0, dim))
    out = torch.empty((2, n_rows, dim), dtype=torch.float32, device=device)
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.nb_collision_deltas(
            p.data_ptr(), v.data_ptr(), m.data_ptr(), r.data_ptr(),
            out.data_ptr(), n, row0, n_rows, dim, float(impulse), stream)
    check(status, "nb_collision_deltas")
    allpairs_collision_deltas.launches += 1
    return out[0], out[1]


allpairs_collision_deltas.launches = 0


def rect_pair_deltas_plain(
    tgt: Tuple[torch.Tensor, ...],
    src: Tuple[torch.Tensor, ...],
    *,
    dim: int,
    impulse: float,
    max_cheb: Optional[int] = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch K5: target-side (dpos, dvel) [n, D] of `tgt` against
    `src`, each a (pos [., D], vel, mass [.], radius [.], cell [., D] int)
    tuple; zero-mass rows on either side are inert; with `max_cheb` set,
    only pairs whose cells are within that Chebyshev distance. Blocked over
    both axes (temps <= [2048, 2048, D])."""

    def kernel(tgt_blk, src_blk):
        tp, tv, tm, tr, tc = tgt_blk
        sp, sv, sm, sr, sc = src_blk
        d = sp[None, :, :] - tp[:, None, :]
        v = sv[None, :, :] - tv[:, None, :]
        msum = tm[:, None] + sm[None, :]
        w1 = sm[None, :] / torch.where(msum > 0.0, msum, 1.0)
        r = tr[:, None] + sr[None, :]
        valid = (sm[None, :] > 0.0) & (tm[:, None] > 0.0)
        if max_cheb is not None:
            cheb = (sc[None, :, :] - tc[:, None, :]).abs().amax(-1)
            valid = valid & (cheb <= max_cheb)
        dpos, dvel = _pair_deltas(d, v, w1, r, valid, impulse)
        return dpos.sum(1), dvel.sum(1)

    return pairwise_blocked(kernel, tgt, src, out_dims=((dim,), (dim,)),
                            dtype=tgt[0].dtype, bs_t=2048, bs_s=2048)


def rect_pair_deltas(
    tgt: Tuple[torch.Tensor, ...],
    src: Tuple[torch.Tensor, ...],
    *,
    dim: int,
    impulse: float,
    max_cheb: Optional[int] = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: target-side collision deltas (dpos, dvel), [n, D] f32 each, of
    `tgt` against `src` ((pos, vel, mass, radius, cell) tuples). On a CUDA
    tensor it launches the kernel (or raises); on a CPU tensor it runs the
    plain version."""
    if tgt[0].device.type == "cpu":
        return rect_pair_deltas_plain(tgt, src, dim=dim, impulse=impulse,
                                      max_cheb=max_cheb)
    if tgt[0].device.type != "cuda":
        raise ValueError(f"no K5 kernel for device {tgt[0].device}")
    from nbodysim_tpu_torch.kernels._build import check, f32_args, library
    from nbodysim_tpu_torch.kernels.allpairs import source_splits

    device = tgt[0].device
    tp, tv, tm, tr, sp, sv, sm, sr = f32_args(device, *tgt[:4], *src[:4])
    n, m = tp.shape[0], sp.shape[0]
    for name, (p, v, ms, rd, c), rows in (("tgt", (tp, tv, tm, tr, tgt[4]), n),
                                          ("src", (sp, sv, sm, sr, src[4]),
                                           m)):
        if (dim not in (2, 3) or p.shape != (rows, dim)
                or v.shape != (rows, dim) or ms.shape != (rows,)
                or rd.shape != (rows,) or tuple(c.shape) != (rows, dim)):
            raise ValueError(
                f"{name} shapes {[tuple(a.shape) for a in (p, v, ms, rd, c)]}"
                f": expected [n, D], [n, D], [n], [n], [n, D], D = {dim}")
    if max(n, m) * dim >= 2 ** 31:
        raise ValueError("K5 indexes with 32-bit ints: n * D must be < 2^31")
    if n == 0 or m == 0:
        return torch.zeros_like(tp), torch.zeros_like(tp)
    if max_cheb is None:
        tc = sc = None
    else:
        if max_cheb < 0:
            raise ValueError(f"max_cheb must be >= 0 or None, got {max_cheb}")
        for c in (tgt[4], src[4]):
            if c.device != device:
                raise ValueError(f"tensor on {c.device}, expected {device}")
        tc, sc = (c.to(torch.int32).contiguous() for c in (tgt[4], src[4]))
    splits = source_splits(n, m, device, BLOCK_TARGETS)
    out = torch.empty((2, n, dim), dtype=torch.float32, device=device)
    scratch = (torch.empty((splits, 2, n, dim), dtype=torch.float32,
                           device=device) if splits > 1 else None)
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.nb_rect_pair_deltas(
            tp.data_ptr(), tv.data_ptr(), tm.data_ptr(), tr.data_ptr(),
            None if tc is None else tc.data_ptr(), sp.data_ptr(),
            sv.data_ptr(), sm.data_ptr(), sr.data_ptr(),
            None if sc is None else sc.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), n, m, dim,
            splits, -1 if max_cheb is None else int(max_cheb),
            float(impulse), stream)
    check(status, "nb_rect_pair_deltas")
    rect_pair_deltas.launches += 1
    return out[0], out[1]


rect_pair_deltas.launches = 0
