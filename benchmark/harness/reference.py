"""Plain reference of the simulator's step, in plain PyTorch, written from
the semantics of the reference simulator (Simulation.hpp:67-155, 216-346)
and imports nothing of the program.

  * gravity: Plummer-softened Newtonian monopole, every source exactly,
    a_i = G * sum_j m_j (x_j - x_i) (|x_j - x_i|^2 + eps^2)^(-3/2);
  * integration: semi-implicit Euler (kick with a(t), clamp |v|, soft
    boundary, drift) or kick-drift-kick leapfrog (the state carries a(t));
  * collisions: one Jacobi pass: every overlapping pair (|d| <= r_i + r_j)
    adds its correction to both bodies, all applied at once. A separating
    pair is pushed apart to contact, each body by the other's mass share;
    an approaching pair is rewound to its time of impact t and gets the
    impulse `impulse * (d_c . v) / |d_c|^2 * d_c` (d_c the separation at
    contact) shared the same way, with the position moved by that velocity
    change times t.

Everything is computed in `dtype` (float64 for the reference, bfloat16 for
the control). Pairs are found by uniform grids, one a size class of radius
(each `BIG_FACTOR` times the last, from the median): a body meets the bodies
of its own and smaller classes in its neighbouring cells. A pair whose
overlap or approach test lies within the rounding of float32 positions and
velocities of its threshold is ambiguous: both pairs are listed
(`Collisions.ambiguous`), and the comparison leaves their bodies out.
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple, Optional

import torch

BIG_FACTOR = 4.0


def f32(x: float) -> float:
    """`x` rounded to float32, as the configuration's dtype holds it."""
    return float(torch.tensor(x, dtype=torch.float32))


def exact_acc(tgt: torch.Tensor, src: torch.Tensor, src_mass: torch.Tensor,
              eps_sq: float, g_const: float, dtype=torch.float64,
              pairs_per_block: int = 1 << 26) -> torch.Tensor:
    """Accelerations on `tgt` [T, D] from every source, in `dtype`, over
    blocks of about `pairs_per_block` pairs. Coincident pairs add 0."""
    tgt = tgt.to(dtype)
    src = src.to(dtype)
    m = src_mass.to(dtype)
    n_t, n_s = tgt.shape[0], src.shape[0]
    bs = min(n_s, max(1024, pairs_per_block // 1024))
    bt = max(1, min(n_t, pairs_per_block // bs))
    out = torch.zeros_like(tgt)
    cols = [src[:, k].contiguous() for k in range(src.shape[1])]
    for t0 in range(0, n_t, bt):
        tp = tgt[t0:t0 + bt]
        for s0 in range(0, n_s, bs):
            d = [c[None, s0:s0 + bs] - tp[:, k, None]
                 for k, c in enumerate(cols)]
            r2 = d[0] * d[0]
            for dk in d[1:]:
                r2.addcmul_(dk, dk)
            w = r2.add_(eps_sq).rsqrt_()
            w = w.mul(w).mul_(w).mul_(m[None, s0:s0 + bs])
            for k, dk in enumerate(d):
                out[t0:t0 + bt, k] += (dk.mul_(w)).sum(1)
    return out * g_const


def potential_energy(pos: torch.Tensor, mass: torch.Tensor, eps_sq: float,
                     g_const: float, dtype=torch.float64,
                     pairs_per_block: int = 1 << 26) -> float:
    """U = -G/2 sum_{i != j} m_i m_j / sqrt(|d|^2 + eps^2), in `dtype`."""
    p = pos.to(dtype)
    m = mass.to(dtype)
    n = p.shape[0]
    bt = max(1, min(n, pairs_per_block // n))
    total = torch.zeros((), dtype=torch.float64, device=p.device)
    for t0 in range(0, n, bt):
        d = p[None, :, :] - p[t0:t0 + bt, None, :]
        d_sq = (d * d).sum(-1)
        pair = m[t0:t0 + bt, None] * m[None, :] * torch.rsqrt(d_sq + eps_sq)
        total += torch.where(d_sq > 0, pair, 0).sum().double()
    return float(-0.5 * g_const * total)


def kinetic_energy(vel: torch.Tensor, mass: torch.Tensor,
                   dtype=torch.float64) -> float:
    """K = 1/2 sum m |v|^2, in `dtype`."""
    v = vel.to(dtype)
    return float(0.5 * (mass.to(dtype) * (v * v).sum(-1)).sum())


def clamp_velocity(vel: torch.Tensor, vmax: float) -> torch.Tensor:
    """|v| <= vmax, direction kept (Simulation.hpp:133-138), evaluated in
    the order the simulator states it."""
    v_sq = (vel * vel).sum(-1, keepdim=True)
    scale = torch.where(v_sq > vmax * vmax,
                        vmax * torch.rsqrt(torch.clamp_min(v_sq, 1e-30)),
                        1.0)
    return vel * scale


def soft_boundary(pos: torch.Tensor, vel: torch.Tensor, dt: float,
                  sim: dict) -> torch.Tensor:
    """Outside 0.8 of the boundary radius: an inward push
    force * exp(r / soft - 1) for dt, then damping (Simulation.hpp:140-155),
    evaluated in the order the simulator states it."""
    soft = sim["boundary_radius"] * sim["boundary_soft_frac"]
    dist_sq = (pos * pos).sum(-1, keepdim=True)
    inv = torch.rsqrt(torch.clamp_min(dist_sq, 1e-30))
    push = sim["boundary_force"] * torch.exp(dist_sq * inv / soft - 1.0)
    out = (vel + -pos * inv * (push * dt)) * sim["boundary_damping"]
    return torch.where(dist_sq > soft * soft, out, vel)


def finish_velocity(pos, vel, dt, sim):
    if sim["enable_velocity_clamp"]:
        vel = clamp_velocity(vel, sim["max_velocity"])
    if sim["enable_boundary"]:
        vel = soft_boundary(pos, vel, dt, sim)
    return vel


# ---------------------------------------------------------------------------
# Collisions
# ---------------------------------------------------------------------------

def radius_class(radius: torch.Tensor) -> torch.Tensor:
    """Each body's size class: 0 up to BIG_FACTOR x the median radius, k
    up to BIG_FACTOR^(k+1) x the median."""
    r = radius.double()
    base = BIG_FACTOR * max(float(r.median()), 1e-30)
    k = torch.ceil(torch.log(r / base) / math.log(BIG_FACTOR))
    return torch.nan_to_num(k, nan=0.0, neginf=0.0).clamp_min(0).long()


def candidate_pairs(pos: torch.Tensor, radius: torch.Tensor,
                    reach: float = 0.0):
    """Every pair (i, j) of bodies, once, with |x_i - x_j| <= r_i + r_j +
    reach. For each size class k (`radius_class`): a uniform grid of cells of
    2 * (the largest radius of classes <= k) + reach over the bodies of
    those classes, each cell of a class-k body against its 3^D neighbours.
    Class 0 is the bulk of the bodies; a larger body thus meets only the
    bodies near it, however many such bodies there are."""
    dev = pos.device
    r = radius.double()
    cls = radius_class(radius)
    ii, jj = [], []
    for k in torch.unique(cls).tolist():
        pts = torch.nonzero(cls <= k).squeeze(1)
        cell = 2.0 * float(r[pts].max()) + reach + 1e-6
        p = pos[pts].double()
        c = torch.floor((p - p.min(0).values) / cell).long()
        span = int(c.max()) + 3
        key = torch.zeros(c.shape[0], dtype=torch.long, device=dev)
        for d in range(pos.shape[1]):
            key = key * span + (c[:, d] + 1)
        order = torch.argsort(key)
        skey = key[order]
        query = torch.nonzero(cls[pts] == k).squeeze(1)
        for off in itertools.product((-1, 0, 1), repeat=pos.shape[1]):
            shift = 0
            for o in off:
                shift = shift * span + o
            nk = key[query] + shift
            lo = torch.searchsorted(skey, nk, side="left")
            hi = torch.searchsorted(skey, nk, side="right")
            cnt = hi - lo
            tot = int(cnt.sum())
            if tot == 0:
                continue
            a = pts[torch.repeat_interleave(query, cnt)]
            start = torch.repeat_interleave(lo, cnt)
            first = torch.cumsum(cnt, 0) - cnt
            rank = torch.arange(tot, device=dev) - torch.repeat_interleave(
                first, cnt)
            b = pts[order[start + rank]]
            # a pair within the class once; a smaller partner always
            keep = (a < b) | (cls[b] < k)
            ii.append(a[keep])
            jj.append(b[keep])
    if not ii:
        e = torch.zeros(0, dtype=torch.long, device=dev)
        return e, e
    i = torch.cat(ii)
    j = torch.cat(jj)
    d = (pos[j].double() - pos[i].double())
    near = (d * d).sum(-1) <= (r[i] + r[j] + reach) ** 2
    return i[near], j[near]


NONE, SEP, APP = 0, 1, 2


def _pair_terms(d, v, rr, impulse, kind):
    """Unweighted (dpos, dvel) of the first body of each pair for outcome
    `kind` [P] (NONE, SEP, APP); the second body gets minus these, each
    weighted by the other's mass share."""
    d_sq = (d * d).sum(-1)
    r_sq = rr * rr
    dist = torch.sqrt(torch.where(d_sq > 0, d_sq, 1.0))
    dpos_sep = -d * (rr / dist - 1.0)[:, None]
    v_sq = (v * v).sum(-1)
    dv = (d * v).sum(-1)
    disc = torch.clamp_min(dv * dv - v_sq * (d_sq - r_sq), 0.0)
    t = (dv + torch.sqrt(disc)) / torch.where(v_sq > 0, v_sq, 1.0)
    dc = d - v * t[:, None]
    dc_sq = (dc * dc).sum(-1)
    scale = impulse * (dc * v).sum(-1) / torch.where(dc_sq > 0, dc_sq, 1.0)
    dvel_app = dc * scale[:, None]
    dpos_app = dvel_app * t[:, None]
    k = kind[:, None]
    dpos = torch.where(k == SEP, dpos_sep, torch.where(k == APP, dpos_app, 0))
    dvel = torch.where(k == APP, dvel_app, 0)
    return dpos, dvel


def _jacobi(n, i, j, d, v, rr, m, impulse, kind):
    """Every pair's correction added to both of its bodies, each weighted
    by the other's mass share: (dpos, dvel) [n, D]."""
    msum = m[i] + m[j]
    msum = torch.where(msum > 0, msum, 1.0)
    w_i, w_j = (m[j] / msum)[:, None], (m[i] / msum)[:, None]
    dp, dvl = _pair_terms(d, v, rr, impulse, kind)
    out_p = torch.zeros((n, d.shape[1]), dtype=d.dtype, device=d.device)
    out_v = torch.zeros_like(out_p)
    out_p.index_add_(0, i, dp * w_i)
    out_p.index_add_(0, j, -dp * w_j)
    out_v.index_add_(0, i, dvl * w_i)
    out_v.index_add_(0, j, -dvl * w_j)
    return out_p, out_v


class Collisions(NamedTuple):
    dpos: torch.Tensor      # [N, D] deltas under each pair's first outcome
    dvel: torch.Tensor
    overlapping: int        # pairs resolved (first outcome not NONE)
    ambiguous: torch.Tensor  # [A, 2] the ambiguous pairs (i, j)


def ulp32(x: torch.Tensor) -> torch.Tensor:
    """The float32 spacing at |x|."""
    a = torch.clamp_min(x.abs(), 1e-30).float()
    return (torch.nextafter(a, torch.full_like(a, float("inf"))) - a).double()


def collisions(pos, vel, mass, radius, impulse: float, dtype=torch.float64,
               pairs=None, ulps: float = 4.0, f32_tests: bool = False):
    """One Jacobi pass over `pairs` (i, j) (default: every candidate pair),
    in `dtype`. A pair is ambiguous when its overlap test lies within
    |d| * dx + dx^2 of its threshold, or its approach test d.v within
    |d| * dv + |v| * dx of 0, where dx (dv) is `ulps` float32 spacings of
    the two bodies' coordinates (velocities).

    With `f32_tests`, the inputs are the float32 state itself: the
    separations and relative velocities are float32 differences, and the
    two tests are evaluated in float32 as the simulator states them
    (d.d = d0 d0 + d1 d1 against (r_i + r_j)^2, d.v = d0 v0 + d1 v1, each
    product and sum rounded), so no pair is ambiguous; the corrections are
    then computed in `dtype`."""
    n = pos.shape[0]
    if pairs is None:
        pairs = candidate_pairs(pos, radius, 0.0)
    i, j = pairs
    if f32_tests:
        p32, v32, r32 = pos.float(), vel.float(), radius.float()
        d32 = p32[j] - p32[i]
        v32 = v32[j] - v32[i]
        rr32 = r32[i] + r32[j]
        dsq32, dv32 = d32[:, 0] * d32[:, 0], d32[:, 0] * v32[:, 0]
        for c in range(1, d32.shape[1]):
            dsq32 = dsq32 + d32[:, c] * d32[:, c]
            dv32 = dv32 + d32[:, c] * v32[:, c]
        over = dsq32 <= rr32 * rr32
        d, v, rr = d32.to(dtype), v32.to(dtype), rr32.to(dtype)
        m = mass.to(dtype)
        kind = torch.where(over, torch.where(dv32 < 0, APP, torch.where(
            dsq32 > 0, SEP, NONE)), NONE)
        out_p, out_v = _jacobi(n, i, j, d, v, rr, m, impulse, kind)
        none = torch.zeros((0, 2), dtype=torch.long, device=pos.device)
        return Collisions(out_p, out_v, int((kind != NONE).sum()), none)
    p, v_, m, r = (x.to(dtype) for x in (pos, vel, mass, radius))
    d = p[j] - p[i]
    v = v_[j] - v_[i]
    rr = r[i] + r[j]
    d_sq = (d * d).sum(-1)
    dv = (d * v).sum(-1)
    over = d_sq <= rr * rr
    kind = torch.where(over, torch.where(dv < 0, APP, torch.where(
        d_sq > 0, SEP, NONE)), NONE)
    out_p, out_v = _jacobi(n, i, j, d, v, rr, m, impulse, kind)

    # Ambiguity from float32 rounding of the inputs.
    pd, vd = pos.double(), vel.double()
    dx = ulps * (ulp32(pd[i]).max(-1).values + ulp32(pd[j]).max(-1).values)
    dvv = ulps * (ulp32(vd[i]).max(-1).values + ulp32(vd[j]).max(-1).values)
    dd, vv, rd = d.double(), v.double(), rr.double()
    dd_sq = (dd * dd).sum(-1)
    dn, vn = torch.sqrt(dd_sq), torch.sqrt((vv * vv).sum(-1))
    amb_ov = (dd_sq - rd * rd).abs() <= 2 * dn * dx + dx * dx + 3e-7 * rd * rd
    amb_dv = (((dd * vv).sum(-1).abs()
               <= dn * dvv + vn * dx + dx * dvv + 3e-7 * dn * vn)
              & (dd_sq <= (rd + dx) ** 2))
    amb = torch.nonzero(amb_ov | amb_dv).squeeze(1)
    return Collisions(out_p, out_v, int((kind != NONE).sum()),
                      torch.stack([i[amb], j[amb]], 1))


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

class Step(NamedTuple):
    pos: torch.Tensor
    vel: torch.Tensor
    acc: torch.Tensor
    col: Optional[Collisions]


def step(state: dict, sim: dict, dtype=torch.float64) -> Step:
    """One full step of every body from `state` ({pos, vel, acc, mass,
    radius}), in `dtype`."""
    dt = f32(sim["dt"])
    eps_sq = sim["softening"] ** 2
    g = sim["g_const"]
    pos, vel = state["pos"].to(dtype), state["vel"].to(dtype)
    mass = state["mass"]
    if sim["integrator"] == "euler_symplectic":
        acc = exact_acc(pos, pos, mass, eps_sq, g, dtype)
        vel = finish_velocity(pos, vel + acc * dt, dt, sim)
        pos = pos + vel * dt
    else:
        vel_h = vel + state["acc"].to(dtype) * (0.5 * dt)
        pos = pos + vel_h * dt
        acc = exact_acc(pos, pos, mass, eps_sq, g, dtype)
        vel = finish_velocity(pos, vel_h + acc * (0.5 * dt), dt, sim)
    col = None
    if sim["enable_collisions"]:
        col = collisions(pos, vel, mass, state["radius"],
                         sim["collision_impulse"], dtype)
        pos = pos + col.dpos
        vel = vel + col.dvel
    return Step(pos, vel, acc, col)
