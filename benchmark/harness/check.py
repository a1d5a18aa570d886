"""The comparison that decides `correct`: the program's own state before
and after the window's last call, held against the plain reference
(`reference.py`) stepped from that same state.

The numbers (a cell's limits file names those it compares):

  pos_gap = max_i |x_i - x_i^ref| / max_i |x_i^ref - x_i^before|
  vel_gap = max_i |v_i - v_i^ref| / max_i |v_i^ref - v_i^before|
  acc_gap = max_i |a_i - a_i^ref| / max_i |a_i^ref|
  acc_p50 = median_i |a_i - a_i^ref| / |a_i^ref|

so that a call that returns its state unchanged reads 1 in the first two.
Up to 65,536 bodies (FULL_LIMIT) the reference steps every body as many
steps as the call made. Above that a call is one step, checked stage by
stage (`staged`), under either integrator the configuration may state
(leapfrog KDK or semi-implicit Euler): the forces on a sample against
exact sums over all bodies, and the integration and collisions of every
body from the program's state and its own (so judged) forces. The sample
has three strata, each drawn by a rule of the benchmark's own: `rand`,
SAMPLE bodies drawn from the seed (with the central masses, each body that
holds at least CENTRAL of the total mass; `acc_p50`); `far`, the FAR
bodies farthest (in the largest coordinate) from the centre of mass of the
others, which a tree code sets apart; `core`, the CORE bodies nearest each
central mass, where the scene is densest. With rel_i = |a_i - a_i^ref| /
|a_i^ref|:

  acc_p50, acc_p99 = the median and 99th percentile of rel over `rand`
  acc_far_max      = the largest rel over `far`
  acc_core_p50     = the median of rel over `core`

The collision stage holds every body to the reference's correction:

  col_pos_gap = max_i |x_i - x_i^ref| / max_i |dx_i^ref|
  col_missed  = the share of the bodies whose position or velocity lies
                off the reference's by more than a quarter of its own
                correction (dx_i^ref, dv_i^ref) and by more than 2 float32
                spacings

and `col_moved` counts the bodies that the reference moves.

A pair that `reference.collisions` marks ambiguous (a test within float32
rounding of its threshold) may go either way in the program. Its bodies,
and every body that could touch one of them in a later step, are left
out; their share (`tainted`) is reported beside the result and not
compared, since it reads the reference's run and not the program's.
"""

from __future__ import annotations

import torch

from harness import reference as ref

FULL_LIMIT = 65_536
SAMPLE = 2048
FAR = 256            # at most 1/64 of the bodies
CORE = 256
CENTRAL = 0.01       # the share of the total mass that makes a central mass


def _state(d: dict, dtype) -> dict:
    return {k: d[k].to(dtype) if k in ("pos", "vel", "acc") else d[k]
            for k in ("pos", "vel", "acc", "mass", "radius")}


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x.double(), dim=-1)


def follow(prev: dict, sim: dict, steps: int, dtype=torch.float64,
           track: bool = True):
    """The reference's `steps` steps of every body from `prev`. Returns
    (final state dict, tainted mask, resolved pairs of the last step);
    without `track` (the control) nothing is tainted."""
    st = _state(prev, dtype)
    taint = torch.zeros(st["pos"].shape[0], dtype=torch.bool,
                        device=st["pos"].device)
    resolved = 0
    for _ in range(steps):
        out = ref.step(st, sim, dtype)
        if out.col is not None:
            resolved = out.col.overlapping
            taint[out.col.ambiguous.flatten()] = track
            if track and bool(taint.any()):
                taint = _spread(out.pos, st["radius"], taint, sim)
        st = {"pos": out.pos, "vel": out.vel, "acc": out.acc,
              "mass": st["mass"], "radius": st["radius"]}
    return st, taint, resolved


def _spread(pos, radius, taint, sim):
    """Every body that could touch a tainted one within a step (closer
    than the sum of radii plus two steps' travel at the velocity cap) is
    tainted too."""
    reach = 2.0 * sim["max_velocity"] * ref.f32(sim["dt"])
    i, j = ref.candidate_pairs(pos, radius, reach)
    hit = taint[i] | taint[j]
    out = taint.clone()
    out[i[hit]] = True
    out[j[hit]] = True
    return out


def strata(pos: torch.Tensor, mass: torch.Tensor, seed: int) -> dict:
    """The force sample's strata, {name: indices} (see the module's
    docstring); `rand` holds the central masses too."""
    n = pos.shape[0]
    dev = pos.device
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    big = mass.double() >= CENTRAL * mass.double().sum()
    big_idx = torch.nonzero(big).squeeze(1)
    p = pos.double()
    m = torch.where(big, 0.0, mass.double())
    com = (m[:, None] * p).sum(0) / torch.clamp_min(m.sum(), 1e-300)
    cheb = torch.where(big, -1.0, (p - com).abs().amax(1))
    out = {"rand": torch.cat([torch.randperm(n, generator=gen)[:SAMPLE]
                              .to(dev), big_idx]),
           "far": torch.topk(cheb, max(1, min(FAR, n // 64))).indices}
    core = [torch.topk(torch.where(big, float("inf"),
                                   (p - p[b]).square().sum(1)),
                       min(CORE, n), largest=False).indices
            for b in big_idx.tolist()]
    if core:
        out["core"] = torch.cat(core)
    return out


def _euler(pos, vel, acc, dt, sim):
    """Semi-implicit Euler once the forces are known: kick, clamp,
    boundary at the positions before the step, drift."""
    vel = ref.finish_velocity(pos, vel + acc * dt, dt, sim)
    return pos + vel * dt, vel


def staged(prev: dict, acc_in: torch.Tensor, sim: dict, seed: int,
           dtype=None) -> dict:
    """One step above FULL_LIMIT bodies, stage by stage, in the order
    `reference.step` takes for the configuration's integrator.

    Forces: exact accelerations (`dtype`, float64 by default) of the
    sample's bodies (`strata`) where the step takes its forces: at the
    drifted positions (leapfrog KDK) or at the positions before the step
    (semi-implicit Euler, which drifts last). The program's state after a
    step holds those same forces as `acc` under either integrator: a(x)
    of the drifted x, or a(x) of the x before the step. Integration and
    collisions of every body: from `prev` and the step's accelerations
    `acc_in` (the program's own, which the force stage judges), in float32
    as the configuration states, the collision tests in float32 and their
    corrections in float64 (all in `dtype` when one is given: the
    control). Returns {pos, vel} of every body, the collision corrections
    {dpos, dvel} (None without collisions), the sample's {idx, acc} and
    its strata as positions in idx, and the pairs resolved."""
    euler = sim["integrator"] == "euler_symplectic"
    if not euler and sim["integrator"] != "leapfrog_kdk":
        raise ValueError("the staged check steps leapfrog_kdk or "
                         f"euler_symplectic, not {sim['integrator']!r}")
    dt = ref.f32(sim["dt"])
    half = 0.5 * dt
    low = dtype or torch.float32
    st = _state(prev, low)
    if euler:
        pos, pos32 = st["pos"], prev["pos"]
    else:
        vel_h = st["vel"] + st["acc"] * half
        pos = st["pos"] + vel_h * dt
        # The strata from the float32 drift in either precision.
        pos32 = prev["pos"] + (prev["vel"] + prev["acc"] * half) * dt
    parts = strata(pos32, prev["mass"], seed)
    idx = torch.cat(list(parts.values()))
    spans, at = {}, 0
    for name, ix in parts.items():
        spans[name] = (at, at + ix.numel())
        at += ix.numel()
    acc = ref.exact_acc(pos[idx], pos, st["mass"], sim["softening"] ** 2,
                        sim["g_const"], dtype or torch.float64)
    if dtype is not None:
        # The control integrates with its own forces where it has them.
        acc_in = acc_in.clone()
        acc_in[idx] = acc.to(acc_in.dtype)
    if euler:
        pos, vel = _euler(pos, st["vel"], acc_in.to(low), dt, sim)
        # The float32 step in either precision, for the candidate pairs.
        pos32 = pos if dtype is None else _euler(
            prev["pos"], prev["vel"], acc_in.float(), dt, sim)[0]
    else:
        vel = ref.finish_velocity(pos, vel_h + acc_in.to(low) * half, dt,
                                  sim)
    resolved, dpos, dvel = 0, None, None
    if sim["enable_collisions"]:
        # The candidate pairs come from the float32 drift in either
        # precision: bodies that bfloat16 rounds onto one point would pair
        # without end.
        pairs = ref.candidate_pairs(pos32, prev["radius"], 0.0)
        col = ref.collisions(pos, vel, st["mass"], st["radius"],
                             sim["collision_impulse"],
                             dtype or torch.float64, pairs=pairs,
                             f32_tests=dtype is None)
        dpos, dvel = col.dpos, col.dvel
        pos = pos.to(dpos.dtype) + dpos
        vel = vel.to(dvel.dtype) + dvel
        resolved = col.overlapping
    return {"pos": pos, "vel": vel, "dpos": dpos, "dvel": dvel, "idx": idx,
            "acc": acc, "strata": spans, "acc_in": acc_in,
            "resolved": resolved}


def _force_numbers(rel: torch.Tensor, spans: dict) -> dict:
    """The staged check's force numbers from the sample's relative errors
    `rel` and its strata (`staged`)."""
    part = {name: rel[a:b] for name, (a, b) in spans.items()}
    out = {"acc_p50": float(part["rand"].median()),
           "acc_p99": float(torch.quantile(part["rand"], 0.99)),
           "acc_far_max": float(part["far"].max())}
    if "core" in part:
        out["acc_core_p50"] = float(part["core"].median())
    return out


def _collision_numbers(err_p, err_v, out: dict, dpos, dvel) -> dict:
    dp, dv = dpos.double(), dvel.double()
    s_p = float(_norm(dp).max())
    floor_p = 2.0 * ref.ulp32(out["pos"].double())
    floor_v = 2.0 * ref.ulp32(out["vel"].double())
    off_p = err_p.abs() > torch.maximum(0.25 * _norm(dp)[:, None], floor_p)
    off_v = err_v.abs() > torch.maximum(0.25 * _norm(dv)[:, None], floor_v)
    return {
        "col_pos_gap": float(_norm(err_p).max()) / max(s_p, 1e-300),
        "col_missed": float((off_p.any(1) | off_v.any(1)).double().mean()),
        "col_moved": int(((dp != 0).any(1) | (dv != 0).any(1)).sum()),
    }


def gaps(prev: dict, out: dict, sim: dict, steps: int, seed: int,
         dtype=torch.float64) -> dict:
    """The numbers compared for a call of `steps` steps from `prev` (the
    program's state before it) to `out` (after it): {name: value}, and
    `pairs`, the pairs the reference resolved in its last step, and
    `tainted`."""
    n = prev["pos"].shape[0]
    x0, v0 = prev["pos"].double(), prev["vel"].double()
    r = None
    if n <= FULL_LIMIT:
        st, taint, resolved = follow(prev, sim, steps, dtype)
        pos_r, vel_r, acc_r = st["pos"], st["vel"], st["acc"]
        acc_idx = torch.arange(n, device=x0.device)
    else:
        if steps != 1:
            raise ValueError("above FULL_LIMIT bodies a call is one step")
        r = staged(prev, out["acc"], sim, seed)
        pos_r, vel_r, acc_r = r["pos"], r["vel"], r["acc"]
        acc_idx, resolved = r["idx"], r["resolved"]
        taint = torch.zeros(n, dtype=torch.bool, device=x0.device)
    pos_r, vel_r, acc_r = pos_r.double(), vel_r.double(), acc_r.double()
    s_p = float(_norm(pos_r - x0).max())
    s_v = float(_norm(vel_r - v0).max())
    s_a = float(_norm(acc_r).max())
    err_p = out["pos"].double() - pos_r
    err_v = out["vel"].double() - vel_r
    err_a = out["acc"].double()[acc_idx] - acc_r
    keep = ~taint
    ka = keep[acc_idx]
    rel_a = _norm(err_a) / torch.clamp_min(_norm(acc_r), 1e-30)
    nums = {
        "pos_gap": float(_norm(err_p[keep]).max()) / s_p,
        "vel_gap": float(_norm(err_v[keep]).max()) / s_v,
        "acc_gap": float(_norm(err_a[ka]).max()) / s_a,
        "acc_p50": float(rel_a[ka].median()),
        "tainted": float(taint.double().mean()),
        "pairs": resolved,
    }
    if r is not None:
        nums.update(_force_numbers(rel_a, r["strata"]))
        if r["dpos"] is not None:
            nums.update(_collision_numbers(err_p, err_v, out, r["dpos"],
                                           r["dvel"]))
    return nums


def control(prev: dict, out: dict, sim: dict, steps: int, seed: int,
            dtype=torch.bfloat16) -> dict:
    """The control: the reference in the program's place, computed in
    `dtype` (bfloat16, the precision below the configuration's float32).
    Returns its state after the call as the program's would be, float32.
    Above FULL_LIMIT each stage is the reference's in `dtype` on that
    stage's own inputs: the forces on the sample, and integration and
    collisions from `prev` and the forces of the step (its own on the
    sample, the program's `out["acc"]` elsewhere), as `staged` judges
    them."""
    n = prev["pos"].shape[0]
    if n <= FULL_LIMIT:
        st = follow(prev, sim, steps, dtype, track=False)[0]
        return {k: st[k].float() for k in ("pos", "vel", "acc")}
    r = staged(prev, out["acc"], sim, seed, dtype)
    return {"pos": r["pos"].float(), "vel": r["vel"].float(),
            "acc": r["acc_in"].float()}
