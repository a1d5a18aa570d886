"""CPU tests of the reference and of the staged check's parts: the
candidate pairs against every pair, the staged step of every body against
`reference.step` under each integrator, the strata's central masses, and
the refusal of an integrator the check does not know."""

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import check, registry  # noqa: E402
from harness import reference as ref  # noqa: E402

torch.set_num_threads(1)

SIM = {"dt": 0.01, "g_const": 1.0, "softening": 1.0, "max_velocity": 1000.0,
       "boundary_radius": 100000.0, "boundary_soft_frac": 0.8,
       "boundary_force": 0.9, "boundary_damping": 0.9995,
       "enable_boundary": True, "enable_velocity_clamp": True,
       "enable_collisions": True, "collision_impulse": 1.5}


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("seed", range(4))
def test_candidate_pairs_are_every_touching_pair(dim, seed):
    gen = torch.Generator().manual_seed(seed)
    n = 700
    pos = torch.rand(n, dim, generator=gen) * 300 - 150
    radius = torch.rand(n, generator=gen) * 2
    # a few bodies of every larger class, up to one that spans the box
    radius[:12] = torch.tensor([9.0, 9.5, 30, 31, 120, 400, 0, 0, 2.5, 8,
                                35, 1e-3])
    reach = 3.0 * (seed % 2)
    i, j = ref.candidate_pairs(pos, radius, reach)
    got = set(zip(torch.minimum(i, j).tolist(), torch.maximum(i, j).tolist()))
    p = pos.double()
    d2 = (p[:, None] - p[None]).square().sum(-1)
    r = radius.double()
    near = d2 <= (r[:, None] + r[None] + reach) ** 2
    a, b = torch.nonzero(torch.triu(near, 1), as_tuple=True)
    assert got == set(zip(a.tolist(), b.tolist()))
    assert i.numel() == len(got)


def _disc(n, seed):
    st = registry.scene("uniform_disc").make({"n": n}, seed, "cpu")
    st["acc"] = torch.zeros_like(st["pos"])
    return st


@pytest.mark.parametrize("integrator", ["euler_symplectic", "leapfrog_kdk"])
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_staged_step_is_the_reference_step(integrator, seed, monkeypatch):
    """Where both paths run, the staged step of every body (float32
    integration from the exact forces, as the program's would be) is the
    float64 reference's within float32 rounding, and its sample's forces
    are the reference's."""
    monkeypatch.setattr(check, "FULL_LIMIT", 256)
    sim = {**SIM, "integrator": integrator}
    prev = _disc(512, seed)
    # Bodies close enough that some pairs collide in the step.
    prev["pos"][1:] *= 0.05
    eps_sq = sim["softening"] ** 2
    if integrator == "leapfrog_kdk":
        prev["acc"] = ref.exact_acc(prev["pos"], prev["pos"], prev["mass"],
                                    eps_sq, 1.0).float()
    want = ref.step({k: v for k, v in prev.items()}, sim)
    assert want.col.overlapping > 0
    # The program's forces: the exact ones where the step takes them.
    at = prev["pos"].double()
    if integrator == "leapfrog_kdk":
        half = 0.5 * ref.f32(sim["dt"])
        at = at + (prev["vel"].double() + prev["acc"].double() * half) * \
            ref.f32(sim["dt"])
    acc_in = ref.exact_acc(at, at, prev["mass"], eps_sq, 1.0).float()
    got = check.staged(prev, acc_in, sim, seed)
    assert got["resolved"] == want.col.overlapping
    # A body's float32 rounding: 4 spacings of its own coordinates, and a
    # thousandth of its collision correction, which the float32 separation
    # of the pair's positions carries.
    for field, corr in (("pos", want.col.dpos), ("vel", want.col.dvel)):
        x = getattr(want, field)
        err = (got[field] - x).norm(dim=1)
        room = 4 * ref.ulp32(x).max(1).values + 1e-3 * corr.norm(dim=1)
        assert bool((err <= room).all()), (field, float((err / room).max()))
    # The staged forces are float64 sums at float32 positions: the drift's
    # rounding moves them under leapfrog, and nothing under Euler.
    rel = (got["acc"] - want.acc[got["idx"]]).norm(dim=1) / \
        want.acc[got["idx"]].norm(dim=1)
    assert float(rel.max()) <= (1e-12 if integrator == "euler_symplectic"
                                else 1e-5)


def test_strata_center_on_the_central_masses():
    """The disc's central mass is its one body of 1% of the mass or more,
    though over 1% of its bodies are four times the median radius."""
    st = _disc(4096, 7)
    big = st["radius"] > ref.BIG_FACTOR * st["radius"].median()
    assert int(big.sum()) > 40
    parts = check.strata(st["pos"], st["mass"], 7)
    central = int(torch.argmax(st["mass"]))
    assert central in parts["rand"].tolist()
    assert parts["core"].numel() == check.CORE
    assert central not in parts["far"].tolist()


def test_unknown_integrator_is_refused(monkeypatch):
    monkeypatch.setattr(check, "FULL_LIMIT", 256)
    prev = _disc(512, 1)
    sim = {**SIM, "integrator": "rk4"}
    with pytest.raises(ValueError, match="rk4"):
        check.staged(prev, prev["acc"], sim, 1)
    with pytest.raises(ValueError, match="rk4"):
        check.gaps(prev, prev, sim, 1, 1)
