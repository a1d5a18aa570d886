"""PyTorch port on an NVIDIA GPU: the CUDA kernels K1 and K2 against their
plain torch versions on the card, their launch counts, and the main path.

Marked `cuda`; every test skips without a CUDA device. On a machine with a
card and without JAX (tests/conftest.py imports JAX), run:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch

import nbodysim_tpu_torch as nt
from nbodysim_tpu_torch.kernels.allpairs import (
    allpairs_accelerations, allpairs_accelerations_plain)
from nbodysim_tpu_torch.kernels.collide import (
    allpairs_collision_deltas, collision_deltas_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _gen(dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def _uniform(g, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=g.device)


def _k1_inputs(case, dev):
    g = _gen(dev, 1)
    if case == "disc":
        s = nt.init_scene("uniform_disc", nt.SimConfig(n=25_000), device=dev)
        return s.pos, s.mass, {}
    if case == "3d":
        mass = _uniform(g, (4096,), 0.1, 10.0)
        mass[::17] = 0.0
        return _uniform(g, (4096, 3), -1000.0, 1000.0), mass, {}
    if case == "eps0":
        pos = _uniform(g, (257, 2), -100.0, 100.0)
        pos[256] = pos[3]
        return pos, _uniform(g, (257,), 0.1, 10.0), {"eps_sq": 0.0}
    if case == "sources":
        return _uniform(g, (4096, 2), -1e4, 1e4), None, {
            "src_pos": _uniform(g, (3001, 2), -1e4, 1e4),
            "src_mass": _uniform(g, (3001,), 0.1, 10.0)}
    if case == "g":
        return (_uniform(g, (5000, 2), -1e4, 1e4),
                _uniform(g, (5000,), 0.1, 10.0), {"g_const": 2.5})
    raise ValueError(case)


@pytest.mark.parametrize("case", ["disc", "3d", "eps0", "sources", "g"])
def test_k1_matches_plain(dev, case):
    pos, mass, kw = _k1_inputs(case, dev)
    kw = {"eps_sq": 1.0, **kw}
    got = allpairs_accelerations(pos, mass, **kw)
    ref = allpairs_accelerations_plain(pos, mass, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_k1_far_from_origin(dev):
    base = torch.tensor([50000.0, -70000.0], device=dev)
    pos = torch.stack([base, base + torch.tensor([3.0, 4.0], device=dev)])
    mass = torch.tensor([2.0, 8.0], device=dev)
    got = allpairs_accelerations(pos, mass, eps_sq=1.0)
    ref = allpairs_accelerations_plain(pos, mass, eps_sq=1.0)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("dim", [2, 3])
def test_k2_matches_plain(dev, dim):
    g = _gen(dev, 2 + dim)
    half = 37.0 if dim == 2 else 24.0
    pos = _uniform(g, (4096, dim), -half, half)
    vel = _uniform(g, (4096, dim), -5.0, 5.0)
    mass = _uniform(g, (4096,), 0.5, 2.0)
    radius = mass.pow(1 / 3) * 1.5
    dp, dv = allpairs_collision_deltas(pos, vel, mass, radius, impulse=1.5)
    rp, rv = collision_deltas_plain(pos, vel, mass, radius, impulse=1.5)
    torch.cuda.synchronize()
    tol = 1e-5 * max(float((vel + rv).abs().max()), 10.0)
    assert float(((pos + dp) - (pos + rp)).abs().max()) <= tol
    assert float(((vel + dv) - (vel + rv)).abs().max()) <= tol
    p0 = (mass[:, None] * vel).sum(0)
    p1 = (mass[:, None] * (vel + dv)).sum(0)
    assert float((p1 - p0).abs().max()) <= 1e-2 * float(p0.abs().max())


def test_launch_counters_count_kernel_launches_only(dev):
    pos = torch.rand(100, 2, device=dev)
    mass = torch.rand(100, device=dev)
    k1, k2 = allpairs_accelerations.launches, allpairs_collision_deltas.launches
    allpairs_accelerations(pos, mass, eps_sq=1.0)
    allpairs_collision_deltas(pos, pos, mass, mass, impulse=1.5)
    allpairs_accelerations(pos.cpu(), mass.cpu(), eps_sq=1.0)  # plain path
    assert allpairs_accelerations.launches == k1 + 1
    assert allpairs_collision_deltas.launches == k2 + 1


def test_wrappers_reject_malformed_input(dev):
    with pytest.raises(ValueError):
        allpairs_accelerations(torch.rand(10, 4, device=dev),
                               torch.rand(10, device=dev), eps_sq=1.0)
    with pytest.raises(ValueError):
        allpairs_accelerations(torch.rand(10, 2, device=dev),
                               torch.rand(10), eps_sq=1.0)
    with pytest.raises(ValueError):
        allpairs_collision_deltas(torch.rand(10, 2, device=dev),
                                  torch.rand(9, 2, device=dev),
                                  torch.rand(10, device=dev),
                                  torch.rand(10, device=dev), impulse=1.5)


def test_main_path_runs_through_the_kernels(dev):
    sim = nt.Simulation(nt.SimConfig(n=4096), scene="uniform_disc",
                        device="cuda")
    k1, k2 = allpairs_accelerations.launches, allpairs_collision_deltas.launches
    sim.run(10)
    assert allpairs_accelerations.launches - k1 == 10
    assert allpairs_collision_deltas.launches - k2 == 10
    state = sim.state
    assert all(bool(torch.isfinite(getattr(state, f)).all())
               for f in ("pos", "vel", "acc"))
    plain = sim.config.replace(force_backend="torch",
                               collision_backend="torch")
    a = nt.make_step(sim.config)(state)
    b = nt.make_step(plain)(state)
    assert float((a.pos - b.pos).abs().max()) <= \
        1e-5 * float(b.pos.abs().max())
    assert float((a.vel - b.vel).abs().max()) <= \
        1e-5 * float(b.vel.abs().max())
