"""PyTorch port on an NVIDIA GPU: the CUDA kernels K1-K7 against their
plain torch versions on the card, their launch counts, the N=25k main path,
the 2D and 3D tree code and the large-N collision passes through the kernels
against the same code through the plain versions.

Marked `cuda`; every test skips without a CUDA device. On a machine with a
card and without JAX (tests/conftest.py imports JAX), run:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch

import nbodysim_tpu_torch as nt
from nbodysim_tpu_torch.kernels.allpairs import (
    allpairs_accelerations, allpairs_accelerations_plain,
    allpairs_accelerations_wide)
from nbodysim_tpu_torch.kernels.collide import (
    allpairs_collision_deltas, collision_deltas_plain, rect_pair_deltas,
    rect_pair_deltas_plain)
from nbodysim_tpu_torch.kernels.collide_block import (
    block_collision_deltas, block_collision_deltas_plain)
from nbodysim_tpu_torch.kernels.nearfield import (
    bucket_stencil, bucket_stencil3, bucket_stencil3_plain,
    bucket_stencil_plain)
from nbodysim_tpu_torch.physics import collisions as coll
from nbodysim_tpu_torch.physics.barneshut import bh_accelerations

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
    k3, k4 = bucket_stencil.launches, allpairs_accelerations_wide.launches
    grid = torch.rand(8, 8, 4, device=dev)
    bucket_stencil(grid, grid, grid, rr=2, eps_sq=1.0, center_rows=4)
    bucket_stencil(grid.cpu(), grid.cpu(), grid.cpu(), rr=2, eps_sq=1.0,
                   center_rows=4)
    allpairs_accelerations_wide(pos, pos[:7], mass[:7], eps_sq=1.0)
    assert bucket_stencil.launches == k3 + 1
    assert allpairs_accelerations_wide.launches == k4 + 1
    assert allpairs_accelerations.launches == k1 + 1
    k5 = rect_pair_deltas.launches
    cell = torch.zeros(100, 2, dtype=torch.int32, device=dev)
    fields = (pos, pos, mass, mass, cell)
    rect_pair_deltas(fields, fields, dim=2, impulse=1.5)
    rect_pair_deltas(tuple(f.cpu() for f in fields),
                     tuple(f.cpu() for f in fields), dim=2, impulse=1.5)
    assert rect_pair_deltas.launches == k5 + 1
    k7 = bucket_stencil3.launches
    grid3 = torch.rand(8, 4, 4, 4, device=dev)
    bucket_stencil3(grid3, grid3, grid3, grid3, rr=2, eps_sq=1.0,
                    center_rows=4)
    bucket_stencil3(*(grid3.cpu(),) * 4, rr=2, eps_sq=1.0, center_rows=4)
    assert bucket_stencil3.launches == k7 + 1


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
    grid = torch.rand(8, 8, 4, device=dev)
    with pytest.raises(ValueError):   # rows != center_rows + 2rr
        bucket_stencil(grid, grid, grid, rr=2, eps_sq=1.0, center_rows=5)
    with pytest.raises(ValueError):   # more than 16 slots
        big = torch.rand(8, 8, 17, device=dev)
        bucket_stencil(big, big, big, rr=2, eps_sq=1.0, center_rows=4)
    grid3 = torch.rand(8, 4, 4, 4, device=dev)
    with pytest.raises(ValueError):   # x-slabs != center_rows + 2rr
        bucket_stencil3(*(grid3,) * 4, rr=2, eps_sq=1.0, center_rows=5)
    with pytest.raises(ValueError):   # halo past the largest radius
        bucket_stencil3(*(grid3,) * 4, rr=5, eps_sq=1.0, center_rows=-2)


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


@pytest.mark.parametrize("rows,res,cap,rr,eps_sq", [
    (12, 32, 8, 2, 1.0), (512, 512, 16, 2, 1.0), (13, 37, 16, 1, 1.0),
    (20, 40, 5, 4, 0.0)])
def test_k3_matches_plain(dev, rows, res, cap, rr, eps_sq):
    g = _gen(dev, 7)
    shape = (rows + 2 * rr, res, cap)
    bx, by = _uniform(g, shape, -5.0, 5.0), _uniform(g, shape, -5.0, 5.0)
    bm = _uniform(g, shape, 0.0, 2.0)
    bm = torch.where(torch.rand(shape, generator=g, device=dev) < 0.4, bm,
                     0.0)
    got = bucket_stencil(bx, by, bm, rr=rr, eps_sq=eps_sq, center_rows=rows)
    ref = bucket_stencil_plain(bx, by, bm, rr, eps_sq, rows)
    torch.cuda.synchronize()
    scale = max(float(r.abs().max()) for r in ref)
    for a, r in zip(got, ref):
        assert bool(torch.isfinite(a).all())
        assert float((a - r).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("n,s", [(65_536, 4096), (4096, 300_000)])
def test_k4_and_split_k1_match_plain(dev, n, s):
    """Many targets x few sources (K4), and few x many, where K1 splits its
    sources over a second grid axis."""
    g = _gen(dev, 8)
    pos = _uniform(g, (n, 2), -3e4, 3e4)
    src = _uniform(g, (s, 2), -3e4, 3e4)
    src_m = _uniform(g, (s,), 0.1, 10.0)
    ref = allpairs_accelerations_plain(pos, None, eps_sq=1.0, src_pos=src,
                                       src_mass=src_m)
    if n > s:
        got = allpairs_accelerations_wide(pos, src, src_m, eps_sq=1.0)
    else:
        got = allpairs_accelerations(pos, None, eps_sq=1.0, src_pos=src,
                                     src_mass=src_m)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_tree_code_runs_through_the_kernels(dev):
    """N = 131,072 uniform: 'auto' is the tree; one evaluation launches K1,
    K3 and K4 once each and matches the plain route within 1e-5 max|a|
    (index_add_'s atomics make the pyramid's last bits vary)."""
    g = _gen(dev, 9)
    n = 1 << 17
    pos = _uniform(g, (n, 2), -3e4, 3e4)
    mass = _uniform(g, (n,), 0.1, 10.0)
    cfg = nt.SimConfig(n=n, enable_collisions=False)
    state = nt.ParticleState.create(pos, torch.zeros_like(pos), mass)
    sim = nt.Simulation(cfg, state=state, device=dev)
    assert sim.config.force_backend == "bh"
    counts = [allpairs_accelerations.launches, bucket_stencil.launches,
              allpairs_accelerations_wide.launches]
    got = nt.compute_accelerations(pos, mass, sim.config)
    assert [allpairs_accelerations.launches, bucket_stencil.launches,
            allpairs_accelerations_wide.launches] == [c + 1 for c in counts]
    ref = bh_accelerations(pos, mass, sim.config, use_kernels=False)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    sim.run(2)
    assert sim.frame == 2 and bool(torch.isfinite(sim.state.pos).all())


@pytest.mark.parametrize("rows,res,cap,rr,eps_sq", [
    (64, 64, 16, 1, 1.0), (13, 18, 16, 1, 0.0), (8, 12, 16, 2, 1.0),
    (6, 9, 8, 3, 1.0), (6, 9, 16, 4, 1.0), (5, 7, 5, 4, 0.0)])
def test_k7_matches_plain(dev, rows, res, cap, rr, eps_sq):
    """Every halo the config allows (rr = 1..4: the source cube is staged
    in x-plane chunks where it outgrows shared memory), ragged edges,
    eps = 0."""
    g = _gen(dev, 11)
    shape = (rows + 2 * rr, res, res, cap)
    grid = [_uniform(g, shape, -5.0, 5.0) for _ in range(3)]
    bm = _uniform(g, shape, 0.0, 2.0)
    grid.append(torch.where(torch.rand(shape, generator=g, device=dev) < 0.3,
                            bm, 0.0))
    got = bucket_stencil3(*grid, rr=rr, eps_sq=eps_sq, center_rows=rows)
    ref = bucket_stencil3_plain(*grid, rr, eps_sq, rows)
    torch.cuda.synchronize()
    scale = max(float(r.abs().max()) for r in ref)
    for a, r in zip(got, ref):
        assert bool(torch.isfinite(a).all())
        assert float((a - r).abs().max()) <= 1e-5 * scale


def test_tree3d_runs_through_the_kernels(dev):
    """N = 131,072 uniform 3D: 'auto' is the octree; one evaluation launches
    K1, K4 and K7 once each and matches the plain route within 1e-5 max|a|
    (index_add_'s atomics make the pyramid's last bits vary)."""
    g = _gen(dev, 12)
    n = 1 << 17
    pos = _uniform(g, (n, 3), -3e4, 3e4)
    mass = _uniform(g, (n,), 0.1, 10.0)
    cfg = nt.SimConfig(n=n, dim=3, enable_collisions=False)
    state = nt.ParticleState.create(pos, torch.zeros_like(pos), mass)
    sim = nt.Simulation(cfg, state=state, device=dev)
    assert (sim.config.force_backend, sim.config.bh_deep_levels,
            sim.config.bh_nf_sparse) == ("bh", 0, 0)
    counted = (allpairs_accelerations, allpairs_accelerations_wide,
               bucket_stencil3)
    counts = [c.launches for c in counted]
    got = nt.compute_accelerations(pos, mass, sim.config)
    assert [c.launches for c in counted] == [c + 1 for c in counts]
    ref = bh_accelerations(pos, mass, sim.config, use_kernels=False)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    sim.run(2)
    assert sim.frame == 2 and bool(torch.isfinite(sim.state.pos).all())


def _cloud(g, n, dim, half):
    """A colliding cloud: radius 1.5 cbrt(m), every 7th mass 0."""
    mass = _uniform(g, (n,), 0.5, 2.0)
    radius = mass.pow(1 / 3) * 1.5
    mass[::7] = 0.0
    return (_uniform(g, (n, dim), -half, half),
            _uniform(g, (n, dim), -5.0, 5.0), mass, radius)


def _close(got, ref, vel):
    """K2's rule: within 1e-5 * max(max|v|, 10) of the plain version."""
    tol = 1e-5 * max(float(vel.abs().max()), 10.0)
    return all(bool(torch.isfinite(a).all())
               and float((a - b).abs().max()) <= tol
               for a, b in zip(got, ref))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("max_cheb", [1, None])
@pytest.mark.parametrize("n,m", [(4096, 1500), (64, 200_000)])
def test_k5_matches_plain(dev, dim, max_cheb, n, m):
    """Targets against separate sources; 64 x 200k splits the sources over a
    second grid axis."""
    g = _gen(dev, 10 + dim)
    half = 37.0 if dim == 2 else 24.0
    if m > n:
        half *= (m / 4096) ** (1 / dim)
    src = _cloud(g, m, dim, half)
    tgt = _cloud(g, n, dim, half)
    cell_of = (lambda p: torch.floor(p / 3.0).to(torch.int32))
    tgt, src = tgt + (cell_of(tgt[0]),), src + (cell_of(src[0]),)
    got = rect_pair_deltas(tgt, src, dim=dim, impulse=1.5, max_cheb=max_cheb)
    ref = rect_pair_deltas_plain(tgt, src, dim=dim, impulse=1.5,
                                 max_cheb=max_cheb)
    torch.cuda.synchronize()
    assert _close(got, ref, tgt[1] + ref[1])
    assert float(ref[1].abs().max()) > 1e-3   # overlaps were resolved


def _block_case(dev, dim, residual):
    """A colliding blob for the block pass; with `residual`, 1500 bodies in
    one cell make some blocks uncovered."""
    g = _gen(dev, 20 + dim)
    n = 8192
    half = 60.0 if dim == 2 else 20.0
    pos = _uniform(g, (n, dim), -half, half)
    if residual:
        pos[:1500] = _uniform(g, (1500, dim), 0.05, 0.95)
    mass = _uniform(g, (n,), 0.5, 2.0)
    radius = _uniform(g, (n,), 0.5, 1.0)
    radius[0], mass[0] = 15.0, 100.0   # one big body
    state = nt.ParticleState.create(pos, _uniform(g, (n, dim), -5.0, 5.0),
                                    mass, radius)
    cfg = nt.SimConfig(n=n, dim=dim, collision_broad_phase="block",
                       collision_cell_size=0.0)
    return state, cfg


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("residual", [False, True])
def test_k6_and_block_pass_match_plain(dev, dim, residual):
    state, cfg = _block_case(dev, dim, residual)
    s = coll._block_structure(state.pos, state.radius, cfg)
    planes = coll._block_planes(state, s).planes
    args = (planes, s.keys, s.w_lo, s.w_hi)
    got = block_collision_deltas(*args, t_blk=s.t_blk, impulse=1.5)
    ref = block_collision_deltas_plain(*args, t_blk=s.t_blk, impulse=1.5)
    band = block_collision_deltas(*args, t_blk=s.t_blk, impulse=1.5, blk0=2,
                                  nb_loc=3)
    torch.cuda.synchronize()
    assert _close(got, ref, state.vel)
    rows = slice(2 * s.t_blk, 5 * s.t_blk)
    assert all(torch.equal(b, a[rows]) for a, b in zip(got, band))
    over = coll.collision_block_overflow(state, cfg)
    assert (over > 0) == residual
    counts = (block_collision_deltas.launches, rect_pair_deltas.launches)
    out = coll.resolve_collisions(state, cfg)
    # One K6 launch; two big-body K5 launches, two more for the residual.
    assert (block_collision_deltas.launches - counts[0],
            rect_pair_deltas.launches - counts[1]) == \
        (1, 4 if residual else 2)
    plain = coll.resolve_collisions(
        state, cfg.replace(collision_backend="torch"))
    torch.cuda.synchronize()
    assert _close((out.pos, out.vel), (plain.pos, plain.vel), plain.vel)
    assert float((out.vel - state.vel).abs().max()) > 0.1
    p0 = (state.mass[:, None] * state.vel).sum(0)
    p1 = (state.mass[:, None] * out.vel).sum(0)
    assert float((p1 - p0).abs().max()) <= \
        1e-5 * float((state.mass[:, None] * state.vel.abs()).sum())


def test_merger_resolves_to_block_and_steps(dev):
    """The galaxy merger at N = 131,072 under 'auto': the bucket grid would
    overflow, so collisions run the block pass through K6 and K5."""
    cfg = nt.SimConfig(n=1 << 17, dt=0.05, integrator="leapfrog_kdk",
                       force_backend="cuda")
    with pytest.warns(RuntimeWarning, match="block"):
        sim = nt.Simulation(cfg, scene="galaxy_merger", device=dev)
    assert sim.config.collision_broad_phase == "block"
    k6 = block_collision_deltas.launches
    sim.run(2)
    assert block_collision_deltas.launches - k6 == 2
    assert bool(torch.isfinite(sim.state.pos).all())
