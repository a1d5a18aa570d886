"""PyTorch port on an NVIDIA GPU: the CUDA kernels K1-K7, the potential
kernel and the two trees' M2L kernels against their plain torch versions on
the card (the potential also against the float64 oracle), their launch counts,
the N=25k main path, the 2D and 3D tree code and the large-N collision
passes through the kernels against the same code through the plain
versions.

Marked `cuda`; every test skips without a CUDA device. On a machine with a
card and without JAX (tests/conftest.py imports JAX), run:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import warnings

import pytest
import torch

import nbodysim_tpu_torch as nt
from nbodysim_tpu_torch.kernels import m2l2 as km2
from nbodysim_tpu_torch.kernels import m2l3 as km3
from nbodysim_tpu_torch.kernels.m2l2 import RADII
from nbodysim_tpu_torch.kernels.allpairs import (
    _launch, _launch_potential, allpairs_accelerations,
    allpairs_accelerations_plain, allpairs_accelerations_wide,
    allpairs_potential, allpairs_potential_plain)
from nbodysim_tpu_torch.kernels.collide import (
    allpairs_collision_deltas, collision_deltas_plain, rect_pair_deltas,
    rect_pair_deltas_plain)
from nbodysim_tpu_torch.kernels.collide_block import (
    _launch as k6_launch, block_collision_deltas,
    block_collision_deltas_plain, block_collision_walks, k6_needed_pairs,
    lead_offsets, lex_searchsorted, window_length)
from nbodysim_tpu_torch.kernels.nearfield import (
    bucket_stencil, bucket_stencil3, bucket_stencil3_plain,
    bucket_stencil_plain)
from nbodysim_tpu_torch.physics import barneshut as bh
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


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("rows", [(0, 4096), (1024, 2048), (4000, 96)])
def test_k2_row_range_matches_plain(dev, dim, rows):
    """K2's row-range form (a rank's rows in the multi-device step's
    gathered dense pass): those targets against all sources, massless
    targets moved too, against the plain version and against K2's full
    launch restricted to the same rows."""
    g = _gen(dev, 20 + dim)
    half = 37.0 if dim == 2 else 24.0
    pos = _uniform(g, (4096, dim), -half, half)
    vel = _uniform(g, (4096, dim), -5.0, 5.0)
    mass = _uniform(g, (4096,), 0.5, 2.0)
    mass[::16] = 0.0
    radius = mass.clamp_min(0.5).pow(1 / 3) * 1.5
    row0, n_rows = rows
    sl = slice(row0, row0 + n_rows)
    dp, dv = allpairs_collision_deltas(pos, vel, mass, radius, impulse=1.5,
                                       rows=rows)
    rp, rv = collision_deltas_plain(pos, vel, mass, radius, impulse=1.5,
                                    rows=rows)
    fp, fv = allpairs_collision_deltas(pos, vel, mass, radius, impulse=1.5)
    torch.cuda.synchronize()
    assert dp.shape == (n_rows, dim)
    tol = 1e-5 * max(float((vel[sl] + rv).abs().max()), 10.0)
    assert float((dp - rp).abs().max()) <= tol
    assert float((dv - rv).abs().max()) <= tol
    assert torch.equal(dp, fp[sl]) and torch.equal(dv, fv[sl])
    massless = mass[sl] == 0.0
    assert float(dv[massless].abs().max()) > 0.0


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
    full = torch.full((8, 8), 4, dtype=torch.int32, device=dev)
    bucket_stencil(grid, grid, grid, counts=full, rr=2, eps_sq=1.0,
                   center_rows=4)
    bucket_stencil(grid.cpu(), grid.cpu(), grid.cpu(), counts=full.cpu(),
                   rr=2, eps_sq=1.0, center_rows=4)
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
    full3 = torch.full((8, 4, 4), 4, dtype=torch.int32, device=dev)
    bucket_stencil3(grid3, grid3, grid3, grid3, counts=full3, rr=2,
                    eps_sq=1.0, center_rows=4)
    bucket_stencil3(*(grid3.cpu(),) * 4, counts=full3.cpu(), rr=2,
                    eps_sq=1.0, center_rows=4)
    assert bucket_stencil3.launches == k7 + 1


def test_wrappers_reject_malformed_input(dev):
    with pytest.raises(ValueError):
        allpairs_accelerations(torch.rand(10, 4, device=dev),
                               torch.rand(10, device=dev), eps_sq=1.0)
    with pytest.raises(ValueError):
        allpairs_accelerations(torch.rand(10, 2, device=dev),
                               torch.rand(10), eps_sq=1.0)
    with pytest.raises(ValueError):
        allpairs_potential(torch.rand(10, 4, device=dev),
                           torch.rand(10, device=dev), eps_sq=1.0)
    with pytest.raises(ValueError):
        allpairs_potential(torch.rand(10, 2, device=dev),
                           torch.rand(9, device=dev), eps_sq=1.0)
    with pytest.raises(ValueError):
        allpairs_potential(torch.rand(10, 2, device=dev), torch.rand(10),
                           eps_sq=1.0)
    with pytest.raises(ValueError):
        allpairs_collision_deltas(torch.rand(10, 2, device=dev),
                                  torch.rand(9, 2, device=dev),
                                  torch.rand(10, device=dev),
                                  torch.rand(10, device=dev), impulse=1.5)
    grid = torch.rand(8, 8, 4, device=dev)
    full = torch.full((8, 8), 4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):   # rows != center_rows + 2rr
        bucket_stencil(grid, grid, grid, counts=full, rr=2, eps_sq=1.0,
                       center_rows=5)
    with pytest.raises(ValueError):   # more than 16 slots
        big = torch.rand(8, 8, 17, device=dev)
        bucket_stencil(big, big, big, counts=full, rr=2, eps_sq=1.0,
                       center_rows=4)
    with pytest.raises(ValueError):   # counts on the host
        bucket_stencil(grid, grid, grid, counts=full.cpu(), rr=2,
                       eps_sq=1.0, center_rows=4)
    with pytest.raises(ValueError):   # counts not int32
        bucket_stencil(grid, grid, grid, counts=full.long(), rr=2,
                       eps_sq=1.0, center_rows=4)
    grid3 = torch.rand(8, 4, 4, 4, device=dev)
    full3 = torch.full((8, 4, 4), 4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):   # x-slabs != center_rows + 2rr
        bucket_stencil3(*(grid3,) * 4, counts=full3, rr=2, eps_sq=1.0,
                        center_rows=5)
    with pytest.raises(ValueError):   # halo past the largest radius
        bucket_stencil3(*(grid3,) * 4, counts=full3, rr=5, eps_sq=1.0,
                        center_rows=-2)
    with pytest.raises(ValueError):   # counts of another shape
        bucket_stencil3(*(grid3,) * 4, counts=full3[:7], rr=2, eps_sq=1.0,
                        center_rows=4)


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
    full = torch.full(shape[:-1], cap, dtype=torch.int32, device=dev)
    got = bucket_stencil(bx, by, bm, counts=full, rr=rr, eps_sq=eps_sq,
                         center_rows=rows)
    ref = bucket_stencil_plain(bx, by, bm, rr, eps_sq, rows)
    torch.cuda.synchronize()
    scale = max(float(r.abs().max()) for r in ref)
    for a, r in zip(got, ref):
        assert bool(torch.isfinite(a).all())
        assert float((a - r).abs().max()) <= 1e-5 * scale


def _occupied_grid(g, rows, res, cap, rr, dim, mode):
    """A bucket grid as the force path leaves it: a count per cell (halo
    slabs included), the slots below it filled, the slots above empty.
    'random': counts uniform in 0..cap, and one cell in 8 holds a massless
    particle in its last occupied slot (a heavy body the tree zeroed);
    'full': every slot of every cell occupied; 'coincident': 'random' with
    slot 1 put onto slot 0 wherever a cell holds both; 'far': 'random'
    shifted to 5e4 from the origin (the near field's differences lose the
    same bits in the kernel and the plain version)."""
    dev = g.device
    cells = (rows + 2 * rr,) + (res,) * (dim - 1)
    if mode == "full":
        counts = torch.full(cells, cap, dtype=torch.int32, device=dev)
    else:
        counts = torch.randint(0, cap + 1, cells, generator=g, device=dev,
                               dtype=torch.int32)
    occ = torch.arange(cap, device=dev) < counts[..., None]
    shape = cells + (cap,)
    shift = 5e4 if mode == "far" else 0.0
    pos = [torch.where(occ, shift + _uniform(g, shape, -5.0, 5.0), 0.0)
           for _ in range(dim)]
    mass = torch.where(occ, _uniform(g, shape, 0.1, 2.0), 0.0)
    massless = torch.zeros(shape, dtype=torch.bool, device=dev)
    if mode != "full":
        pick = (torch.rand(cells, generator=g, device=dev) < 0.125) & (
            counts > 0)
        last = (counts.long() - 1).clamp_min(0)[..., None]
        massless.scatter_(-1, last, pick[..., None])
        mass = torch.where(massless, 0.0, mass)
    if mode == "coincident":
        both = counts >= 2
        for p in pos:
            p[..., 1] = torch.where(both, p[..., 0], p[..., 1])
    return (*pos, mass), counts, massless


def _hold_to_plain(got, ref, counts, rr, rows):
    """The kernels' contract: the slots below each count within
    1e-5 * max|a| of the plain version, exactly 0 from the count up."""
    cap = ref[0].shape[-1]
    occ = torch.arange(cap, device=counts.device) < \
        counts[rr:rr + rows, ..., None]
    scale = max(float(r[occ].abs().max()) for r in ref)
    for a, r in zip(got, ref):
        assert bool(torch.isfinite(a).all())
        assert float((a[occ] - r[occ]).abs().max()) <= 1e-5 * scale
        assert not bool(a[~occ].any())
    return occ


@pytest.mark.parametrize("dim,rows,res,cap,rr,eps_sq,mode", [
    (2, 12, 37, 16, 0, 1.0, "random"), (2, 13, 37, 16, 1, 1.0, "random"),
    (2, 64, 50, 16, 2, 1.0, "random"), (2, 20, 29, 7, 4, 1.0, "random"),
    (2, 16, 40, 16, 2, 1.0, "full"), (2, 9, 23, 5, 4, 1.0, "full"),
    (2, 16, 33, 16, 2, 0.0, "coincident"),
    (2, 10, 19, 8, 1, 0.0, "coincident"), (2, 24, 30, 16, 2, 1.0, "far"),
    (3, 8, 13, 16, 1, 1.0, "random"), (3, 6, 11, 16, 2, 1.0, "random"),
    (3, 5, 9, 10, 3, 1.0, "random"), (3, 4, 7, 16, 4, 1.0, "random"),
    (3, 12, 12, 16, 1, 1.0, "full"), (3, 4, 6, 16, 4, 1.0, "full"),
    (3, 9, 10, 16, 1, 0.0, "coincident"),
    (3, 5, 7, 6, 3, 0.0, "coincident"), (3, 8, 12, 16, 1, 1.0, "far")])
def test_k3_k7_follow_the_counts(dev, dim, rows, res, cap, rr, eps_sq, mode):
    """K3 (2D) and K7 (3D) on grids filled the force path's way: ragged
    edges, every rr, fewer slots than 16 and 16, every cell full (staged in
    chunks), massless targets in a cell's last occupied slot, eps = 0 with
    coincident pairs, bodies far from the origin (the `rsqrt.approx.ftz`
    kernels against rsqrt); the same result launch after launch."""
    g = _gen(dev, 13 + rr)
    grid, counts, massless = _occupied_grid(g, rows, res, cap, rr, dim, mode)
    kernel, plain = ((bucket_stencil, bucket_stencil_plain) if dim == 2 else
                     (bucket_stencil3, bucket_stencil3_plain))
    got = kernel(*grid, counts=counts, rr=rr, eps_sq=eps_sq,
                 center_rows=rows)
    ref = plain(*grid, rr, eps_sq, rows)
    torch.cuda.synchronize()
    _hold_to_plain(got, ref, counts, rr, rows)
    again = kernel(*grid, counts=counts, rr=rr, eps_sq=eps_sq,
                   center_rows=rows)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if mode != "full":
        target = massless[rr:rr + rows]
        assert bool(target.any())
        assert float(got[0][target].abs().max()) > 0.0


@pytest.mark.parametrize("dim", [2, 3])
def test_k3_k7_on_the_trees_bucket_grid(dev, dim):
    """The grid `_bucket_grid` builds for a uniform scene with a cluster
    (full cells, overflow) and a heavy body (mass zeroed, slot kept): the
    kernel against the plain version slot by slot, and the gathered near
    field per particle."""
    from nbodysim_tpu_torch.physics import barneshut as bh
    from nbodysim_tpu_torch.physics import barneshut3d as bh3

    g = _gen(dev, 14 + dim)
    n, levels, rr = (1 << 16, 7, 2) if dim == 2 else (1 << 15, 5, 1)
    pos = _uniform(g, (n, dim), -3e4, 3e4)
    pos[:600] = _uniform(g, (600, dim), 100.0, 300.0)
    mass = _uniform(g, (n,), 0.1, 10.0)
    mass[-1] = 1e9
    ext = bh._extract_heavy_outliers(pos, mass)
    build = bh._build_pyramid if dim == 2 else bh3._build_pyramid3
    _, _, _, ci, flat = build(ext["bulk_pos"], ext["tree_mass"], levels)
    res = 1 << levels
    b = bh._bucket_grid(pos, ext["tree_mass"], ci, bh._outlier_flat_ids(
        flat, ext["is_out"], res ** dim), res, bh.NEAR_CAP, rr)
    assert int(b.overflow) > 0 and int(b.counts.max()) == bh.NEAR_CAP
    got = bh._bucket_stencil_dispatch(b, rr, 1.0, res, use_kernels=True)
    ref = bh._bucket_stencil_dispatch(b, rr, 1.0, res, use_kernels=False)
    torch.cuda.synchronize()
    _hold_to_plain(got, ref, b.counts, rr, res)
    a_got = bh._bucket_gather(b, got, res, bh.NEAR_CAP)
    a_ref = bh._bucket_gather(b, ref, res, bh.NEAR_CAP)
    assert float((a_got - a_ref).abs().max()) <= \
        1e-5 * float(a_ref.abs().max())


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
    """Every halo the config allows (rr = 1..4), ragged edges, eps = 0, on
    random slot masks with every slot counted as occupied."""
    g = _gen(dev, 11)
    shape = (rows + 2 * rr, res, res, cap)
    grid = [_uniform(g, shape, -5.0, 5.0) for _ in range(3)]
    bm = _uniform(g, shape, 0.0, 2.0)
    grid.append(torch.where(torch.rand(shape, generator=g, device=dev) < 0.3,
                            bm, 0.0))
    full = torch.full(shape[:-1], cap, dtype=torch.int32, device=dev)
    got = bucket_stencil3(*grid, counts=full, rr=rr, eps_sq=eps_sq,
                          center_rows=rows)
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


def _k6_hard_case(dev, dim, case, t_blk):
    """K6's operands (planes, keys, w_lo, w_hi) and the sorted mass and
    velocity for one of the hard cases: 'crowded' (400 bodies in one
    covered cell: runs longer than a 256-row tile), 'uncovered' (3000 in
    one cell: blocks with no covered target, covered blocks beside them),
    'sentinels' (a ragged N: the last targets sit beside the big-body and
    padding rows) or 'extremes' (cells at and near INT_MIN / INT_MAX, drawn
    apart from the positions: the exact wrapping masks)."""
    g = _gen(dev, 40 + dim)
    n = 8092 if case == "sentinels" else 8192
    half = 60.0 if dim == 2 else 20.0
    pos = _uniform(g, (n, dim), -half, half)
    crowd = {"crowded": 400, "uncovered": 3000}.get(case, 0)
    pos[1:1 + crowd] = _uniform(g, (crowd, dim), 0.05, 0.95)
    mass = _uniform(g, (n,), 0.5, 2.0)
    radius = _uniform(g, (n,), 0.5, 1.0)
    radius[0], mass[0] = 15.0, 100.0   # one big body
    vel = _uniform(g, (n, dim), -5.0, 5.0)
    if case == "extremes":
        from _torch_helpers import extreme_cells_case
        arrays = extreme_cells_case(n, dim, seed=dim)
        pos, vel, mass, radius, cells = (torch.as_tensor(a, device=dev)
                                         for a in arrays)
    state = nt.ParticleState.create(pos, vel, mass, radius)
    cfg = nt.SimConfig(n=n, dim=dim, collision_broad_phase="block",
                       collision_cell_size=0.0, collision_block_size=t_blk)
    if case == "extremes":
        floor = torch.tensor(1e-6, device=dev)
        s = coll._blocks_of_cells(cells, coll._extract_bigs(radius, floor),
                                  t_blk)
    else:
        s = coll._block_structure(pos, radius, cfg)
    planes = coll._block_planes(state, s).planes
    return (planes, s.keys, s.w_lo, s.w_hi), s, planes[2 * dim], \
        planes[dim:2 * dim].T


@pytest.mark.parametrize("t_blk", [256, 1024])
@pytest.mark.parametrize("case", ["crowded", "uncovered", "sentinels",
                                  "extremes"])
@pytest.mark.parametrize("dim", [2, 3])
def test_k6_matches_plain_on_hard_cases(dev, dim, case, t_blk):
    _check_k6_hard_case(dev, dim, case, t_blk)


def test_k6_reads_keys_through_l1_past_shared_memory(dev):
    """At T = 6144 in 3D a window's keys (16 B a row, 2T + 512 rows) no
    longer fit in a CTA's shared memory beside the tiles and runs, so the
    launcher reads them through L1: the crowded case's checks, as at T =
    256 and 1024. (At this T the other cases leave no ok row in the last
    block, or no pair through the wrapped windows.)"""
    t_blk = 6144
    smem_cap, tiles_and_runs = 232448, 512 * 36 + 9 * 256 * 8
    assert 16 * window_length(t_blk) > smem_cap - tiles_and_runs
    _check_k6_hard_case(dev, 3, "crowded", t_blk)


def _check_k6_hard_case(dev, dim, case, t_blk):
    args, s, mass, vel = _k6_hard_case(dev, dim, case, t_blk)
    got = block_collision_deltas(*args, t_blk=t_blk, impulse=1.5)
    ref = block_collision_deltas_plain(*args, t_blk=t_blk, impulse=1.5)
    torch.cuda.synchronize()
    assert _close(got, ref, vel + ref[1])
    # The same rows are hit, and something is.
    hit, hit_ref = ((d != 0).any(1) for d in (got[1], ref[1]))
    assert torch.equal(hit, hit_ref), \
        f"rows hit: {int(hit.sum())}, plain {int(hit_ref.sum())}, " \
        f"differing {int((hit != hit_ref).sum())}"
    assert int(hit.sum()) > 100, f"{int(hit.sum())} rows hit"
    ok = args[0][-1] > 0
    nb = s.ok_blk.numel()
    if case == "crowded":
        # Some ok target's run is longer than a 256-row tile.
        kt = s.keys[:, ok]
        lead = [kt[a] for a in range(dim - 1)]
        lo = lex_searchsorted(list(s.keys), lead + [kt[-1] - 1], False,
                              s.n_tot)
        hi = lex_searchsorted(list(s.keys), lead + [kt[-1] + 1], True,
                              s.n_tot)
        assert int((hi - lo).max()) > 256
    if case == "uncovered":
        assert 0 < int(s.ok_blk.sum()) < nb
    if case == "sentinels":
        last = slice(s.n_tot - t_blk, s.n_tot)
        assert bool(ok[last].any()) and not bool(ok[last].all())
    if case == "extremes":
        assert bool(s.ok_blk.any())
        return   # windows broken by the wrap are not two-sided
    p0 = (mass[:, None] * ref[1]).sum(0)
    p1 = (mass[:, None] * got[1]).sum(0)
    scale = float((mass[:, None] * vel.abs()).sum())
    assert float(p0.abs().max()) <= 1e-5 * scale
    assert float(p1.abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("dim", [2, 3])
def test_k6_walks_its_runs(dev, dim):
    """The counting instantiation: with every block covered and no key
    near the int32 ends, the threads walk exactly the pairs the masks pass
    plus each target's own row, staged or read directly; it gives the
    uncounted launch's deltas bit for bit."""
    state, cfg = _block_case(dev, dim, False)
    s = coll._block_structure(state.pos, state.radius, cfg)
    planes = coll._block_planes(state, s).planes
    args = (planes, s.keys, s.w_lo, s.w_hi)
    launches = block_collision_deltas.launches
    walks = block_collision_walks(*args, t_blk=s.t_blk, impulse=1.5)
    assert block_collision_deltas.launches == launches
    n_ok = int((planes[-1] > 0).sum())
    assert walks["walked"] == k6_needed_pairs(planes, s.keys) + n_ok
    assert walks["walked"] <= walks["warp_slots"]
    assert walks["direct"] <= walks["walked"]
    assert walks["staged"] + walks["direct"] >= n_ok
    assert 0 < walks["overlapping"] <= k6_needed_pairs(planes, s.keys)
    counts = torch.zeros(7, dtype=torch.int64, device=dev)
    counted = k6_launch(*args, s.t_blk, 1.5, 0, None, counts=counts)
    plain = block_collision_deltas(*args, t_blk=s.t_blk, impulse=1.5)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(counted, plain))


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


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("eps_sq", [0.0, 1.0])
@pytest.mark.parametrize("n,s", [(1, 1), (1, 700), (100, 1), (100, 333),
                                 (1000, None), (1000, 2049),
                                 (130, 300_000)])
def test_k1_ragged_sizes_match_plain(dev, k, dim, eps_sq, n, s):
    """K1 at k targets a thread: one target, fewer sources than a tile, a
    ragged last tile, one source, sources = targets, and few targets x many
    sources (the split, with chunks past the end); at eps = 0 with a
    coincident pair."""
    g = _gen(dev, 30 + dim)
    pos = _uniform(g, (n, dim), -1e3, 1e3)
    if s is None:
        src, src_m = pos, _uniform(g, (n,), 0.1, 10.0)
        pos[7] = pos[3]
    else:
        src, src_m = (_uniform(g, (s, dim), -1e3, 1e3),
                      _uniform(g, (s,), 0.1, 10.0))
        pos[0] = src[0]
    src_m[::5] = 0.0
    got = _launch(pos, src, src_m, eps_sq, 1.5, "K1", k=k)
    ref = allpairs_accelerations_plain(pos, None, eps_sq=eps_sq, g_const=1.5,
                                       src_pos=src, src_mass=src_m)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_k1_k2_k5_launches_are_deterministic(dev):
    """No atomics: two launches give the same bits, split or not."""
    g = _gen(dev, 40)
    pos = _uniform(g, (5000, 2), -1e3, 1e3)
    mass = _uniform(g, (5000,), 0.1, 10.0)
    src = _uniform(g, (200_000, 2), -1e3, 1e3)
    src_m = _uniform(g, (200_000,), 0.1, 10.0)
    for fn in (lambda: allpairs_accelerations(pos, mass, eps_sq=1.0),
               lambda: allpairs_accelerations(
                   pos[:100], None, eps_sq=1.0, src_pos=src,
                   src_mass=src_m),
               lambda: allpairs_collision_deltas(
                   pos, pos * 0.01, mass, mass + 30.0, impulse=1.5)[1]):
        assert torch.equal(fn(), fn())
    cloud = _cloud(g, 4096, 2, 37.0)
    fields = cloud + (torch.floor(cloud[0] / 3.0).to(torch.int32),)
    a = rect_pair_deltas(tuple(f[:64] for f in fields), fields, dim=2,
                         impulse=1.5, max_cheb=1)
    b = rect_pair_deltas(tuple(f[:64] for f in fields), fields, dim=2,
                         impulse=1.5, max_cheb=1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("n", [1, 2, 100, 1000, 4097])
def test_k2_ragged_sizes_match_plain(dev, dim, n):
    """K2 on colliding clouds (every 7th mass 0): one particle, two
    overlapping ones, fewer than a tile, ragged tiles; within
    1e-5 * max(max|v|, 10) of the plain version, and the same particles
    get non-zero deltas."""
    g = _gen(dev, 50 + dim)
    half = (37.0 if dim == 2 else 24.0) * (max(n, 2) / 4096) ** (1 / dim)
    pos, vel, mass, radius = _cloud(g, n, dim, half)
    if n == 2:
        pos[1] = pos[0] + 0.5
        mass[:] = 1.0
    got = allpairs_collision_deltas(pos, vel, mass, radius, impulse=1.5)
    ref = collision_deltas_plain(pos, vel, mass, radius, impulse=1.5)
    torch.cuda.synchronize()
    assert _close(got, ref, vel + ref[1])
    hit_ref = (ref[0].abs().sum(-1) + ref[1].abs().sum(-1)) > 0
    hit = (got[0].abs().sum(-1) + got[1].abs().sum(-1)) > 0
    assert torch.equal(hit, hit_ref)
    if n >= 2:
        assert bool(hit_ref.any())


@pytest.mark.parametrize("max_cheb", [1, None])
def test_k5_ragged_3d_matches_plain(dev, max_cheb):
    """K5 in 3D with ragged tiles on both sides."""
    g = _gen(dev, 60)
    src, tgt = _cloud(g, 3001, 3, 24.0), _cloud(g, 1000, 3, 24.0)
    cell_of = (lambda p: torch.floor(p / 3.0).to(torch.int32))
    tgt, src = tgt + (cell_of(tgt[0]),), src + (cell_of(src[0]),)
    got = rect_pair_deltas(tgt, src, dim=3, impulse=1.5, max_cheb=max_cheb)
    ref = rect_pair_deltas_plain(tgt, src, dim=3, impulse=1.5,
                                 max_cheb=max_cheb)
    torch.cuda.synchronize()
    assert _close(got, ref, tgt[1] + ref[1])
    assert float(ref[1].abs().max()) > 1e-3


def _deep_blobs(dev, n):
    """Two dense Gaussian blobs (half the bodies) in a uniform +-4000
    background: the buckets overflow far past the residual's cap."""
    g = _gen(dev, 8)
    blob1 = 60.0 * torch.randn((n // 4, 2), generator=g, device=dev) \
        + torch.tensor([1500.0, -700.0], device=dev)
    blob2 = 40.0 * torch.randn((n // 4, 2), generator=g, device=dev) \
        + torch.tensor([-2000.0, 1000.0], device=dev)
    bg = _uniform(g, (n // 2, 2), -4000.0, 4000.0)
    return torch.cat([blob1, blob2, bg]), _uniform(g, (n,), 0.1, 10.0)


def test_deep_chain_runs_through_the_kernels(dev):
    """The deep chain with tiles at N = 65,536 (levels 7, deep 9): K1, K3
    and K4 once each, against the plain route within 1e-5 * max|a|. With
    deterministic algorithms on, index_add_ sums in a fixed order, so both
    routes build the same pyramid (its atomics' last bits are amplified by
    the tiles' synthesized quadrupoles) and differ only by the kernels."""
    n = 65_536
    pos, mass = _deep_blobs(dev, n)
    cfg = nt.SimConfig(n=n, force_backend="bh", bh_deep_levels=-1)
    levels = bh._resolve_levels(cfg, n)
    deep = bh._resolve_deep_levels(cfg, levels)
    assert bh._resolve_tile_params(cfg, deep, bh._resolve_radius(cfg))[0]
    assert bh.bh_near_overflow(pos, mass, cfg) > bh._OVERFLOW_CAP
    for c in (allpairs_accelerations, allpairs_accelerations_wide,
              bucket_stencil):
        c.launches = 0
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            got = bh_accelerations(pos, mass, cfg)
            ref = bh_accelerations(pos, mass, cfg, use_kernels=False)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    assert (allpairs_accelerations.launches, bucket_stencil.launches,
            allpairs_accelerations_wide.launches) == (1, 1, 1)
    assert bool(torch.isfinite(got).all())
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("nf_sparse", [0, 1])
def test_deep3d_chain_runs_through_the_kernels(dev, nf_sparse):
    """The 3D deep chain with tiles on a clustered blob at N = 65,536
    (levels 5, deep 7), with the dense near field (K1, K4 and K7 once each)
    and with the sparse one (K1 and K4 once, no K7), against the plain
    route within 1e-5 * max|a|, index_add_ deterministic (as in 2D)."""
    from nbodysim_tpu_torch.physics import barneshut3d as bh3
    from nbodysim_tpu_torch.scenes.blob import clustered_blob

    n = 65_536
    pos, mass = clustered_blob(n, center=(500.0, -300.0, 200.0),
                               span=2000.0, seed=3, device=dev)
    cfg = nt.SimConfig(n=n, dim=3, force_backend="bh", bh_levels=5,
                       bh_deep_levels=7, bh_nf_sparse=nf_sparse)
    assert bh3._resolve_tile_params3(cfg, 7, bh3._resolve_radius3(cfg))[0]
    assert bh3.bh3_near_overflow(pos, mass, cfg) > bh._OVERFLOW_CAP
    for c in (allpairs_accelerations, allpairs_accelerations_wide,
              bucket_stencil3):
        c.launches = 0
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            got = bh_accelerations(pos, mass, cfg)
            ref = bh_accelerations(pos, mass, cfg, use_kernels=False)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    assert (allpairs_accelerations.launches,
            allpairs_accelerations_wide.launches,
            bucket_stencil3.launches) == (1, 1, 1 - nf_sparse)
    assert bool(torch.isfinite(got).all())
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-5 * scale


def _m2l3_case(dev, case):
    """(g, corner, size, r, radius, row0, rows, x0) of one M2L kernel case,
    made on the card from the moment pyramid of a clustered blob (N =
    65,536, the deep chain's test input), as the callers pass them: a full
    level (channel-last, as the pyramid holds it), a batch of tile grids
    with one corner each, a banded x-window (its halo slabs given, or cut
    at the grid's edge), a grid whose cells are mostly empty."""
    from nbodysim_tpu_torch.physics import barneshut3d as bh3
    from nbodysim_tpu_torch.scenes.blob import clustered_blob

    kind, r, radius = case
    n = 500 if kind == "empty" else 65_536
    pos, mass = clustered_blob(n, center=(500.0, -300.0, 200.0),
                               span=2000.0, seed=3, device=dev)
    top = max(r.bit_length() - 1, 5)
    grids, corner, size, _, _ = bh3._build_pyramid3(
        pos, mass, top, synth_quad=r == 64)
    lv = r.bit_length() - 1
    g = bh3._channel_stack3(grids[lv if kind != "tiles" else 5])
    qh = radius - 1
    if kind in ("full", "empty"):
        if kind == "empty":
            g = g.clone()
            g[1::3] = 0.0
        return g, corner, size, r, radius, 0, r, 0
    if kind == "tiles":
        s32 = size / 32
        orig = [(0, 0, 0), (8, 16, 4), (16, 8, 16)]
        g = torch.stack([g[a:a + r, b:b + r, c:c + r] for a, b, c in orig])
        corner_t = corner + torch.tensor(orig, dtype=torch.float32,
                                         device=dev) * s32
        return g, corner_t, r * s32, r, radius, 0, r, 0
    row0, rows = (8, 8) if kind == "band" else (0, 8)
    x0 = max(row0 - 2 * qh, 0)
    return (g[x0:row0 + rows + 2 * qh], corner, size, r, radius, row0, rows,
            x0)


M2L3_CASES = ([("full", r, radius) for r in (4, 8, 16, 64)
               for radius in (2, 3)]
              + [("tiles", 16, 2), ("band", 32, 2), ("band", 32, 3),
                 ("band0", 32, 2), ("empty", 16, 2)])


@pytest.mark.parametrize("case", M2L3_CASES, ids=str)
def test_m2l3_matches_plain(dev, case):
    """The M2L kernel against its plain version on the card (cuDNN with
    TF32 off): each of the 19 terms within 1e-5 of that term's max |value|
    over the grid; one launch counted. The kernel centres the moments op for
    op as the plain version does, so they differ in the contraction's
    summation order and the table's roundings alone."""
    g, corner, size, r, radius, row0, rows, x0 = _m2l3_case(dev, case)
    launches = km3.m2l3.launches
    got = km3.m2l3(g, corner, size, r, 25.0, radius, row0=row0, rows=rows,
                   x0=x0)
    assert km3.m2l3.launches == launches + 1
    ref = km3.m2l3_plain(g, corner, size, r, 25.0, radius, row0=row0,
                         rows=rows, x0=x0)
    torch.cuda.synchronize()
    assert len(got) == len(ref) == 19
    for t, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape == g.shape[:-4] + (rows, r, r)
        scale = float(b.abs().max())
        assert scale > 0 and bool(torch.isfinite(a).all()), t
        assert float((a - b).abs().max()) <= 1e-5 * scale, t


def test_m2l3_replays_bit_for_bit(dev):
    """Two launches on one input agree bit for bit (no atomics)."""
    g, corner, size, r, radius, row0, rows, x0 = _m2l3_case(
        dev, ("full", 64, 2))
    a = km3.m2l3(g, corner, size, r, 25.0, radius, row0=row0, rows=rows,
                 x0=x0)
    b = km3.m2l3(g, corner, size, r, 25.0, radius, row0=row0, rows=rows,
                 x0=x0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_m2l3_raises_on_what_it_does_not_take(dev):
    g, corner, size, r, radius, _, _, _ = _m2l3_case(dev, ("full", 16, 2))

    def launch(g_=g, r_=r, radius_=radius, row0=0, rows=16, corner_=corner):
        return km3.m2l3(g_, corner_, size, r_, 25.0, radius_, row0=row0,
                        rows=rows, x0=0)

    for bad in (dict(g_=g.double()), dict(g_=g[..., :9]),
                dict(corner_=corner.double()), dict(rows=15),
                dict(row0=1, rows=8), dict(rows=18), dict(radius_=6),
                dict(g_=g[:15, :15, :15], r_=15)):
        with pytest.raises(ValueError):
            launch(**bad)


def _m2l2_case(dev, case):
    """(g, corner, size, r, radius, row0, rows, x0) of one 2D M2L kernel
    case, made on the card from the quadtree's moment pyramid of the deep
    chain's two dense blobs (N = 65,536; most cells of the fine grids are
    empty), as the callers pass them: a full level (the pyramid's channel
    view), the same level channel-first (another stride order), a batch of
    tile grids with one corner each, a banded row window (its halo rows
    given, or cut at the grid's edge), and the synthesized pyramid of the
    blobs moved to large absolute coordinates (the deep levels' cancelling
    quadrupoles)."""
    kind, r, radius = case
    pos, mass = _deep_blobs(dev, 65_536)
    if kind in ("synth", "tiles"):
        pos = pos + torch.tensor([3.0e5, -2.0e5], device=dev)
    top = max(r.bit_length() - 1, 7)
    grids, corner, size, _, _ = bh._build_pyramid(
        pos, mass, top, synth_quad=kind in ("synth", "tiles"))
    g = bh._channel_stack(grids[r.bit_length() - 1 if kind != "tiles"
                                else 7])
    qh = radius - 1
    if kind in ("full", "synth"):
        return g, corner, size, r, radius, 0, r, 0
    if kind == "chfirst":
        g = g.permute(2, 0, 1).contiguous().permute(1, 2, 0)
        return g, corner, size, r, radius, 0, r, 0
    if kind == "tiles":
        s128 = size / 128
        orig = [(0, 0), (40, 16), (52, 52)]
        g = torch.stack([g[a:a + r, b:b + r] for a, b in orig])
        corner_t = corner + torch.tensor(orig, dtype=torch.float32,
                                         device=dev) * s128
        return g, corner_t, r * s128, r, radius, 0, r, 0
    row0, rows = (16, 16) if kind == "band" else (0, 16)
    x0 = max(row0 - 2 * qh, 0)
    return (g[x0:row0 + rows + 2 * qh], corner, size, r, radius, row0, rows,
            x0)


M2L2_CASES = ([("full", 4, radius) for radius in (2, 3)]
              + [("full", r, radius) for r in (8, 64) for radius in RADII]
              + [("full", 256, 3)]
              + [("full", 1024, radius) for radius in (2, 3, 5)]
              + [("chfirst", 64, 3), ("tiles", 76, 3), ("band", 64, 3),
                 ("band", 64, 5), ("band0", 64, 3), ("synth", 1024, 3)])
# Each term class within this share of the class's max |value| of the plain
# version: the two sum the 42 products of each of 3 (2R-1)^2 sources in
# other orders (cuDNN's implicit GEMM, the kernel's fixed order), and the
# rank-3 and rank-4 derivatives in H cancel more between sources.
M2L2_TOL = {"F": 1e-5, "J": 1e-5, "H": 2e-5}
M2L2_CLASSES = {"F": (0, 1), "J": (2, 3, 4), "H": (5, 6, 7, 8)}


@pytest.mark.parametrize("case", M2L2_CASES, ids=str)
def test_m2l2_matches_plain(dev, case):
    """The 2D M2L kernel against its plain version on the card (cuDNN with
    TF32 off): each term class within its bound (`M2L2_TOL`); one launch
    counted. The kernel centres the moments op for op as the plain version
    does, so they differ in the contraction's summation order and the
    table's roundings alone."""
    g, corner, size, r, radius, row0, rows, x0 = _m2l2_case(dev, case)
    launches = km2.m2l2.launches
    got = km2.m2l2(g, corner, size, r, 25.0, radius, row0=row0, rows=rows,
                   x0=x0)
    assert km2.m2l2.launches == launches + 1
    ref = km2.m2l2_plain(g, corner, size, r, 25.0, radius, row0=row0,
                         rows=rows, x0=x0)
    torch.cuda.synchronize()
    assert len(got) == len(ref) == 9
    for cls, terms in M2L2_CLASSES.items():
        scale = max(float(ref[t].abs().max()) for t in terms)
        assert scale > 0, cls
        for t in terms:
            a, b = got[t], ref[t]
            assert a.shape == b.shape == g.shape[:-3] + (rows, r)
            assert bool(torch.isfinite(a).all()), t
            assert float((a - b).abs().max()) <= M2L2_TOL[cls] * scale, t


def test_m2l2_replays_bit_for_bit(dev):
    """Two launches on one input agree bit for bit (no atomics)."""
    g, corner, size, r, radius, row0, rows, x0 = _m2l2_case(
        dev, ("synth", 1024, 3))
    a = km2.m2l2(g, corner, size, r, 25.0, radius, row0=row0, rows=rows,
                 x0=x0)
    b = km2.m2l2(g, corner, size, r, 25.0, radius, row0=row0, rows=rows,
                 x0=x0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_m2l_level_takes_channel_views_and_stacks(dev):
    """`_m2l_level` on the pyramid's channel views (one strided tensor, no
    copy) and on six separate grids (stacked) launches the kernel once each
    and gives the same terms bit for bit."""
    g, corner, size, r, radius, _, _, _ = _m2l2_case(dev, ("full", 64, 3))
    views = tuple(g[..., c] for c in range(6))
    assert bh._channel_stack(views).data_ptr() == g.data_ptr()
    launches = km2.m2l2.launches
    a = bh._m2l_level(views, corner, size, 25.0, radius)
    b = bh._m2l_level(tuple(v.clone() for v in views), corner, size, 25.0,
                      radius)
    assert km2.m2l2.launches == launches + 2
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_m2l2_raises_on_what_it_does_not_take(dev):
    g, corner, size, r, radius, _, _, _ = _m2l2_case(dev, ("full", 64, 3))

    def launch(g_=g, r_=r, radius_=radius, row0=0, rows=64, corner_=corner):
        return km2.m2l2(g_, corner_, size, r_, 25.0, radius_, row0=row0,
                        rows=rows, x0=0)

    for bad in (dict(g_=g.double()), dict(g_=g[..., :5]),
                dict(corner_=corner.double()), dict(corner_=corner[:1]),
                dict(rows=63), dict(row0=1, rows=8), dict(rows=66),
                dict(radius_=6), dict(g_=g[:63, :63], r_=63)):
        with pytest.raises(ValueError):
            launch(**bad)


def test_tile_selection_on_the_card_equals_the_cpu(dev):
    """Deep-path targets, tile selection (ties broken as lax.top_k does),
    the refined set and the compaction indices: integers, equal on the
    card and on the CPU."""
    n = 65_536
    pos, mass = _deep_blobs(dev, n)
    out = {}
    for d in (dev, torch.device("cpu")):
        p, m = pos.to(d), mass.to(d)
        ext = bh._extract_heavy_outliers(p, m)
        levels, deep, radius, t, T = 7, 9, 3, 32, 8
        _, _, _, ci_f, _ = bh._build_pyramid(ext["bulk_pos"],
                                             ext["tree_mass"], deep,
                                             synth_quad=True)
        res = 1 << levels
        ci = ci_f >> (deep - levels)
        flat = ci[:, 0] * res + ci[:, 1]
        flat_nf = bh._outlier_flat_ids(flat, ext["is_out"], res * res)
        b_par = bh._deep_targets(flat_nf, flat, ext["is_out"], res,
                                 bh.NEAR_CAP, radius)
        tid, tile_slot, orig = bh._tile_select(ci_f, b_par, deep, t, T,
                                               radius)
        cand = (tile_slot[tid] < T) & b_par
        sidx, count = bh._compact_indices(cand, bh._refined_cap(n))
        # Tied scores across the top-T boundary: 5 targets in each of 12
        # tiles of an 8 x 8 tile grid, and 2 in the others.
        tiles = torch.arange(64, device=d)
        per = torch.where(torch.isin(tiles, torch.tensor(
            [3, 10, 17, 40, 41, 50, 60, 62, 63, 1, 22, 9], device=d)), 5, 2)
        tie_tile = tiles.repeat_interleave(per)
        tie_ci = torch.stack([(tie_tile // 8) * 8 + 3, (tie_tile % 8) * 8 + 4],
                             1)
        ties = bh._tile_select(tie_ci, torch.ones_like(tie_tile, dtype=bool),
                               6, 8, T, radius)
        out[d.type] = [x.cpu() for x in (ci_f, b_par, tid, tile_slot, orig,
                                         cand, sidx, count) + tuple(ties)]
    assert int(out["cpu"][1].sum()) > 0 and int(out["cpu"][5].sum()) > 0
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("window", [2, 16])
def test_hash_pass_through_k5_matches_plain(dev, dim, window):
    """The sorted-hash pass (collision_broad_phase='hash') through K5 (two
    big-body launches, two more when bodies pass their window) against the
    same pass through K5's plain version, within 1e-5 * max(max|v|, 10),
    momentum to 1e-5 of sum m|v|; the hash equals the CPU's."""
    g = _gen(dev, 90 + dim)
    n = 20_000
    pos = _uniform(g, (n, dim), -80.0, 80.0)
    vel = _uniform(g, (n, dim), -5.0, 5.0)
    mass = _uniform(g, (n,), 0.5, 2.0)
    radius = 0.8 * mass.pow(1.0 / 3.0)
    radius[:5] = 9.0
    state = nt.ParticleState.create(pos, vel, mass, radius)
    cfg = nt.SimConfig(n=n, dim=dim, collision_broad_phase="hash",
                       collision_cell_size=0.0,
                       collision_max_neighbors=window)
    hg = coll._hash_grid(state.pos, state.radius, cfg)
    cells = hg.cell.cpu()
    assert torch.equal(coll._cell_hash(cells, hg.n_buckets),
                       coll._cell_hash(hg.cell, hg.n_buckets).cpu())
    over = int((~hg.in_win & ~hg.big_s).sum())
    before = rect_pair_deltas.launches
    out = coll.resolve_collisions(state, cfg)
    assert rect_pair_deltas.launches - before == (4 if over else 2)
    plain = coll.resolve_collisions(
        state, cfg.replace(collision_backend="torch"))
    torch.cuda.synchronize()
    assert over > 0 or window == 16   # a window of 2 always overflows
    assert _close((out.pos, out.vel), (plain.pos, plain.vel), plain.vel)
    assert float((out.vel - state.vel).abs().max()) > 0.1
    p0 = (state.mass[:, None] * state.vel).sum(0)
    p1 = (state.mass[:, None] * out.vel).sum(0)
    assert float((p1 - p0).abs().max()) <= \
        1e-5 * float((state.mass[:, None] * state.vel.abs()).sum())


@pytest.mark.parametrize("mode", ["normal", "performance", "overlays"])
def test_render_frame_on_the_card_matches_the_cpu(dev, mode):
    """render_frame on the card against the same state on the CPU: every
    pixel within 1 except at most 0.1% (atomic scatter-add order, the
    transcendentals' last bits)."""
    from nbodysim_tpu_torch.render.splat import RenderConfig, render_frame

    state = nt.init_scene("uniform_disc", nt.SimConfig(n=4096), device=dev)
    kw = {"normal": {}, "performance": {"performance_mode": True},
          "overlays": {"show_quadtree": True, "show_connections": True}}
    rc = RenderConfig(width=320, height=240, scale=0.004, **kw[mode])
    got = render_frame(state, rc)
    assert got.is_cuda and got.dtype == torch.uint8
    want = render_frame(state.to("cpu"), rc)
    off = (got.cpu().int() - want.int()).abs().amax(-1)
    assert int(want.max()) > 0
    assert int((off > 1).sum()) <= 0.001 * off.numel()


def test_checkpoint_roundtrip_on_the_card(dev, tmp_path):
    """A state on the card saved and loaded back onto the card, bit for
    bit, with its config; the loader's default device is the card."""
    from nbodysim_tpu_torch.io.checkpoint import (
        load_checkpoint, save_checkpoint)

    cfg = nt.SimConfig(n=2048, force_backend="cuda")
    sim = nt.Simulation(cfg, scene="uniform_disc", device=dev)
    sim.run(3)
    path = save_checkpoint(str(tmp_path / "c.npz"), sim.state, cfg)
    state, cfg2 = load_checkpoint(path)
    assert state.pos.is_cuda and cfg2 == cfg
    for k in ("pos", "vel", "acc", "mass", "radius", "frame"):
        assert torch.equal(getattr(state, k), getattr(sim.state, k)), k
    resumed = nt.Simulation(cfg2, state=state, device=dev)
    resumed.run(2)
    sim.run(2)
    assert torch.equal(resumed.state.pos, sim.state.pos)
    assert torch.equal(resumed.state.vel, sim.state.vel)


# The potential kernel. Every pair term m_i m_j / r is >= 0, so the sum's
# relative error is bounded by its terms' and its additions': the rsqrt
# (rsqrt.approx, <= 2 ulp) and the roundings of d^2 add <= ~4 f32 ulps
# (5e-7) a term, and the 64-term tile sums at most 63 ulps in the worst
# case, typically ~sqrt(64); the totals are compensated, then double. Hence
# 4e-6 against the float64 oracle. The plain version rounds its own f32
# sums of 4096-term chunks and its torch.sum over targets: 1e-5 between
# the two, as tests/test_torch_allpairs.py holds the plain version to JAX.
POT_ORACLE_RTOL = 4e-6
POT_PLAIN_RTOL = 1e-5


def _pot_inputs(dev, dim, n, eps_sq):
    """n bodies in [-1e3, 1e3]^D, every 5th from the third massless; at
    eps = 0 the last body sits on the first (a coincident pair of massive
    bodies, masked)."""
    g = _gen(dev, 50 + dim)
    pos = _uniform(g, (n, dim), -1e3, 1e3)
    mass = _uniform(g, (n,), 0.1, 10.0)
    mass[2::5] = 0.0
    if eps_sq == 0.0 and n > 1:
        pos[n - 1] = pos[0]
        mass[n - 1] = 3.0
    return pos, mass


def _oracle_pair_sum(pos, mass, eps_sq):
    """sum_{i != j} m_i m_j / sqrt(d^2 + eps^2) over d^2 > 0, float64."""
    from nbodysim_tpu_torch.oracle import oracle_potential_energy

    return -2.0 * oracle_potential_energy(pos.cpu(), mass.cpu(), eps_sq)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("n", [1, 2, 511, 513, 4096, 25_000])
@pytest.mark.parametrize("eps_sq", [0.0, 1.0])
def test_potential_matches_oracle_and_plain(dev, dim, n, eps_sq):
    """The potential kernel on ragged N (one body, one pair, a tile's
    ragged end either side of 512, the drift gate's N = 4096 with its
    source split, the HUD's N = 25,000), at eps = 0 with coincident bodies
    and at eps = 1, with massless bodies: against the float64 oracle and the
    plain version on the card; launched once a call."""
    pos, mass = _pot_inputs(dev, dim, n, eps_sq)
    before = allpairs_potential.launches
    got = allpairs_potential(pos, mass, eps_sq=eps_sq)
    assert allpairs_potential.launches == before + 1
    assert got.shape == () and got.dtype == torch.float32 and got.is_cuda
    plain = allpairs_potential_plain(pos, mass, eps_sq=eps_sq)
    got, plain = float(got), float(plain)
    ref = _oracle_pair_sum(pos, mass, eps_sq)
    if n == 1 or (n == 2 and eps_sq == 0.0):   # no pair, or one coincident
        assert got == plain == ref == 0.0
        return
    assert abs(got - ref) <= POT_ORACLE_RTOL * abs(ref)
    assert abs(got - plain) <= POT_PLAIN_RTOL * abs(plain)


def test_potential_on_the_disc(dev):
    """The HUD's input: the N = 25,000 disc at SimConfig()'s softening,
    through potential_energy (-G/2 times the kernel's pair sum), against
    the float64 oracle and the plain version; two calls give the same
    bits."""
    cfg = nt.SimConfig(n=25_000)
    s = nt.init_scene("uniform_disc", cfg, device=dev)
    from nbodysim_tpu_torch.oracle import oracle_potential_energy
    from nbodysim_tpu_torch.physics.forces import (
        _partial_potential, potential_energy)

    got = potential_energy(s.pos, s.mass, cfg.eps_sq, cfg.g_const)
    assert torch.equal(got, potential_energy(s.pos, s.mass, cfg.eps_sq,
                                             cfg.g_const))
    ref = oracle_potential_energy(s.pos.cpu(), s.mass.cpu(), cfg.eps_sq,
                                  cfg.g_const)
    plain = -0.5 * cfg.g_const * float(_partial_potential(
        s.pos, s.mass, s.pos, s.mass, cfg.eps_sq))
    assert abs(float(got) - ref) <= POT_ORACLE_RTOL * abs(ref)
    assert abs(float(got) - plain) <= POT_PLAIN_RTOL * abs(plain)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("n,splits", [(700, 1), (700, 3), (5000, 1),
                                      (5000, 7)])
def test_potential_launches_are_deterministic(dev, k, dim, n, splits):
    """No atomics: at k targets a thread, split over its sources or not,
    two launches give the same bits, within the plain tolerance of the
    plain version."""
    pos, mass = _pot_inputs(dev, dim, n, 1.0)
    a = _launch_potential(pos, mass, 1.0, splits=splits, k=k)
    b = _launch_potential(pos, mass, 1.0, splits=splits, k=k)
    assert torch.equal(a, b)
    plain = float(allpairs_potential_plain(pos, mass, eps_sq=1.0))
    assert abs(float(a) - plain) <= POT_PLAIN_RTOL * abs(plain)
