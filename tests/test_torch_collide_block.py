"""PyTorch port, the lex-sorted block broad phase and K6: the port's block
structure, K6's plain version (what `block_collision_deltas` runs on a CPU
tensor) and the whole `_block_pass` against the JAX package's XLA path
(`collision_backend="xla"`) and against the port's dense pass, mirroring
tests/test_collisions_block.py. Inputs are drawn with numpy.

Tolerances: 1e-5 * max(max|v|, 1) against JAX and the dense pass, as the
JAX tests use (the same pairs, summed in another order); 1e-3 for the
clustered blob, whose ~60-body core sums many overlapping pairs; momentum to
1e-5 of sum m|v|."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import nbodysim_tpu as nb
import nbodysim_tpu_torch as nt
from nbodysim_tpu.physics import collisions as JC
from nbodysim_tpu_torch.kernels.collide_block import (
    block_collision_deltas, block_collision_deltas_plain, k6_needed_pairs,
    lead_offsets, window_length, window_start)
from nbodysim_tpu_torch.physics import collisions as TC

from _torch_helpers import as_np, as_t, extreme_cells_case


def _random(n, dim, seed, span=50.0, big=True):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-span, span, (n, dim)).astype(np.float32)
    vel = rng.uniform(-5.0, 5.0, (n, dim)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    radius = rng.uniform(0.5, 1.5, n).astype(np.float32)
    if big:
        radius[0] = span / 2   # reaches across many cells
        mass[0] = 100.0
    return pos, vel, mass, radius


def _states(arrays):
    return (nb.ParticleState.create(*map(jnp.asarray, arrays)),
            nt.ParticleState.create(*map(as_t, arrays)))


def _cfgs(n, dim=2, **kw):
    kw = dict(n=n, dim=dim, collision_broad_phase="block",
              collision_cell_size=0.0, **kw)
    return nb.SimConfig(collision_backend="xla", **kw), nt.SimConfig(**kw)


def _momentum(mass, vel):
    return (np.asarray(mass)[:, None] * np.asarray(vel)).sum(0)


@pytest.mark.parametrize("dim", [2, 3])
def test_block_pass_matches_jax_and_dense(dim):
    n = 2048 if dim == 2 else 1024
    arrays = _random(n, dim, seed=7)
    js, ts = _states(arrays)
    jc, tc = _cfgs(n, dim)

    # JAX, stage by stage: structure, planes, XLA dense stage, corrections.
    s = JC._block_structure(js.pos, js.radius, jc)
    planes, key_cols, okf, ok_p = JC._block_planes(
        js.pos, js.vel, js.mass, js.radius, s)
    jdp, jdv = JC._block_dense_deltas(planes, key_cols, okf, s, jc)
    jout = JC._block_corrections(js, s, jdp[:n], jdv[:n], ok_p, jc)

    S = TC._block_structure(ts.pos, ts.radius, tc)
    bp = TC._block_planes(ts, S)
    # The structure is integer work: identical.
    np.testing.assert_array_equal(as_np(S.keys), np.stack(key_cols))
    for ours, theirs in ((S.w_lo, s["w_lo"]), (S.w_hi, s["w_hi"]),
                         (S.ok_blk, s["ok_blk"]), (bp.ok_p, ok_p),
                         (S.bigs.is_big, s["is_big"])):
        np.testing.assert_array_equal(as_np(ours), np.asarray(theirs))
    np.testing.assert_array_equal(as_np(bp.planes[:2 * dim + 2]),
                                  np.stack(planes[:2 * dim + 2]))

    tdp, tdv = TC._block_dense_deltas(bp.planes, S, tc, use_kernel=False)
    # On a CPU tensor the wrapper runs exactly the plain version.
    wdp, wdv = block_collision_deltas(bp.planes, S.keys, S.w_lo, S.w_hi,
                                      t_blk=S.t_blk, impulse=1.5)
    np.testing.assert_array_equal(as_np(wdp), as_np(tdp))
    np.testing.assert_array_equal(as_np(wdv), as_np(tdv))

    tout = TC._apply(ts, TC._block_corrections(ts, S, bp, tdp[:n], tdv[:n],
                                                tc, use_kernel=False))
    dense = TC._dense_pass(ts, tc)
    scale = max(float(np.abs(np.asarray(jout.vel)).max()), 1.0)
    # Rows of the sorted order: the lex sorts agree (both stable here).
    np.testing.assert_array_equal(as_np(S.order), np.asarray(s["order"]))
    for ours, theirs in ((tdp, jdp), (tdv, jdv)):
        np.testing.assert_allclose(as_np(ours), np.asarray(theirs),
                                   atol=1e-5 * scale)
    for ours, theirs in ((tout.pos, jout.pos), (tout.vel, jout.vel),
                         (tout.pos, dense.pos), (tout.vel, dense.vel)):
        np.testing.assert_allclose(as_np(ours), as_np(theirs),
                                   atol=1e-5 * scale)
    assert float(np.abs(as_np(tout.vel) - arrays[1]).max()) > 1e-3
    p0, p1 = _momentum(arrays[2], arrays[1]), _momentum(arrays[2], tout.vel)
    np.testing.assert_allclose(
        p1, p0, atol=1e-5 * float((arrays[2][:, None]
                                   * np.abs(arrays[1])).sum()))


def test_block_plain_band_matches_full():
    """A band of blocks (blk0, nb_loc), as the multi-GPU pass hands out,
    gives exactly the rows of the whole pass."""
    n = 2048
    _, ts = _states(_random(n, 2, seed=5))
    _, tc = _cfgs(n)
    S = TC._block_structure(ts.pos, ts.radius, tc)
    planes = TC._block_planes(ts, S).planes
    full = block_collision_deltas_plain(planes, S.keys, S.w_lo, S.w_hi,
                                        t_blk=256, impulse=1.5)
    band = block_collision_deltas_plain(planes, S.keys, S.w_lo, S.w_hi,
                                        t_blk=256, impulse=1.5, blk0=3,
                                        nb_loc=2)
    for f, b in zip(full, band):
        np.testing.assert_array_equal(as_np(b), as_np(f[3 * 256:5 * 256]))
    with pytest.raises(ValueError):
        block_collision_deltas_plain(planes, S.keys, S.w_lo, S.w_hi,
                                     t_blk=256, impulse=1.5, blk0=7,
                                     nb_loc=2)


def _blob():
    """tests/test_collisions_block.py's clustered blob, drawn with numpy: a
    dense core, sparse outliers and one far body that stretches the span."""
    rng = np.random.default_rng(11)
    n = 2048
    pos = (40.0 * rng.normal(size=(n, 2))).astype(np.float32)
    pos[:64] *= 0.02
    pos[0] = (5e5, 0.0)
    vel = rng.uniform(-20.0, 20.0, (n, 2)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    radius = rng.uniform(1.0, 2.0, n).astype(np.float32)
    return pos, vel, mass, radius


def test_block_pass_clustered_blob_matches_jax_and_dense():
    arrays = _blob()
    js, ts = _states(arrays)
    jc, tc = _cfgs(len(arrays[0]))
    tout = TC._block_pass(ts, tc)
    jout = JC._block_pass(js, jc)
    dense = TC._dense_pass(ts, tc)
    for ref in ((jout.pos, jout.vel), (dense.pos, dense.vel)):
        np.testing.assert_allclose(as_np(tout.pos), as_np(ref[0]), atol=1e-3)
        np.testing.assert_allclose(as_np(tout.vel), as_np(ref[1]), atol=1e-3)
    assert float(np.abs(as_np(tout.vel) - arrays[1]).max()) > 0.1


def test_block_pass_uncovered_blocks_take_the_residual():
    """1300 bodies inside one radius-scaled cell: the blocks in that run
    span more rows than their window holds, so their bodies are uncovered
    and the exact residual (K5's plain version) resolves them; the result
    still matches JAX and the dense pass."""
    rng = np.random.default_rng(21)
    n = 2048
    pos = rng.uniform(-300.0, 300.0, (n, 2)).astype(np.float32)
    pos[:1300] = rng.uniform(0.05, 0.95, (1300, 2)).astype(np.float32)
    vel = rng.uniform(-5.0, 5.0, (n, 2)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    radius = np.full(n, 0.5, np.float32)
    arrays = (pos, vel, mass, radius)
    js, ts = _states(arrays)
    jc, tc = _cfgs(n)
    over = TC.collision_block_overflow(ts, tc)
    assert 0 < over <= TC._OVERFLOW_CAP
    assert over == JC.collision_block_overflow(js, jc)
    tout = TC._block_pass(ts, tc)
    jout = JC._block_pass(js, jc)
    dense = TC._dense_pass(ts, tc)
    scale = max(float(np.abs(as_np(dense.vel)).max()), 1.0)
    for ref in ((jout.pos, jout.vel), (dense.pos, dense.vel)):
        np.testing.assert_allclose(as_np(tout.pos), as_np(ref[0]),
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(as_np(tout.vel), as_np(ref[1]),
                                   atol=1e-5 * scale)
    assert float(np.abs(as_np(tout.vel) - vel).max()) > 0.1


def test_block_overflow_residual_conserves_momentum(monkeypatch):
    """Everything in one cell region and a residual cap of 32: pairs beyond
    the cap drop symmetrically, so momentum is exactly conserved, no NaN."""
    monkeypatch.setattr(TC, "_OVERFLOW_CAP", 32)
    rng = np.random.default_rng(9)
    n = 2048
    pos = (2.0 * rng.normal(size=(n, 2))).astype(np.float32)
    vel = rng.uniform(-5.0, 5.0, (n, 2)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    state = nt.ParticleState.create(*map(as_t, (pos, vel, mass,
                                                np.ones(n, np.float32))))
    _, cfg = _cfgs(n)
    assert TC.collision_block_overflow(state, cfg) > 32
    out = TC._block_pass(state, cfg)
    assert bool(np.isfinite(as_np(out.pos)).all())
    np.testing.assert_allclose(
        _momentum(mass, out.vel), _momentum(mass, vel),
        atol=1e-5 * float((mass[:, None] * np.abs(vel)).sum()))


def test_block_overflow_diagnostic_matches_jax():
    n = 2048
    arrays = _random(n, 2, seed=5, span=500.0, big=False)
    js, ts = _states(arrays)
    jc, tc = _cfgs(n)
    assert TC.collision_block_overflow(ts, tc) == 0
    point = [np.zeros_like(arrays[0])] + list(arrays[1:])
    js, ts = _states(point)
    over = TC.collision_block_overflow(ts, tc)
    assert over >= n - 64
    assert over == JC.collision_block_overflow(js, jc)


def test_resolve_collisions_block_dispatch():
    state = nt.ParticleState.create(
        as_t(np.array([[0.0, 0.0], [1.5, 0.0]], np.float32)),
        as_t(np.array([[1.0, 0.0], [-1.0, 0.0]], np.float32)),
        as_t(np.ones(2, np.float32)), as_t(np.ones(2, np.float32)))
    _, cfg = _cfgs(2)
    out = TC.resolve_collisions(state, cfg)
    # Head-on equal-mass, impulse 1.5: relative velocity scales by -0.5.
    np.testing.assert_allclose(as_np(out.vel), [[-0.5, 0.0], [0.5, 0.0]],
                               atol=1e-5)


def _mask_count(planes, keys, w_lo, w_hi, t_blk):
    """The plain version's key, span, ok and self masks, counted pair by
    pair over every block's fixed windows (int32 wrap as torch computes)."""
    dim, n_tot = keys.shape
    ok = planes[-1] > 0
    w_len = window_length(t_blk)
    win = torch.arange(w_len)
    total = 0
    for b in range(n_tot // t_blk):
        tgt = torch.arange(b * t_blk, (b + 1) * t_blk)
        for o, off in enumerate(lead_offsets(dim)):
            lo, hi = int(w_lo[b, o]), int(w_hi[b, o])
            src = int(window_start(w_lo[b, o], n_tot, t_blk)) + win
            m = ((src >= lo) & (src < hi))[None, :]
            for a in range(dim - 1):
                m = m & (keys[a, src][None, :] == keys[a, tgt][:, None]
                         + off[a])
            m = m & ((keys[dim - 1, src][None, :]
                      - keys[dim - 1, tgt][:, None]).abs() <= 1)
            m = m & ok[src][None, :] & ok[tgt][:, None]
            total += int((m & (src[None, :] != tgt[:, None])).sum())
    return total


@pytest.mark.parametrize("dim", [2, 3])
def test_k6_needed_pairs_matches_a_count_of_the_masks(dim):
    """`k6_needed_pairs` (the work of K6's bound) against a pair-by-pair
    count of the plain version's masks, with uncovered blocks and a big
    body in the state."""
    n = 4096 if dim == 2 else 2048
    arrays = list(_random(n, dim, seed=31, span=25.0 if dim == 2 else 8.0))
    arrays[0][:600] = np.random.default_rng(3).uniform(
        0.05, 0.95, (600, dim)).astype(np.float32)
    _, ts = _states(arrays)
    _, tc = _cfgs(n, dim)
    S = TC._block_structure(ts.pos, ts.radius, tc)
    planes = TC._block_planes(ts, S).planes
    assert 0 < int(S.ok_blk.sum()) < S.ok_blk.numel()
    needed = k6_needed_pairs(planes, S.keys)
    assert needed > n
    assert needed == _mask_count(planes, S.keys, S.w_lo, S.w_hi, S.t_blk)


@pytest.mark.parametrize("dim", [2, 3])
def test_plain_k6_keeps_the_int32_wrap_of_jax(dim):
    """Cells at and near INT_MIN / INT_MAX (neighbours only through the
    wrap, trailing differences of exactly 2^31): the plain version's key
    masks give JAX's dense stage on the same planes, keys and windows."""
    n = 1024
    pos, vel, mass, radius, cells = extreme_cells_case(n, dim, seed=41)
    _, ts = _states((pos, vel, mass, radius))
    jc, tc = _cfgs(n, dim)
    floor = torch.tensor(1e-6, dtype=torch.float32)
    S = TC._blocks_of_cells(as_t(cells), TC._extract_bigs(ts.radius, floor),
                            tc.collision_block_size)
    assert bool(S.ok_blk.any())
    planes = TC._block_planes(ts, S).planes
    dp, dv = block_collision_deltas_plain(planes, S.keys, S.w_lo, S.w_hi,
                                          t_blk=S.t_blk, impulse=1.5)
    # JAX's structure fields that its dense stage reads, for these windows.
    offs = lead_offsets(dim)
    s = dict(t_blk=S.t_blk, nb=S.n_tot // S.t_blk, n_tot=S.n_tot, dim=dim,
             n_off=len(offs), lead_offs=offs, w_len=window_length(S.t_blk),
             w_lo=jnp.asarray(as_np(S.w_lo)), w_hi=jnp.asarray(as_np(S.w_hi)),
             start_row=jnp.asarray(as_np(window_start(S.w_lo, S.n_tot,
                                                      S.t_blk))))
    key_cols = [jnp.asarray(as_np(k)) for k in S.keys]
    jplanes = [jnp.asarray(as_np(p)) for p in planes[:2 * dim + 2]] + key_cols
    jdp, jdv = JC._block_dense_deltas(jplanes, key_cols,
                                      jnp.asarray(as_np(planes[-1])), s, jc)
    scale = max(float(np.abs(vel).max()), 1.0)
    for ours, theirs in ((dp, jdp), (dv, jdv)):
        np.testing.assert_allclose(as_np(ours), np.asarray(theirs),
                                   atol=1e-5 * scale)
    assert float(dv.abs().max()) > 0.1
