"""PyTorch port, K2: the plain version of the collision narrow phase (what
the wrapper runs on a CPU tensor) against the JAX Pallas kernel in interpret
mode and the JAX XLA `_dense_pass`, on the dense colliding cloud of
tests/test_collisions.py, at that test's tolerance 1e-5 * max(scale, 10)."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbodysim_tpu as nb
import nbodysim_tpu_torch as nt
from nbodysim_tpu.kernels.collide import (
    allpairs_collision_deltas as jax_k2)
from nbodysim_tpu.physics.collisions import _dense_pass as jax_dense
from nbodysim_tpu_torch.kernels.collide import (
    PAD_POS, _pair_deltas, allpairs_collision_deltas, collision_deltas_plain,
    staged_sources)
from nbodysim_tpu_torch.physics.collisions import (
    _dense_pass, resolve_collisions)

from _torch_helpers import CPU, as_np, rand_cloud, as_t


@pytest.mark.parametrize("dim", [2, 3])
def test_plain_matches_jax_dense_cloud(dim):
    pos, vel, mass, radius = rand_cloud(300, dim, seed=7 + dim)
    jstate = nb.ParticleState.create(pos, vel, mass, radius)
    out_x = jax_dense(jstate, nb.SimConfig(n=300, dim=dim,
                                           collision_backend="xla"))
    jdp, jdv = jax_k2(*map(jnp.asarray, (pos, vel, mass, radius)),
                      impulse=1.5, interpret=True)

    fields = tuple(map(as_t, (pos, vel, mass, radius)))
    out = _dense_pass(nt.ParticleState.create(*fields),
                      nt.SimConfig(n=300, dim=dim))
    dp, dv = collision_deltas_plain(*fields, impulse=1.5)
    wdp, wdv = allpairs_collision_deltas(*fields, impulse=1.5)
    # On a CPU tensor the wrapper runs the plain version.
    np.testing.assert_array_equal(as_np(wdp), as_np(dp))
    np.testing.assert_array_equal(as_np(wdv), as_np(dv))
    np.testing.assert_array_equal(as_np(out.pos), pos + as_np(dp))
    assert int(np.sum(np.abs(as_np(dv)).sum(-1) > 0)) > 100  # a dense cloud

    scale = float(np.abs(np.asarray(out_x.vel)).max())
    tol = 1e-5 * max(scale, 10.0)
    for ours, ref in ((as_np(out.pos), np.asarray(out_x.pos)),
                      (as_np(out.vel), np.asarray(out_x.vel)),
                      (pos + as_np(dp), pos + np.asarray(jdp)),
                      (vel + as_np(dv), vel + np.asarray(jdv))):
        np.testing.assert_allclose(ours, ref, atol=tol)
    # Momentum: the Jacobi pair math is antisymmetric.
    p0 = (mass[:, None] * vel).sum(0)
    p1 = (mass[:, None] * as_np(out.vel)).sum(0)
    np.testing.assert_allclose(p1, p0, atol=1e-2 * np.abs(p0).max())
    assert np.abs((mass[:, None] * as_np(dv)).sum(0)).max() < \
        1e-4 * np.abs(mass[:, None] * as_np(dv)).sum()


def test_self_pairs_and_coincident_particles_are_no_ops():
    """d = v = 0 is neither separating nor approaching, for a particle with
    itself and for two coincident particles moving together."""
    pos = np.array([[0.0, 0.0], [0.0, 0.0], [50.0, 0.0]], np.float32)
    vel = np.array([[1.0, 2.0], [1.0, 2.0], [0.0, 0.0]], np.float32)
    mass = np.ones(3, np.float32)
    dp, dv = collision_deltas_plain(*map(as_t, (pos, vel, mass, mass)),
                                    impulse=1.5)
    np.testing.assert_array_equal(as_np(dp), 0.0)
    np.testing.assert_array_equal(as_np(dv), 0.0)


def test_zero_mass_sources_are_inert():
    pos = np.array([[0.0, 0.0], [1.0, 0.0]], np.float32)
    vel = np.array([[1.0, 0.0], [-1.0, 0.0]], np.float32)
    radius = np.ones(2, np.float32)
    mass = np.array([1.0, 0.0], np.float32)
    dp, dv = collision_deltas_plain(*map(as_t, (pos, vel, mass, radius)),
                                    impulse=1.5)
    np.testing.assert_array_equal(as_np(dp)[0], 0.0)
    np.testing.assert_array_equal(as_np(dv)[0], 0.0)
    assert np.abs(as_np(dv)[1]).sum() > 0  # the massive one still hits it


def test_collision_bounce_conserves_momentum():
    """Two overlapping approaching unit bodies: velocities +-1 -> -+0.5."""
    state = nt.ParticleState.create(
        as_t(np.array([[0.0, 0.0], [1.5, 0.0]], np.float32)),
        as_t(np.array([[1.0, 0.0], [-1.0, 0.0]], np.float32)),
        as_t(np.ones(2, np.float32)))
    out = resolve_collisions(state, nt.SimConfig(n=2))
    np.testing.assert_allclose(as_np(out.vel), [[-0.5, 0.0], [0.5, 0.0]],
                               atol=1e-6)
    np.testing.assert_allclose(as_np(out.vel).sum(0), 0.0, atol=1e-6)


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ toolchain")
def test_pair_matches_native_oracle():
    from nbodysim_tpu_torch.oracle import oracle_resolve_pair

    p1, p2 = [0.0, 0.0], [1.0, 0.5]
    v1, v2 = [2.0, 0.3], [-1.0, -0.2]
    m1, m2, r1, r2 = 2.0, 5.0, 1.0, 0.8
    op1, op2, ov1, ov2, hit = oracle_resolve_pair(
        p1, p2, v1, v2, m1, m2, r1, r2)
    assert hit
    state = nt.ParticleState.create(*(
        as_t(np.array(a, np.float32))
        for a in ([p1, p2], [v1, v2], [m1, m2], [r1, r2])))
    out = _dense_pass(state, nt.SimConfig(n=2))
    np.testing.assert_allclose(as_np(out.pos), [op1, op2], atol=1e-5)
    np.testing.assert_allclose(as_np(out.vel), [ov1, ov2], atol=1e-5)
    assert out.pos.device == CPU


def _deltas_unmasked(tgt, src, impulse=1.5):
    """The pair math of `collision_deltas_plain` with no mass mask: only
    the sources' radii decide which pairs can overlap."""
    tp, tv, tm, tr = tgt
    sp, sv, sm, sr = src
    msum = tm[:, None] + sm[None, :]
    w1 = sm[None, :] / torch.where(msum > 0.0, msum, 1.0)
    dpos, dvel = _pair_deltas(
        sp[None] - tp[:, None], sv[None] - tv[:, None], w1,
        tr[:, None] + sr[None, :], torch.ones_like(w1, dtype=torch.bool),
        impulse)
    return dpos.sum(1), dvel.sum(1)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("offset", [0.0, 6e4])
def test_staged_sources_match_raw(dim, offset):
    """The kernel's staged sources (radius NaN where the mass is <= 0, rows
    padded to a whole tile at PAD_POS): the pair math with NO mass mask on
    them gives exactly the plain version's deltas, and the JAX kernel's
    within 1e-5 * max(scale, 10), near and far from the origin; the same
    targets are hit."""
    pos, vel, mass, radius = rand_cloud(300, dim, seed=21 + dim)
    pos = pos + np.float32(offset)
    mass[::7] = 0.0
    fields = tuple(map(as_t, (pos, vel, mass, radius)))
    staged = staged_sources(*fields, tile=64)
    assert staged[0].shape == (320, dim)
    assert bool((staged[0][300:] == PAD_POS).all())
    assert bool(torch.isnan(staged[3][300:]).all())
    assert bool((torch.isnan(staged[3][:300]) == (fields[2] <= 0)).all())
    dp, dv = _deltas_unmasked(fields, staged)
    rp, rv = collision_deltas_plain(*fields, impulse=1.5)
    np.testing.assert_array_equal(as_np(dp), as_np(rp))
    np.testing.assert_array_equal(as_np(dv), as_np(rv))
    hit = (rp.abs().sum(-1) + rv.abs().sum(-1)) > 0
    assert int(hit.sum()) > 50
    assert bool(((dp.abs().sum(-1) + dv.abs().sum(-1) > 0) == hit).all())
    jdp, jdv = jax_k2(*map(jnp.asarray, (pos, vel, mass, radius)),
                      impulse=1.5, interpret=True)
    tol = 1e-5 * max(float(np.abs(vel + as_np(rv)).max()), 10.0)
    np.testing.assert_allclose(as_np(dp), np.asarray(jdp), atol=tol)
    np.testing.assert_allclose(as_np(dv), np.asarray(jdv), atol=tol)


def test_row_range_is_the_full_pass_restricted():
    """The row-range form of the plain pass (the CPU route of K2's row
    form): the targets [row0, row0 + n) against all sources, bit for bit
    the full pass's rows; a range outside the arrays raises."""
    fields = tuple(as_t(a) for a in rand_cloud(300, 2, seed=9))
    full = collision_deltas_plain(*fields, impulse=1.5)
    for row0, n in ((0, 300), (100, 150), (299, 1), (7, 0)):
        part = allpairs_collision_deltas(*fields, impulse=1.5,
                                         rows=(row0, n))
        for a, b in zip(part, full):
            assert torch.equal(a, b[row0:row0 + n])
    with pytest.raises(ValueError, match="outside"):
        collision_deltas_plain(*fields, impulse=1.5, rows=(250, 51))
