"""PyTorch port, K5: the plain version of the rectangular collision pass
(what `rect_pair_deltas` runs on a CPU tensor) against the JAX package's
blocked-XLA `_cheb_pair_deltas_blocked`, on the inputs of
tests/test_collisions_block.py::test_rect_pair_kernel_matches_blocked_xla
(drawn with numpy), at that test's tolerance: atol = rtol = 1e-5."""

import numpy as np
import pytest
import jax.numpy as jnp

from nbodysim_tpu.physics.collisions import (
    _cheb_pair_deltas_blocked as jax_rect)
from nbodysim_tpu_torch.kernels.collide import (
    rect_pair_deltas, rect_pair_deltas_plain)
from nbodysim_tpu_torch.physics.collisions import _cheb_pair_deltas_blocked

from _torch_helpers import as_np, as_t


def _rect_inputs(dim, seed=17, n=1024, m=512):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-30.0, 30.0, (n, dim)).astype(np.float32)
    vel = rng.uniform(-5.0, 5.0, (n, dim)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    radius = rng.uniform(0.8, 1.6, n).astype(np.float32)
    cell = np.floor(pos / 3.0).astype(np.int32)
    mass[::7] = 0.0   # inert rows on both sides, like the real residual
    tgt = (pos, vel, mass, radius, cell)
    sel = rng.permutation(n)[:m]
    return tgt, tuple(a[sel] for a in tgt)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("max_cheb", [1, None])
def test_rect_plain_matches_jax(dim, max_cheb):
    tgt, src = _rect_inputs(dim)
    jdp, jdv = jax_rect(tuple(map(jnp.asarray, tgt)),
                        tuple(map(jnp.asarray, src)), dim, 1.5,
                        max_cheb=max_cheb)
    ttgt, tsrc = tuple(map(as_t, tgt)), tuple(map(as_t, src))
    dp, dv = rect_pair_deltas_plain(ttgt, tsrc, dim=dim, impulse=1.5,
                                    max_cheb=max_cheb)
    np.testing.assert_allclose(as_np(dp), np.asarray(jdp), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(as_np(dv), np.asarray(jdv), atol=1e-5,
                               rtol=1e-5)
    assert float(np.abs(np.asarray(jdv)).max()) > 1e-3   # non-trivial
    # On a CPU tensor the wrapper, and the physics module's router with the
    # kernel selected, run exactly the plain version.
    for got in (rect_pair_deltas(ttgt, tsrc, dim=dim, impulse=1.5,
                                 max_cheb=max_cheb),
                _cheb_pair_deltas_blocked(ttgt, tsrc, dim, 1.5,
                                          max_cheb=max_cheb,
                                          use_kernel=True)):
        np.testing.assert_array_equal(as_np(got[0]), as_np(dp))
        np.testing.assert_array_equal(as_np(got[1]), as_np(dv))


def test_rect_masks():
    """Zero-mass targets get nothing, zero-mass sources give nothing, and
    the cell mask cuts pairs whose cells are two apart."""
    pos = np.array([[0.0, 0.0], [1.0, 0.0]], np.float32)
    vel = np.array([[1.0, 0.0], [-1.0, 0.0]], np.float32)
    radius = np.ones(2, np.float32)
    cell = np.array([[0, 0], [2, 0]], np.int32)

    def run(tmass, smass, max_cheb):
        tgt = tuple(map(as_t, (pos[:1], vel[:1], tmass, radius[:1],
                               cell[:1])))
        src = tuple(map(as_t, (pos[1:], vel[1:], smass, radius[1:],
                               cell[1:])))
        dp, dv = rect_pair_deltas_plain(tgt, src, dim=2, impulse=1.5,
                                        max_cheb=max_cheb)
        return float(np.abs(as_np(dv)).sum())

    one = np.ones(1, np.float32)
    zero = np.zeros(1, np.float32)
    assert run(one, one, None) > 0
    assert run(zero, one, None) == 0.0
    assert run(one, zero, None) == 0.0
    assert run(one, one, 1) == 0.0
    assert run(one, one, 2) > 0
