"""PyTorch port: config and state parity with the JAX package, the error
paths of what is not ported yet, and the no-JAX import rule."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbodysim_tpu as nb
import nbodysim_tpu_torch as nt
from nbodysim_tpu.io.checkpoint import save_checkpoint
from nbodysim_tpu_torch.physics import collisions as tcoll
from nbodysim_tpu_torch.physics.forces import resolve_backend

from _torch_helpers import CPU, jax_arrays, as_np, to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Every difference between the two SimConfigs, listed once.
DROPPED_FIELDS = {"pallas_interpret"}   # no interpreter for a CUDA kernel
DTYPE = (jnp.float32, torch.float32)
FORCE_BACKENDS = {"jax": ("auto", "pallas", "xla", "bh"),
                  "torch": ("auto", "cuda", "torch", "bh")}
COLLISION_BACKENDS = {"jax": ("auto", "pallas", "xla"),
                      "torch": ("auto", "cuda", "torch")}


def test_config_fields_and_defaults_match_jax():
    jax_fields = {f.name: f.default for f in dataclasses.fields(nb.SimConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(nt.SimConfig)}
    assert set(jax_fields) - set(port_fields) == DROPPED_FIELDS
    assert set(port_fields) <= set(jax_fields)
    assert [k for k in jax_fields if k in port_fields] == list(port_fields)
    for name, default in port_fields.items():
        if name == "dtype":
            assert (jax_fields[name], default) == DTYPE
        else:
            assert default == jax_fields[name], name
    jc, tc = nb.SimConfig(), nt.SimConfig()
    assert (tc.eps_sq, tc.soft_boundary) == (jc.eps_sq, jc.soft_boundary)


@pytest.mark.parametrize("field,values", [
    ("force_backend", FORCE_BACKENDS),
    ("collision_backend", COLLISION_BACKENDS),
])
def test_config_backend_names(field, values):
    for v in values["jax"]:
        nb.SimConfig(**{field: v})
    for v in values["torch"]:
        nt.SimConfig(**{field: v})
    for v in set(values["jax"]) - set(values["torch"]):
        with pytest.raises(ValueError):
            nt.SimConfig(**{field: v})


@pytest.mark.parametrize("kw", [
    {"dim": 5}, {"integrator": "rk4"}, {"collision_broad_phase": "tree"},
    {"collision_block_size": 300},
])
def test_config_rejects_what_jax_rejects(kw):
    with pytest.raises(ValueError):
        nb.SimConfig(**kw)
    with pytest.raises(ValueError):
        nt.SimConfig(**kw)


def test_state_numpy_round_trip():
    rng = np.random.default_rng(0)
    arrays = {
        "pos": rng.normal(size=(7, 3)).astype(np.float32),
        "vel": rng.normal(size=(7, 3)).astype(np.float32),
        "acc": rng.normal(size=(7, 3)).astype(np.float32),
        "mass": rng.uniform(1, 2, 7).astype(np.float32),
        "radius": rng.uniform(1, 2, 7).astype(np.float32),
        "frame": np.int32(12),
    }
    state = nt.ParticleState.from_numpy(arrays, CPU)
    assert (state.n, state.dim, state.frame.dtype) == (7, 3, torch.int32)
    bad = dict(arrays, mass=arrays["mass"][:6])
    with pytest.raises(ValueError, match="mass"):
        nt.ParticleState.from_numpy(bad, CPU)
    back = state.to_numpy()
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == np.asarray(v).dtype, k


def test_state_loads_jax_checkpoint(tmp_path):
    cfg = nb.SimConfig(n=64, force_backend="xla")
    jstate = nb.Simulation(cfg, scene="uniform_disc").run(3)
    path = save_checkpoint(str(tmp_path / "ckpt"), jstate, cfg)
    with np.load(path) as z:
        state = nt.ParticleState.from_numpy(dict(z), CPU)
    for k, v in jax_arrays(jstate).items():
        np.testing.assert_array_equal(as_np(getattr(state, k)), v)
    assert int(state.frame) == 3


def test_state_create_matches_jax():
    rng = np.random.default_rng(1)
    pos, vel = rng.normal(size=(2, 5, 2)).astype(np.float32)
    mass = rng.uniform(0.5, 30.0, 5).astype(np.float32)
    js = nb.ParticleState.create(pos, vel, mass)
    ts = nt.ParticleState.create(torch.from_numpy(pos), torch.from_numpy(vel),
                                 torch.from_numpy(mass))
    for k, v in jax_arrays(js).items():
        np.testing.assert_allclose(as_np(getattr(ts, k)), v, rtol=1e-6)


# -- what is not ported raises, before any pair work ---------------------------

def test_cuda_backend_on_cpu_tensor_raises():
    with pytest.raises(ValueError, match="CUDA"):
        resolve_backend(nt.SimConfig(force_backend="cuda"), 16, 2, CPU)
    with pytest.raises(ValueError, match="CUDA"):
        tcoll.resolve_collision_backend(
            nt.SimConfig(collision_backend="cuda"), CPU)
    state = nt.init_scene("kepler", nt.SimConfig(n=2), device=CPU)
    with pytest.raises(ValueError, match="CUDA"):
        nt.Simulation(nt.SimConfig(n=2, force_backend="cuda"), state=state,
                      device=CPU)


@pytest.mark.parametrize("cfg,n_bodies,dim", [
    ({"force_backend": "bh"}, 1000, 2),
    ({}, 100_000, 2),
    ({}, 100_000, 3),
])
def test_tree_code_raises_not_implemented(cfg, n_bodies, dim):
    """The tree code is ported in 2D and 3D and resolves to "bh"; the
    deep-overflow chain runs in both (finite forces)."""
    config = nt.SimConfig(dim=dim, **cfg)
    assert resolve_backend(config, n_bodies, dim, CPU) == "bh"
    deep = config.replace(force_backend="bh", bh_deep_levels=-1)
    pos = torch.rand(16, dim, generator=torch.Generator().manual_seed(dim))
    acc = nt.compute_accelerations(pos, torch.ones(16), deep)
    assert acc.shape == (16, dim) and bool(torch.isfinite(acc).all())


def test_explicit_exact_backends_run_at_any_n():
    assert resolve_backend(nt.SimConfig(force_backend="torch"),
                           200_000, 2, CPU) == "torch"
    assert resolve_backend(nt.SimConfig(force_backend="cuda"), 200_000, 2,
                           torch.device("cuda")) == "cuda"


def _forbid_pair_work(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("pair work started")

    monkeypatch.setattr(tcoll, "collision_deltas_plain", boom)
    monkeypatch.setattr(tcoll, "allpairs_collision_deltas", boom)


@pytest.mark.parametrize("phase", ["auto", "bucket", "hash", "block"])
def test_large_n_and_other_broad_phases_raise_first(monkeypatch, phase):
    """'hash' (the sorted spatial hash, ROADMAP item 11) raises before any
    pair work; 'auto' past N = 65,536, 'bucket' and 'block' are ported and
    resolve to their passes (the 70,000 bodies at one point overflow the
    bucket grid, so 'auto' switches to the block pass)."""
    _forbid_pair_work(monkeypatch)
    n_bodies = 70_000 if phase == "auto" else 64
    state = nt.ParticleState.create(
        torch.zeros(n_bodies, 2), torch.zeros(n_bodies, 2),
        torch.ones(n_bodies))
    # A 16^2 bucket grid keeps the 'bucket' case's stencil small on the CPU.
    cfg = nt.SimConfig(n=n_bodies, collision_broad_phase=phase,
                       collision_grid_res=16)
    if phase == "hash":
        with pytest.raises(NotImplementedError, match="item 11"):
            tcoll.resolve_collisions(state, cfg)
        with pytest.raises(NotImplementedError, match="item 11"):
            tcoll.resolve_collision_phase_for_state(state, cfg)
        with pytest.raises(NotImplementedError, match="item 11"):
            nt.Simulation(cfg, state=state, device=CPU)
        return
    if phase == "auto":
        assert tcoll._broad_phase(state, cfg) == "bucket"
        with pytest.warns(RuntimeWarning):   # the switch, then the overflow
            sim = nt.Simulation(cfg, state=state, device=CPU)
        assert (sim.config.collision_broad_phase,
                sim.config.collision_cell_size) == ("block", 0.0)
        assert tcoll._broad_phase(state, sim.config) == "block"
        return
    resolved = tcoll.resolve_collision_phase_for_state(state, cfg)
    assert resolved is cfg
    assert tcoll._broad_phase(state, resolved) == phase
    # Coincident bodies at rest: every pair is a no-op.
    out = tcoll.resolve_collisions(state, cfg)
    assert torch.equal(out.pos, state.pos) and torch.equal(out.vel, state.vel)


def test_scene_errors():
    with pytest.raises(KeyError, match="uniform_disc"):
        nt.init_scene("nope", nt.SimConfig(), device=CPU)
    for name in ("spiral", "kuzmin"):
        assert name in nt.scenes.SCENES
        with pytest.raises(NotImplementedError):
            nt.init_scene(name, nt.SimConfig(n=64), device=CPU)
    for name in ("galaxy_merger", "plummer"):
        assert nt.init_scene(name, nt.SimConfig(n=64), device=CPU).n == 64


def test_package_imports_no_jax():
    """The port must run where JAX is absent: import it with jax and the JAX
    package blocked, and run two steps at N=64 on the CPU."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['nbodysim_tpu'] = None\n"
        "import torch\n"
        "import nbodysim_tpu_torch as nt\n"
        "sim = nt.Simulation(nt.SimConfig(n=64), device='cpu')\n"
        "sim.run(2)\n"
        "assert sim.frame == 2\n"
        "assert bool(torch.isfinite(sim.state.pos).all())\n"
        "loaded = [m for m, v in sys.modules.items() if v is not None and "
        "(m.startswith('jax') or m.startswith('nbodysim_tpu.'))]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_entry_points_default_to_the_card():
    """Simulation, init_scene and every scene constructor reached through it
    take device="cuda" unless the caller passes another (read from the
    signatures: nothing here touches a GPU); device="cpu" still builds on
    the CPU."""
    import inspect

    from nbodysim_tpu_torch.scenes import SCENES, init_scene

    ported = [fn for name, fn in SCENES.items()
              if name not in ("spiral", "kuzmin")]
    for fn in (nt.Simulation.__init__, init_scene, *ported):
        param = inspect.signature(fn).parameters["device"]
        assert param.default == "cuda", fn
        assert param.kind is inspect.Parameter.KEYWORD_ONLY, fn
    state = init_scene("uniform_disc", nt.SimConfig(n=64), device="cpu")
    assert state.pos.device == CPU
    sim = nt.Simulation(nt.SimConfig(n=64), device="cpu")
    assert sim.state.pos.device == CPU and sim.device == CPU
