"""PyTorch port, checkpoints and the CLI (`io/checkpoint.py`, `cli.py`)
against the JAX package's, on the CPU.

One checkpoint format serves both packages: each loads what the other
wrote (the config's backend names mapped, "cuda" <-> "pallas" and "torch"
<-> "xla"; JAX's `pallas_interpret` dropped by the port's loader), and a
resumed run ends bit for bit where the uninterrupted one does, also after
a SIGKILL of a `python -m nbodysim_tpu_torch.cli` process. Runs started
from one JAX checkpoint agree within rtol 1e-4 after 4 steps (the port's
plain torch sums against XLA's)."""

import glob
import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

import nbodysim_tpu as nb
import nbodysim_tpu_torch as nt
from nbodysim_tpu.cli import main as jax_main
from nbodysim_tpu.io.checkpoint import (
    load_checkpoint as jax_load, save_checkpoint as jax_save)
from nbodysim_tpu_torch.cli import main, read_control_file
from nbodysim_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from nbodysim_tpu_torch.physics.integrators import make_step

from _torch_helpers import CPU, as_np, jax_arrays, to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("pos", "vel", "acc", "mass", "radius", "frame")


def _run(argv):
    main(argv + ["--device", "cpu"])


def test_checkpoint_roundtrip(tmp_path):
    cfg = nt.SimConfig(n=64, force_backend="torch", collision_backend="cuda")
    state = nt.init_scene("plummer", cfg, device=CPU)
    path = save_checkpoint(str(tmp_path / "ck"), state, cfg)
    assert path.endswith("ck.npz")
    loaded, cfg2 = load_checkpoint(path, device=CPU)
    for k in FIELDS:
        assert torch.equal(getattr(loaded, k), getattr(state, k)), k
    assert cfg2 == cfg


def test_port_loads_a_jax_checkpoint(tmp_path):
    jcfg = nb.SimConfig(n=64, force_backend="pallas", collision_backend="xla",
                        pallas_interpret=True, dt=0.02, seed=5)
    jstate = nb.init_scene("plummer", jcfg)
    path = jax_save(str(tmp_path / "jax.npz"), jstate, jcfg)
    state, cfg = load_checkpoint(path, device=CPU)
    want = jax_arrays(jstate)
    for k in FIELDS:
        np.testing.assert_array_equal(as_np(getattr(state, k)), want[k])
    assert (cfg.force_backend, cfg.collision_backend) == ("cuda", "torch")
    assert (cfg.n, cfg.dt, cfg.seed, cfg.dtype) == (64, 0.02, 5,
                                                   torch.float32)


def test_jax_loads_a_port_checkpoint(tmp_path):
    cfg = nt.SimConfig(n=64, force_backend="cuda", collision_backend="torch",
                       collision_broad_phase="hash", dim=3, softening=2.5)
    state = nt.init_scene("plummer", cfg, device=CPU)
    path = save_checkpoint(str(tmp_path / "port.npz"), state, cfg)
    jstate, jcfg = jax_load(path)
    got = jax_arrays(jstate)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], as_np(getattr(state, k)))
    assert (jcfg.force_backend, jcfg.collision_backend) == ("pallas", "xla")
    for name in ("n", "dim", "collision_broad_phase", "softening", "dt"):
        assert getattr(jcfg, name) == getattr(cfg, name), name
    assert jcfg.pallas_interpret is False


def test_checkpoint_deterministic_resume(tmp_path):
    """save -> load -> step equals step without interruption."""
    cfg = nt.SimConfig(n=64, force_backend="torch")
    state = nt.init_scene("uniform_disc", cfg, device=CPU)
    step = make_step(cfg)
    mid = step(step(state))
    resumed, _ = load_checkpoint(
        save_checkpoint(str(tmp_path / "mid.npz"), mid, cfg), device=CPU)
    a, b = step(mid), step(resumed)
    assert torch.equal(a.pos, b.pos) and torch.equal(a.vel, b.vel)
    assert int(a.frame) == int(b.frame) == 3


def test_load_checkpoint_defaults_to_the_card(tmp_path):
    cfg = nt.SimConfig(n=16)
    path = save_checkpoint(str(tmp_path / "c.npz"),
                           nt.init_scene("plummer", cfg, device=CPU), cfg)
    if torch.cuda.is_available():
        assert load_checkpoint(path)[0].pos.is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            load_checkpoint(path)


def test_cli_run_and_resume(tmp_path, capsys):
    ckdir = str(tmp_path / "ck")
    _run(["run", "--scene", "plummer", "--n", "64", "--steps", "6",
          "--log-every", "3", "--backend", "torch",
          "--checkpoint-dir", ckdir])
    out = capsys.readouterr().out
    assert "frame       6" in out and "ckpt_final.npz" in out
    _run(["run", "--resume", f"{ckdir}/ckpt_final.npz", "--steps", "9",
          "--log-every", "3"])
    out = capsys.readouterr().out
    assert "resumed" in out and "frame       9" in out


def test_cli_resumes_a_jax_run_as_jax_does(tmp_path):
    """JAX's CLI writes a checkpoint at step 4; both CLIs resume it to step
    8 (the port maps the saved 'xla' to 'torch') and agree."""
    jax_main(["run", "--scene", "plummer", "--n", "64", "--steps", "4",
              "--log-every", "2", "--backend", "xla",
              "--checkpoint-dir", str(tmp_path / "a")])
    start = str(tmp_path / "a" / "ckpt_final.npz")
    jax_main(["run", "--resume", start, "--steps", "8", "--log-every", "2",
              "--checkpoint-dir", str(tmp_path / "j")])
    _run(["run", "--resume", start, "--steps", "8", "--log-every", "2",
          "--checkpoint-dir", str(tmp_path / "t")])
    want, _ = jax_load(str(tmp_path / "j" / "ckpt_final.npz"))
    got, cfg = load_checkpoint(str(tmp_path / "t" / "ckpt_final.npz"),
                               device=CPU)
    assert cfg.force_backend == "torch" and int(got.frame) == 8
    for k in ("pos", "vel"):
        ref = np.asarray(getattr(want, k))
        np.testing.assert_allclose(as_np(getattr(got, k)), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())


def test_cli_crash_sigkill_resume_bitwise(tmp_path):
    """A `python -m nbodysim_tpu_torch.cli run` process is SIGKILLed after
    its first checkpoint; the run resumed from its newest checkpoint for 8
    more steps ends bit for bit where a run never interrupted ends (mirrors
    tests/test_crash_resume.py)."""
    every = 4
    ckdir = str(tmp_path / "ck")
    os.makedirs(ckdir)
    env = dict(os.environ, PYTHONPATH=REPO)
    child = subprocess.Popen(
        [sys.executable, "-m", "nbodysim_tpu_torch.cli", "run", "--scene",
         "uniform_disc", "--n", "64", "--backend", "torch", "--steps",
         "100000", "--log-every", "2", "--checkpoint-every", str(every),
         "--checkpoint-dir", ckdir, "--device", "cpu"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, cwd=REPO,
        env=env)
    try:
        deadline = time.time() + 300
        ckpts = []
        while time.time() < deadline:
            if child.poll() is not None:
                pytest.fail(f"child exited early: rc={child.returncode}")
            ckpts = sorted(glob.glob(f"{ckdir}/ckpt_*.npz"))
            if ckpts:
                break
            time.sleep(0.25)
        assert ckpts, "child never produced a checkpoint"
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=30)
    finally:
        if child.poll() is None:
            child.kill()
    # The newest checkpoint may be mid-write when the kill lands: take the
    # newest that loads.
    for latest in sorted(glob.glob(f"{ckdir}/ckpt_*.npz"), reverse=True):
        try:
            load_checkpoint(latest, device=CPU)
            break
        except Exception:
            continue
    frame = int(os.path.basename(latest)[5:-4])
    assert frame % every == 0 and frame >= every
    total = frame + 8   # the child may have run far past its first one
    _run(["run", "--resume", latest, "--steps", str(total),
          "--log-every", "2", "--checkpoint-dir", str(tmp_path / "res")])
    _run(["run", "--scene", "uniform_disc", "--n", "64", "--backend",
          "torch", "--steps", str(total), "--log-every", "2",
          "--checkpoint-dir", str(tmp_path / "ref")])
    got, _ = load_checkpoint(str(tmp_path / "res" / "ckpt_final.npz"),
                             device=CPU)
    want, _ = load_checkpoint(str(tmp_path / "ref" / "ckpt_final.npz"),
                              device=CPU)
    assert int(got.frame) == int(want.frame) == total
    assert torch.equal(got.pos, want.pos) and torch.equal(got.vel, want.vel)


def test_control_file_parsing(tmp_path):
    f = tmp_path / "ctl"
    assert read_control_file(str(f)) == {}
    f.write_text("# retune\n dt = 0.005 \npause=0\nstop=1\njunk\nx=1\n")
    assert read_control_file(str(f)) == {"dt": 0.005, "pause": False,
                                         "stop": True}


@pytest.mark.parametrize("dt, shown", [("0.002", "control: dt -> 0.002"),
                                       ("5.0", "control: dt -> 0.1")])
def test_control_dt_applies_clamped(tmp_path, capsys, dt, shown):
    """--control dt takes effect, clamped to the reference slider range
    [0.001, 0.1] (main.cpp:865-893) with the clamp surfaced."""
    ctl = tmp_path / "ctl"
    ctl.write_text(f"dt={dt}\n")
    _run(["run", "--scene", "plummer", "--n", "32", "--steps", "20",
          "--log-every", "10", "--backend", "torch", "--control", str(ctl)])
    out = capsys.readouterr().out
    assert shown in out
    assert ("outside the reference slider range" in out) == (dt == "5.0")


def test_control_pause_then_stop(tmp_path, capsys):
    """A run paused by the control file takes no step and waits until the
    file says stop."""
    ctl = tmp_path / "ctl"
    ctl.write_text("pause=1\n")
    timer = threading.Timer(0.6, lambda: ctl.write_text("pause=1\nstop=1\n"))
    timer.start()
    t0 = time.perf_counter()
    try:
        _run(["run", "--scene", "plummer", "--n", "32", "--steps", "500",
              "--log-every", "10", "--backend", "torch", "--control",
              str(ctl)])
    finally:
        timer.cancel()
    assert time.perf_counter() - t0 >= 0.5
    out = capsys.readouterr().out
    assert "control: stop at frame 0" in out and "frame      10" not in out


def test_cli_bad_set_key():
    with pytest.raises(SystemExit, match="warp"):
        _run(["run", "--steps", "1", "--set", "warp=9"])
    with pytest.raises(SystemExit, match="softening"):
        _run(["run", "--steps", "1", "--set", "eps_sq=9"])


def test_cli_needs_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    for argv in (["info"], ["run", "--steps", "1"], ["bench", "--config",
                                                     "1"]):
        with pytest.raises(SystemExit, match="cuda"):
            main(argv)


def test_cli_render_pngs(tmp_path):
    out_dir = str(tmp_path / "frames")
    _run(["render", "--scene", "plummer", "--n", "64", "--backend", "torch",
          "--frames", "2", "--steps-per-frame", "2", "--width", "64",
          "--height", "64", "--out", out_dir])
    assert os.path.exists(f"{out_dir}/frame_00000.png")
    assert os.path.exists(f"{out_dir}/frame_00001.png")


def test_cli_info(capsys):
    _run(["info", "--n", "128", "--set", "theta=0.5"])
    out = capsys.readouterr().out
    assert "device: cpu" in out
    cfg = json.loads(out[out.index("{"):])
    assert cfg["n"] == "128" and cfg["theta"] == "0.5"


def test_cli_bench_config1_matches_jax(capsys):
    """`bench --config 1` (the Kepler orbit's phase error after one
    period) prints the device line, then the preset's line, and lands
    within 10% of the JAX package's value for the same preset."""
    import bench as jax_bench

    main(["bench", "--config", "1", "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["device"] == "cpu"
    got = lines[1]
    assert got["metric"] == "config1 Kepler phase error after 1 period"
    want = jax_bench._bench_baseline_config(1)
    assert got["value"] == pytest.approx(want["value"], rel=0.1)
