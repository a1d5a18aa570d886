"""PyTorch port, the renderer, its overlays and the frame/video writers
(`render/splat.py`, `render/overlays.py`, `render/video.py`) against the
JAX package's, on the CPU.

Tolerances: `star_colors` exactly; `_black_hole_layer` on a float frame
within 1e-4 relative (XLA's and torch's tan, atan2 and pow differ in the
last bits); whole uint8 frames at 160 x 120 every pixel within 1 except at
most 0.1% of them (a pixel on the disk's 2.1R / 10.51R edge or on a
clipped tan spike can flip its branch; the scatter-add's order can move
the truncating uint8 cast by 1). Measured here: 0 pixels differ, in every
mode."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbodysim_tpu as nb
import nbodysim_tpu_torch as nt
from nbodysim_tpu.render import overlays as joverlays
from nbodysim_tpu.render import splat as jsplat
from nbodysim_tpu_torch.physics.integrators import make_rollout
from nbodysim_tpu_torch.render import overlays as toverlays
from nbodysim_tpu_torch.render import splat as tsplat
from nbodysim_tpu_torch.render.video import (
    AsyncFrameWriter, StreamingVideoWriter, render_rollout, save_frames,
    save_png, save_video)

from _torch_helpers import CPU, as_np, as_t, to_port


@pytest.fixture(scope="module")
def disc():
    """The JAX package's N=512 disc, and the same state in the port."""
    js = nb.init_scene("uniform_disc", nb.SimConfig(n=512,
                                                    force_backend="xla"))
    return js, to_port(js)


def test_star_colors_match_jax():
    mass = np.array([0.01, 0.08, 0.5, 0.8, 2.0, 2.5, 3.0, 30.0, 50.0,
                     100.0, 1e9], np.float32)
    for brightness in (1.0, 3.0):
        want = np.asarray(jsplat.star_colors(jnp.asarray(mass), brightness))
        got = as_np(tsplat.star_colors(as_t(mass), brightness))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(as_np(tsplat.star_colors(as_t(mass)))[0],
                                  [0, 0, 255])


@pytest.mark.parametrize("center, radius", [((200.0, 200.0), 12.0),
                                            ((137.3, 251.8), 7.3),
                                            ((-40.0, 90.0), 30.0)])
def test_black_hole_layer_matches_jax(center, radius):
    base = np.random.default_rng(0).uniform(0, 120, (300, 400, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(jsplat._black_hole_layer,
                              static_argnums=(3, 4))(
        jnp.asarray(base), jnp.asarray(center, jnp.float32),
        jnp.asarray(radius, jnp.float32), 400, 300))
    got = as_np(tsplat._black_hole_layer(
        as_t(base), torch.tensor(center), torch.tensor(radius), 400, 300))
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert rel.max() <= 1e-4


def test_black_hole_composite_structure():
    """The reference's drawBlackHole stack: black horizon, opaque photon
    ring at R, angularly asymmetric accretion disk (mirrors
    tests/test_overlays_profiling.py)."""
    base = torch.full((400, 400, 3), 60.0)
    out = as_np(torch.clamp(tsplat._black_hole_layer(
        base, torch.tensor([200.0, 200.0]), torch.tensor(12.0), 400, 400),
        0, 255).to(torch.uint8))
    assert (out[200, 195:199] == 0).all()
    assert tuple(out[200, 188]) == (255, 225, 210)
    left, right = out[200, 140].astype(int), out[200, 260].astype(int)
    assert left[2] > left[1] and right.sum() != left.sum()
    assert [round(a * 255) for _, a in tsplat._BH_GLOW_LAYERS] == [
        0, 70, 140, 210, 24]


MODES = {
    "normal": dict(scale=0.01),
    "performance": dict(scale=0.01, performance_mode=True),
    "quadtree": dict(scale=0.01, show_quadtree=True),
    "connections_far": dict(scale=0.005, show_connections=True),
    "connections_near": dict(scale=0.5, show_connections=True),
    "both_overlays": dict(scale=0.02, show_connections=True,
                          show_quadtree=True),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_frames_match_jax(disc, mode):
    js, ts = disc
    kw = dict(width=160, height=120, **MODES[mode])
    want = np.asarray(jax.jit(jsplat.render_frame, static_argnums=1)(
        js, jsplat.RenderConfig(**kw)))
    got = tsplat.render_frame(ts, tsplat.RenderConfig(**kw))
    assert got.dtype == torch.uint8 and got.device == CPU
    got = as_np(got)
    assert got.shape == want.shape == (120, 160, 3)
    assert want.max() > 0
    off = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert (off > 1).sum() <= 0.001 * off.size


def test_connections_zoom_modes(disc):
    """Far out the overlay draws salmon cluster segments, zoomed in pure
    red per-body lines (mirrors tests/test_overlays_profiling.py)."""
    _, ts = disc
    base = torch.zeros((200, 200, 3), dtype=torch.uint8)
    far = as_np(toverlays.connections_overlay(base, ts, 0.005, (0.0, 0.0)))
    lit = far.sum(-1) > 0
    r, g, b = (far[..., i][lit].astype(int) for i in range(3))
    assert lit.any() and (r >= g).all() and (g > b).all()
    near = as_np(toverlays.connections_overlay(base, ts, 0.5, (0.0, 0.0)))
    lit = near.sum(-1) > 0
    assert lit.any() and (near[..., 1][lit] == 0).all()


def test_async_frame_writer_order_and_completion():
    import time

    got = []

    def slow_sink(i, frame):
        time.sleep(0.002)
        got.append((i, int(frame.sum())))

    w = AsyncFrameWriter(slow_sink, maxsize=2)
    for i in range(20):
        w.submit(i, torch.full((4, 4), i, dtype=torch.uint8))
    w.close()
    assert got == [(i, i * 16) for i in range(20)]


def test_async_frame_writer_propagates_sink_errors():
    def bad_sink(i, frame):
        raise RuntimeError("disk full")

    w = AsyncFrameWriter(bad_sink, maxsize=1)
    with pytest.raises(RuntimeError, match="disk full"):
        for i in range(50):
            w.submit(i, np.zeros((2, 2), np.uint8))
        w.close()


@pytest.mark.parametrize("suffix", [".mp4", ".gif"])
def test_streaming_video_writer(tmp_path, suffix):
    sink = StreamingVideoWriter(str(tmp_path / f"clip{suffix}"), fps=10)
    for i in range(3):
        sink(i, torch.full((16, 16, 3), i * 40, dtype=torch.uint8))
    out = sink.finish()
    assert out == str(tmp_path / f"clip{suffix}")
    assert os.path.getsize(out) > 0
    with pytest.raises(ValueError, match="no frames"):
        StreamingVideoWriter(str(tmp_path / f"empty{suffix}")).finish()


@pytest.mark.parametrize("suffix", [".mp4", ".gif"])
def test_save_video_and_frames(tmp_path, suffix):
    frames = [np.full((16, 16, 3), i * 60, np.uint8) for i in range(3)]
    assert save_video(frames, str(tmp_path / f"v{suffix}"), fps=5).endswith(
        suffix)
    paths = save_frames(frames, str(tmp_path / "pngs"))
    assert [os.path.basename(p) for p in paths] == [
        "frame_00000.png", "frame_00001.png", "frame_00002.png"]
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(paths[2])),
                                  frames[2])
    with pytest.raises(ValueError, match="no frames"):
        save_video([], str(tmp_path / f"none{suffix}"))


def test_render_rollout_double_buffer_matches_sequential():
    """render_rollout's double buffer yields exactly the frames of the
    plain render-then-step loop, and the JAX package's frames of the same
    initial state."""
    cfg = nt.SimConfig(n=64, enable_collisions=False, force_backend="torch")
    state = nt.init_scene("plummer", cfg, device=CPU)
    rc = tsplat.RenderConfig(width=32, height=32)
    frames = list(render_rollout(state, cfg, 3, 2, rc, device=CPU))
    rollout = make_rollout(cfg, 2)
    s = state
    for i in range(3):
        np.testing.assert_array_equal(
            frames[i], as_np(tsplat.render_frame(s, rc, cfg)))
        s = rollout(s)
    jstate = nb.ParticleState(**{k: jnp.asarray(v) for k, v in
                                 state.to_numpy().items()})
    want = np.asarray(jax.jit(jsplat.render_frame, static_argnums=1)(
        jstate, jsplat.RenderConfig(width=32, height=32)))
    assert np.abs(frames[0].astype(int) - want.astype(int)).max() <= 1
    seen = []
    list(render_rollout(state, cfg, 2, 1, rc, device=CPU,
                        on_frame=lambda i, f: seen.append(i)))
    assert seen == [0, 1]


def test_save_png_roundtrip(tmp_path):
    frame = torch.randint(0, 256, (12, 20, 3), dtype=torch.uint8)
    path = save_png(frame, str(tmp_path / "a" / "f.png"))
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(path)), as_np(frame))
