"""Frame and video output (port of `nbodysim_tpu.render.video`): PNG frames,
mp4 (OpenCV) and gif (imageio), on the host.

The device produces uint8 RGB frames (render/splat.py); this module moves
bytes to disk and pipelines the two sides, as the reference's sim/render
double buffer does (main.cpp:612-635): `render_rollout` enqueues the next
step chunk and its frame before it waits for the current frame's bytes,
and `AsyncFrameWriter` encodes on a helper thread behind a bounded queue.

PIL, cv2 and imageio are imported inside the functions that use them; a
missing one raises ImportError (the mp4 writers fall back to a gif where
cv2 cannot encode, as in the JAX package).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterable, Optional

import numpy as np
import torch


def _host(frame) -> np.ndarray:
    return frame.cpu().numpy() if torch.is_tensor(frame) else np.asarray(
        frame)


def save_png(frame, path: str) -> str:
    """Write one uint8 RGB frame to a PNG."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(_host(frame), "RGB").save(path)
    return path


def save_frames(frames: Iterable, out_dir: str, prefix: str = "frame") -> list:
    """Write a frame sequence as out_dir/prefix_%05d.png."""
    return [save_png(f, os.path.join(out_dir, f"{prefix}_{i:05d}.png"))
            for i, f in enumerate(frames)]


def save_video(frames: Iterable, path: str, fps: int = 30) -> str:
    """Encode frames to mp4 (OpenCV) or gif (imageio); an mp4 that cv2
    cannot write becomes a gif beside it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    frames = [_host(f) for f in frames]
    if not frames:
        raise ValueError("save_video: no frames to encode")
    if path.endswith(".gif"):
        import imageio

        imageio.mimsave(path, frames, fps=fps)
        return path
    try:
        import cv2

        h, w = frames[0].shape[:2]
        writer = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if not writer.isOpened():
            raise RuntimeError("cv2.VideoWriter failed to open")
        for f in frames:
            writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        writer.release()
        return path
    except Exception as e:
        import imageio

        gif = os.path.splitext(path)[0] + ".gif"
        imageio.mimsave(gif, frames, fps=fps)
        print(f"save_video: mp4 encoder unavailable ({e}); wrote {gif}")
        return gif


class AsyncFrameWriter:
    """Bounded helper-thread frame sink: `submit` hands a frame to a worker
    thread and returns as soon as a queue slot frees, so the producer is
    blocked on encoding only when it falls `maxsize` frames behind. A
    worker exception re-raises on the next `submit` or on `close`."""

    _DONE = object()

    def __init__(self, sink: Callable[[int, np.ndarray], None],
                 maxsize: int = 2):
        self._sink = sink
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._err: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is self._DONE:
                    return
                if self._err is None:
                    i, frame = item
                    self._sink(i, frame)
            except BaseException as e:  # noqa: BLE001 — surfaces encode errors
                self._err = e
            finally:
                self._q.task_done()

    def _check(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def submit(self, index: int, frame) -> None:
        self._check()
        self._q.put((index, _host(frame)))

    def close(self) -> None:
        """Flush the queue, join the worker, re-raise any encode error."""
        self._q.put(self._DONE)
        self._worker.join()
        self._check()


class StreamingVideoWriter:
    """Incremental mp4 writer (cv2); frames are held in memory only for a
    gif. Use as the sink of an AsyncFrameWriter to stream a long render to
    disk."""

    def __init__(self, path: str, fps: int = 30):
        self.path = path
        self.fps = fps
        self._cv2 = None
        self._writer = None
        self._gif_frames: Optional[list] = None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def __call__(self, index: int, frame) -> None:
        frame = _host(frame)
        if self.path.endswith(".gif") or self._gif_frames is not None:
            if self._gif_frames is None:
                self._gif_frames = []
            self._gif_frames.append(frame)
            return
        if self._writer is None:
            try:
                import cv2

                h, w = frame.shape[:2]
                self._writer = cv2.VideoWriter(
                    self.path, cv2.VideoWriter_fourcc(*"mp4v"), self.fps,
                    (w, h))
                if not self._writer.isOpened():
                    raise RuntimeError("cv2.VideoWriter failed to open")
                self._cv2 = cv2
            except Exception:
                self._writer = None
                self._gif_frames = [frame]
                return
        self._writer.write(self._cv2.cvtColor(frame, self._cv2.COLOR_RGB2BGR))

    def finish(self) -> str:
        if self._writer is not None:
            self._writer.release()
            return self.path
        if self._gif_frames is None:
            raise ValueError(
                "StreamingVideoWriter.finish: no frames were written")
        import imageio

        gif = (self.path if self.path.endswith(".gif")
               else os.path.splitext(self.path)[0] + ".gif")
        imageio.mimsave(gif, self._gif_frames, fps=self.fps)
        return gif


class _PendingFrame:
    """A frame on its way to the host. On a card: copied into pinned host
    memory with non_blocking=True and an event recorded behind the copy,
    so waiting for it does not wait for work queued after it."""

    def __init__(self, frame: torch.Tensor):
        if frame.is_cuda:
            self._host = torch.empty(frame.shape, dtype=frame.dtype,
                                     pin_memory=True)
            self._host.copy_(frame, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = frame, None

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def render_rollout(
    state,
    config,
    num_frames: int,
    steps_per_frame: int,
    render_config=None,
    on_frame: Optional[Callable[[int, np.ndarray], None]] = None,
    *,
    device="cuda",
):
    """Step the simulation on `device` (the card unless the caller asks for
    another) and yield rendered uint8 frames [H, W, 3] as numpy arrays.

    Double-buffered: chunk i+1 and its frame are enqueued before frame i's
    bytes are waited for, so the device steps while frame i crosses to the
    host and the caller encodes it. The probes are `Simulation`'s: 'auto'
    force and collision phases resolved from the state, leapfrog primed."""
    from nbodysim_tpu_torch.core.state import resolve_device
    from nbodysim_tpu_torch.physics.collisions import (
        resolve_collision_phase_for_state)
    from nbodysim_tpu_torch.physics.forces import resolve_config_for_state
    from nbodysim_tpu_torch.physics.integrators import (
        make_rollout, prime_accelerations)
    from nbodysim_tpu_torch.render.splat import render_frame

    state = state.to(resolve_device(device))
    config = resolve_config_for_state(state.pos, state.mass, config)
    config = resolve_collision_phase_for_state(state, config)
    if config.integrator == "leapfrog_kdk":
        state = prime_accelerations(state, config)
    rollout = make_rollout(config, steps_per_frame)
    pending = _PendingFrame(render_frame(state, render_config, config))
    for i in range(num_frames):
        nxt = None
        if i + 1 < num_frames:
            state = rollout(state)       # chunk i+1 enqueued
            nxt = _PendingFrame(render_frame(state, render_config, config))
        frame = pending.wait()           # waits on frame i's bytes only
        if on_frame is not None:
            on_frame(i, frame)
        yield frame
        pending = nxt
