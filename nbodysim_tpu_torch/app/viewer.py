"""Interactive viewer (port of `nbodysim_tpu.app.viewer`): the reference's
raylib window, on matplotlib.

It mirrors the reference's key map (main.cpp:674-724):

  Space  pause/resume            q  quadtree overlay
  c      connections overlay     v  hide bodies
  p      performance mode        t / y  dt x1.5 / x0.666
  w a s d  pan                   r / f  zoom in/out

Frames are rendered on the simulation's device (render/splat.py); the
window receives only uint8 RGB arrays. matplotlib is imported only by
`build_animation` and `show`.
"""

from __future__ import annotations

import time

import numpy as np

from nbodysim_tpu_torch.api import DT_MAX, DT_MIN, Simulation
from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.diagnostics import profiling
from nbodysim_tpu_torch.render.splat import RenderConfig, render_frame


class Viewer:
    def __init__(
        self,
        config: SimConfig | None = None,
        scene: str = "uniform_disc",
        render_config: RenderConfig | None = None,
        steps_per_frame: int = 5,
        *,
        device="cuda",
    ):
        self.sim = Simulation(config or SimConfig(), scene=scene,
                              device=device)
        self.rc = render_config or RenderConfig(scale=0.005, width=900,
                                                height=675)
        self.steps_per_frame = steps_per_frame
        self.paused = False
        self.show_bodies = True
        self._pan = np.array(self.rc.center, np.float64)

    # -- control handlers (reference key map) ---------------------------

    def on_key(self, key: str) -> None:
        rc = self.rc
        pan_step = 30.0 / rc.scale
        if key == " ":
            self.paused = not self.paused
        elif key == "q":
            self.rc = rc.replace(show_quadtree=not rc.show_quadtree)
        elif key == "c":
            self.rc = rc.replace(show_connections=not rc.show_connections)
        elif key == "v":
            self.show_bodies = not self.show_bodies
        elif key == "p":
            self.rc = rc.replace(performance_mode=not rc.performance_mode)
        elif key == "t":
            # The reference slider clamps dt to [0.001, 0.1]
            # (main.cpp:865-893); T/Y cannot push it outside.
            self.sim.set_dt(min(self.sim.dt * 1.5, DT_MAX))
        elif key == "y":
            self.sim.set_dt(max(self.sim.dt * 0.666, DT_MIN))
        elif key == "w":
            self._pan[1] -= pan_step
        elif key == "s":
            self._pan[1] += pan_step
        elif key == "a":
            self._pan[0] -= pan_step
        elif key == "d":
            self._pan[0] += pan_step
        elif key == "r":
            self.rc = rc.replace(scale=rc.scale * 1.25)
        elif key == "f":
            self.rc = rc.replace(scale=rc.scale * 0.8)
        self.rc = self.rc.replace(center=tuple(self._pan))

    def frame(self) -> np.ndarray:
        """Advance (unless paused) and return the next uint8 RGB frame (the
        render and its copy to the host: the span `render`)."""
        if not self.paused:
            self.sim.run(self.steps_per_frame)
        if not self.show_bodies:
            return np.zeros((self.rc.height, self.rc.width, 3), np.uint8)
        with profiling.span("render"):
            return render_frame(self.sim.state, self.rc).cpu().numpy()

    def hud_text(self) -> str:
        """The HUD line (the span `hud`)."""
        with profiling.span("hud"):
            d = self.sim.diagnostics()
            energy = profiling.host_read(d.total_energy, "hud_energy")
            # [MAX] mirrors the reference slider turning red at the dt
            # ceiling (main.cpp:889-893).
            at_max = " [MAX]" if self.sim.dt >= DT_MAX else ""
            return (
                f"bodies {self.sim.state.n} | frame {self.sim.frame} | "
                f"dt {self.sim.dt:.3f}{at_max} | E {energy:.3e} | "
                f"{'PAUSED' if self.paused else 'RUNNING'}"
            )

    # -- matplotlib loop ------------------------------------------------

    def build_animation(self, interval_ms: int = 33):
        """Build the figure and its FuncAnimation (apart from show(), so a
        test can drive the update headless under Agg). Returns (fig, anim,
        update): `update(i)` advances the simulation and blits."""
        import matplotlib.pyplot as plt
        from matplotlib.animation import FuncAnimation

        fig, ax = plt.subplots(figsize=(9, 7))
        if fig.canvas.manager is not None:
            fig.canvas.manager.set_window_title("N-Body Simulation")
        im = ax.imshow(self.frame())
        title = ax.set_title(self.hud_text(), fontsize=9)
        ax.set_axis_off()
        fig.canvas.mpl_connect(
            "key_press_event", lambda ev: self.on_key(ev.key or ""))
        last = [time.perf_counter()]

        def update(_):
            im.set_data(self.frame())
            title.set_text(self.hud_text())
            # Reference HUD colors (main.cpp:847-849): green >= 30 FPS,
            # orange >= 15, red below; PAUSED is red.
            now = time.perf_counter()
            fps = 1.0 / max(now - last[0], 1e-9)
            last[0] = now
            if self.paused:
                title.set_color("red")
            else:
                title.set_color("green" if fps >= 30
                                else "orange" if fps >= 15 else "red")
            return [im, title]

        anim = FuncAnimation(fig, update, interval=interval_ms,
                             cache_frame_data=False)
        return fig, anim, update

    def show(self, interval_ms: int = 33):
        """Open the interactive window (requires a display)."""
        import matplotlib.pyplot as plt

        _, anim, _ = self.build_animation(interval_ms)
        plt.show()
        return anim
