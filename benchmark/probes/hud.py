"""Times the viewer's HUD: `Viewer.hud_text()` on the window's last state
(its `diagnostics`, read back to format the energy), on the host's clock.
Mean ms; None outside the viewer."""

from probes import timing


def measure(ctx):
    if ctx.viewer is None:
        return None
    return timing.host_ms(ctx.viewer.hud_text)
