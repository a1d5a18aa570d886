"""Times the viewer's render: `render_frame(state, the viewer's
RenderConfig)` and its copy to the host, on the host's clock (the copy
synchronises). Mean ms; None outside the viewer."""

from probes import timing


def measure(ctx):
    from nbodysim_tpu_torch.render.splat import render_frame

    if ctx.viewer is None:
        return None
    st, rc = ctx.sim_state, ctx.viewer.rc
    return timing.host_ms(lambda: render_frame(st, rc).cpu())
