"""Times the collision layer: consecutive calls of
`nbodysim_tpu_torch.physics.collisions.resolve_collisions` on the window's
last state under the resolved config, between CUDA events. Mean ms; None
where the cell runs without collisions."""

from probes import timing


def measure(ctx):
    from nbodysim_tpu_torch.physics.collisions import resolve_collisions

    st, cfg = ctx.sim_state, ctx.config
    if not cfg.enable_collisions:
        return None
    return timing.device_ms(lambda: resolve_collisions(st, cfg))
