"""Times the force layer: consecutive calls of
`nbodysim_tpu_torch.physics.forces.compute_accelerations` on the window's
last state under the resolved config, between CUDA events. Mean ms."""

from probes import timing


def measure(ctx):
    from nbodysim_tpu_torch.physics.forces import compute_accelerations

    st, cfg = ctx.sim_state, ctx.config
    return timing.device_ms(lambda: compute_accelerations(st.pos, st.mass,
                                                          cfg))
