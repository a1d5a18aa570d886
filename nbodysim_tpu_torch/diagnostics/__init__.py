"""Diagnostics (`metrics`) and profiling (`profiling`).

The metrics' names load on first use: the physics imports `profiling` for
its spans, and `metrics` imports the physics.
"""

__all__ = ["diagnostics", "system_metrics", "EnergyTracker"]


def __getattr__(name):
    if name in __all__:
        from nbodysim_tpu_torch.diagnostics import metrics

        return getattr(metrics, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
