from nbodysim_tpu_torch.diagnostics.metrics import (
    EnergyTracker, diagnostics, system_metrics)

__all__ = ["diagnostics", "system_metrics", "EnergyTracker"]
