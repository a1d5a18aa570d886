from nbodysim_tpu_torch.core.state import ParticleState

__all__ = ["ParticleState"]
