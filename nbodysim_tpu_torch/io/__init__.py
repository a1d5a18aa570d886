from nbodysim_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint"]
