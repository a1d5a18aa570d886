from nbodysim_tpu_torch.io.checkpoint import (
    load_checkpoint, load_checkpoint_sharded, save_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "load_checkpoint_sharded"]
