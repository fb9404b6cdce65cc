from repro_torch.ckpt.checkpoint import (FaultTolerantRunner, latest_step,
                                         restore_checkpoint, save_checkpoint)

__all__ = ["FaultTolerantRunner", "latest_step", "restore_checkpoint",
           "save_checkpoint"]
