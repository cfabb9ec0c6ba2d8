"""Checkpoints of the port's training path: port of ``repro.checkpoint``
(``restore`` onto one device, ``restore_sharded`` onto a mesh)."""
from repro_torch.checkpoint.store import (AsyncCheckpointer, latest_step,
                                          load_checkpoint, restore,
                                          restore_sharded, save_checkpoint)

__all__ = ["AsyncCheckpointer", "latest_step", "load_checkpoint", "restore",
           "restore_sharded", "save_checkpoint"]
