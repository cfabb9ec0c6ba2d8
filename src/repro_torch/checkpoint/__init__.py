"""Checkpoints of the port's training path: port of ``repro.checkpoint``
(``restore`` the one-device form of its ``restore_sharded``)."""
from repro_torch.checkpoint.store import (AsyncCheckpointer, latest_step,
                                          load_checkpoint, restore,
                                          save_checkpoint)

__all__ = ["AsyncCheckpointer", "latest_step", "load_checkpoint", "restore",
           "save_checkpoint"]
