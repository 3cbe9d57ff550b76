"""Checkpoints of the port, in the reference's on-disk format
(``repro.checkpoint``): either package restores the other's."""
from .ckpt import (async_save, latest_step, restore_checkpoint,  # noqa: F401
                   save_checkpoint, wait_for_save)
