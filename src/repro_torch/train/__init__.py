"""Training substrate: optimizer, step factory, data, checkpointing.

Counterpart of ``repro/train`` on the port's tensor trees, with the
sharded state's specs (``abstract_state``, ``state_pspecs``,
``batch_pspecs``) over a DeviceMesh.
"""
from .checkpoint import CheckpointManager, latest_step, restore_checkpoint, save_checkpoint
from .data import SyntheticData
from .loop import (abstract_state, batch_pspecs, init_state, make_train_step, schedule_for,
                   state_pspecs)
from .optim import adamw_init, adamw_update, cosine_schedule, wsd_schedule

__all__ = [
    "CheckpointManager",
    "SyntheticData",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "init_state",
    "latest_step",
    "make_train_step",
    "restore_checkpoint",
    "save_checkpoint",
    "schedule_for",
    "wsd_schedule",
]
