"""Training substrate: optimizer, step factory, data, checkpointing.

Counterpart of ``repro/train`` on the port's tensor trees. ``abstract_state``,
``state_pspecs`` and ``batch_pspecs`` are not here yet: they belong to the
distributed slice.
"""
from .checkpoint import CheckpointManager, latest_step, restore_checkpoint, save_checkpoint
from .data import SyntheticData
from .loop import init_state, make_train_step, schedule_for
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
