"""The one place the harness reaches the measured program (``repro_torch``):
its configuration record, built from the benchmark's configuration file."""
from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["port_config", "sync_fn"]


def port_config(c: Dict):
    """The program's ``ArchConfig`` of ``c["arch"]`` with every field that the
    configuration file states set from it, so the file is what runs."""
    from repro_torch.configs import get_config

    base = get_config(c["arch"])
    names = {f.name for f in dataclasses.fields(base)} - {"name", "source"}
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in c.items() if k in names}
    return dataclasses.replace(base, **kw)


def sync_fn(device):
    """A function that waits for the device (nothing on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None
