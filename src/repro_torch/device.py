"""Device resolution for every entry point of the port.

``resolve_device(None)`` means the card: it returns ``cuda`` and raises when
``torch.cuda.is_available()`` is False, so a run that asked for the GPU
never carries on silently on the CPU. The CPU is used only when the caller
names it (the parity tests pass ``device="cpu"``).

Numerics on the card: float32 matrix products and convolutions run in full
float32, not TF32. ``resolve_device`` sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False`` whenever it hands out a CUDA
device, so an f32 run on the card is held to f32 tolerances.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "resolve_dtype"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default, and none is "
                "available; pass device='cpu' to run the plain versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[dtype]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}; "
                         f"known: {', '.join(_DTYPES)}") from None
