"""ctypes binding of the CUDA flash attention kernel
(``csrc/flash_attention.cu``).

Counterpart of ``repro/kernels/flash_attention/kernel.py::flash_attention``.
The Pallas kernel takes heads flattened into the batch ([BH, S, hd]); the
CUDA kernel reads the model layout [B, S, H, hd] / [B, S, KV, hd] directly,
so no transpose is materialised around it.
"""
from __future__ import annotations

import math

import torch

from .. import _build

__all__ = ["HEAD_DIMS", "flash_attention_cuda"]

HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, *, causal: bool, window: int = 0,
                         n_sink: int = 0) -> None:
    """Launch into ``out`` [B,Sq,H,hd] with scale 1/sqrt(hd); the caller has
    checked device, dtype, shapes and contiguity."""
    lib = _build.load()
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    err = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, KV, hd, int(causal), int(window), int(n_sink),
        1.0 / math.sqrt(hd),
        _build.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("repro_flash_attention", err)
