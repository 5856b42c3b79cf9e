"""Gradient compression for the cross-pod (DCN) all-reduce.

Counterpart of ``repro/train/compress.py``: per-block symmetric int8
quantization (blocks of ``BLOCK`` = 256 values, one f32 scale each) with
**error feedback**: each step the residual between the true gradient and
its quantized form is carried into the next step's gradient, so the
compression bias vanishes in expectation. ``torch.round`` and ``jnp.round``
both round half to even, so the int8 codes are the reference's.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .optim import tree_map

__all__ = ["quantize_int8", "dequantize_int8", "ef_compress_grads", "ef_init",
           "compression_ratio", "BLOCK"]

BLOCK = 256


def _pad_to_block(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, n


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8. Returns (q int8 [nb, BLOCK], scale f32 [nb])."""
    flat, _ = _pad_to_block(x.float())
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.clamp_min(blocks.abs().amax(dim=-1) / 127.0, 1e-12)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype: torch.dtype) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


def ef_init(params) -> Dict:
    """Error-feedback residual accumulator (f32, one per parameter)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def ef_compress_grads(grads, ef_state):
    """g' = Q(g + e);  e' = (g + e) - g'. Applied leaf-wise; returns new
    trees (g', e')."""
    corrected = tree_map(lambda g, e: g.float() + e, grads, ef_state)
    deq = tree_map(lambda c: dequantize_int8(*quantize_int8(c), c.shape, torch.float32),
                   corrected)
    return (tree_map(lambda d, g: d.to(g.dtype), deq, grads),
            tree_map(lambda c, d: c - d, corrected, deq))


def compression_ratio(dtype: torch.dtype = torch.bfloat16) -> float:
    """Bytes ratio vs uncompressed (int8 payload + per-block f32 scale)."""
    raw = torch.empty((), dtype=dtype).element_size()
    return (1.0 + 4.0 / BLOCK) / raw
