"""Attention for forward/prefill and decode.

Counterpart of ``repro/models/attention.py``:

  * ``attention``        — forward/prefill, causal or not, full width (no
    sliding window): the flash attention kernel on the card. The JAX
    function scans query chunks of jnp math; the kernel computes the same
    function with the scores kept on chip.
  * ``decode_attention`` — one new token against the KV cache, plain torch
    (the reference has no Pallas kernel there either).

Shapes: q [B,S,H,hd], k/v [B,Skv,KV,hd], cache k/v [B,Smax,KV,hd].
"""
from __future__ import annotations

import math

import torch

from ..kernels.flash_attention.ops import flash_mha

__all__ = ["attention", "decode_attention"]

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """Full attention over the sequence. Returns [B,S,H,hd]."""
    if window > 0:
        raise NotImplementedError(
            "sliding-window attention is ported with the hybrid family")
    return flash_mha(q, k, v, causal=causal)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """One-token decode: q [B,1,H,hd] vs cache [B,Smax,KV,hd].

    ``valid`` [Smax] bool marks live cache slots (the caller encodes the
    causal semantics). Scores in f32, probabilities cast to the cache dtype
    before the PV product, as in the reference.
    """
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, 1, KV, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k_cache).float() * scale
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v_cache)
    return out.reshape(B, 1, H, hd)
