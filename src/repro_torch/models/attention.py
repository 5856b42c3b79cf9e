"""Attention for forward/prefill and decode.

Counterpart of ``repro/models/attention.py``:

  * ``attention``        — forward/prefill, causal or not, with an optional
    sliding window and always-attended sinks: the flash attention kernel on
    the card. The JAX function scans query chunks of jnp math (banded under
    a window); the kernel computes the same function with the scores kept
    on chip.
  * ``sink_banded_attention`` — the reference's two-piece (sinks + band)
    form of the same masked softmax: here the same kernel call.
  * ``cross_attention`` — text queries against the VLM's image K/V, no
    mask: the same kernel, non-causal, with Sq != Sk (the reference computes
    it in plain jnp). One call serves forward, prefill and decode (Sq = 1).
  * ``decode_attention`` — one new token against the KV cache, plain torch
    (the reference has no Pallas kernel there either).

Shapes: q [B,S,H,hd], k/v [B,Skv,KV,hd], cache k/v [B,Smax,KV,hd].
"""
from __future__ import annotations

import math

import torch

from ..distributed.sharding import constrain
from ..kernels.flash_attention.ops import flash_mha

__all__ = ["attention", "sink_banded_attention", "cross_attention", "decode_attention"]

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, n_sink: int = 0) -> torch.Tensor:
    """Attention over the sequence. Returns [B,S,H,hd].

    window>0: causal sliding window; n_sink>0: the first ``n_sink``
    positions are always attended (Hymba meta tokens). Under a window the
    reference's banded form drops sinks that fall outside the band
    (``repro/models/attention.py:102-104``); no caller reaches that case, and
    here sinks are always attended.
    """
    out = flash_mha(q, k, v, causal=causal, window=window, n_sink=n_sink)
    return constrain(out, "batch", "act_seq", "heads", None)


def sink_banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          window: int, n_sink: int) -> torch.Tensor:
    """SWA + always-attend sinks. The reference computes the band and the
    sinks as two pieces merged by a joint softmax; the kernel applies the
    joint mask directly, so this is ``attention`` with both set."""
    return attention(q, k, v, causal=True, window=window, n_sink=n_sink)


def cross_attention(q: torch.Tensor, k_img: torch.Tensor, v_img: torch.Tensor) -> torch.Tensor:
    """q [B,S,H,hd] x image K/V [B,I,KV,hd] -> [B,S,H,hd]: every query sees
    every image token, GQA head i // G, scale 1/sqrt(hd), which is the
    flash kernel's function without the causal mask."""
    return flash_mha(q, k_img, v_img, causal=False)


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
