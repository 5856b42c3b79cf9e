"""Plain PyTorch version of the flash attention kernel, in the model layout.

It computes the function of ``repro/kernels/flash_attention/kernel.py``
(``flash_attention_kernel``) in one shot: f32 scores scaled by 1/sqrt(hd),
the causal mask ``col <= row`` aligned TOP-LEFT, masked scores set to
NEG = -1e30, p = 0 where s <= NEG/2, and the sum divided by max(l, 1e-30),
so a row that sees no key comes out as 0.

Sliding window and sinks (Hymba, the mask of ``repro/models/attention.py::
attention`` and ``sink_banded_attention``): under ``causal``, key ``col``
is visible from query ``row`` when

  col <= row and (window == 0 or col > row - window or col < n_sink).

Without ``causal`` neither ``window`` nor ``n_sink`` masks anything, as in
the reference ``attention``.

Mask hazard: the JAX oracle ``repro/kernels/flash_attention/ref.py::
attention_ref`` aligns its causal mask BOTTOM-RIGHT (``tril(k=Sk-Sq)``). It
agrees with the Pallas kernel only when Sq == Sk. This version, the CUDA
kernel and the port follow the kernel (top-left); a test with Sq != Sk is
held against the Pallas kernel, never against ``attention_ref``.
"""
from __future__ import annotations

import math

import torch

__all__ = ["NEG", "flash_mha_ref"]

NEG = -1e30


def flash_mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  n_sink: int = 0) -> torch.Tensor:
    """q [B,Sq,H,hd], k/v [B,Sk,KV,hd] -> [B,Sq,H,hd] in q.dtype (f32 math).

    GQA: q head h reads kv head h // (H // KV).
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * scale
    if causal:
        rows = torch.arange(Sq, device=q.device)[:, None]
        cols = torch.arange(Sk, device=q.device)[None, :]
        hidden = cols > rows
        if window > 0:
            hidden = hidden | ((cols <= rows - window) & (cols >= n_sink))
        s = s.masked_fill(hidden, NEG)
    m = (s.amax(dim=-1, keepdim=True) if Sk
         else s.new_zeros(s.shape[:-1] + (1,)))
    p = torch.where(s <= NEG / 2, torch.zeros((), device=s.device),
                    torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bskh->bqkgh", p / l, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)
