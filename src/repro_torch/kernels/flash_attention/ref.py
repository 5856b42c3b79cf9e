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

The backward's plain version is autograd of ``flash_mha_ref``
(``flash_mha_bwd_ref``), the counterpart of ``jax.grad`` of the reference.
``flash_mha_bwd_tiled`` emulates the backward kernel
(``csrc/flash_attention_bwd.cu``) for the tests: (a) L by an online max and
sum over key tiles and D = rowsum(dO·O); (b) dK, dV per key tile and kv
head over its query heads and the query tiles that can see it; (c) dQ per
query tile over the key tiles ``bwd_key_tile_visited`` keeps; P recomputed
as exp(s·scale − L) under the forward's mask.

``flash_mha_tiled`` emulates the tile loop of the tensor-core kernel
(``csrc/flash_attention_wgmma.cu``) for the tests: the same key tiles, chosen
by ``tile_visited`` (the twin of the kernel's predicate), the same online
softmax per tile on raw scores with ``exp2``, ``l`` summed over the f32 p,
and P rounded to the input dtype before ``P·V``. Nothing on the model path
calls it.
"""
from __future__ import annotations

import math

import torch

from .kernel import (BWD_KEY_ROWS, BWD_KEYS, BWD_Q_TILE, BWD_ROWS, WGMMA_BLOCK_K,
                     WGMMA_BLOCK_Q)

__all__ = ["NEG", "flash_mha_ref", "flash_mha_bwd_ref", "tile_visited", "flash_mha_tiled",
           "visible", "bwd_key_tile_visited", "flash_mha_bwd_tiled"]

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


def tile_visited(k0: int, q0: int, block_q: int, block_k: int, Sk: int, *,
                 causal: bool, window: int = 0, n_sink: int = 0) -> bool:
    """Does key tile [k0, k0+block_k) hold a visible pair for some row of
    query tile [q0, q0+block_q)? The twin of ``tile_visited`` in
    ``csrc/flash_attention_wgmma.cu``: a tile it skips would only add p = 0
    with m unchanged."""
    if k0 >= Sk:
        return False
    if not causal:
        return True
    if k0 >= q0 + block_q:                    # wholly past the last row
        return False
    # under a window: not wholly between the sinks and the band of row q0
    return window == 0 or k0 < n_sink or k0 + block_k > q0 - window + 1


def flash_mha_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, n_sink: int = 0,
                    block_q: int = WGMMA_BLOCK_Q,
                    block_k: int = WGMMA_BLOCK_K) -> torch.Tensor:
    """The tensor-core kernel's tile loop in plain torch; same signature and
    result as ``flash_mha_ref`` up to sum order and the rounding of P."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale_log2 = (1.0 / math.sqrt(hd)) * math.log2(math.e)
    qf = q.float().permute(0, 2, 1, 3)                           # [B,H,Sq,hd]
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(G, 1)   # [B,H,Sk,hd]
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(G, 1)
    out = torch.zeros(B, H, Sq, hd, device=q.device)
    for q0 in range(0, Sq, block_q):
        q1 = min(q0 + block_q, Sq)
        rows = torch.arange(q0, q1, device=q.device)[:, None]
        m = torch.full((B, H, q1 - q0, 1), NEG, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, H, q1 - q0, hd, device=q.device)
        for k0 in range(0, Sk, block_k):
            if not tile_visited(k0, q0, block_q, block_k, Sk, causal=causal,
                                window=window, n_sink=n_sink):
                continue
            k1 = min(k0 + block_k, Sk)
            s = qf[:, :, q0:q1] @ kf[:, :, k0:k1].transpose(-1, -2)  # raw scores
            if causal:
                cols = torch.arange(k0, k1, device=q.device)[None, :]
                hidden = cols > rows
                if window > 0:
                    hidden = hidden | ((cols <= rows - window) & (cols >= n_sink))
                s = s.masked_fill(hidden, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp2((m - m_new) * scale_log2)
            p = torch.where(s <= NEG / 2, torch.zeros((), device=s.device),
                            torch.exp2(s * scale_log2 - m_new * scale_log2))
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            p = p.to(q.dtype).float()                # P enters P·V in q.dtype
            acc = acc * alpha + p @ vf[:, :, k0:k1]
            m = m_new
        out[:, :, q0:q1] = acc / l.clamp_min(1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def flash_mha_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      dout: torch.Tensor, *, causal: bool = True, window: int = 0,
                      n_sink: int = 0):
    """(dq, dk, dv) of ``flash_mha_ref`` for the output gradient ``dout``, by
    autograd."""
    with torch.enable_grad():
        qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = flash_mha_ref(qr, kr, vr, causal=causal, window=window, n_sink=n_sink)
        return torch.autograd.grad(out, (qr, kr, vr), dout)


def visible(rows: torch.Tensor, cols: torch.Tensor, Sk: int, *, causal: bool,
            window: int = 0, n_sink: int = 0) -> torch.Tensor:
    """The forward's mask as a boolean [rows, cols] grid: the twin of the
    backward kernel's ``visible`` (ragged key tail included)."""
    ok = cols < Sk
    if causal:
        seen = cols <= rows
        if window > 0:
            seen = seen & ((cols > rows - window) | (cols < n_sink))
        ok = ok & seen
    return ok


def bwd_key_tile_visited(k0: int, q0: int, *, causal: bool, window: int = 0,
                         n_sink: int = 0, block_q: int = BWD_ROWS,
                         block_k: int = BWD_KEYS) -> bool:
    """The backward kernel's ``key_tile_visited``: does key tile
    [k0, k0+block_k) hold a visible pair for a row of [q0, q0+block_q)?"""
    if not causal:
        return True
    if k0 >= q0 + block_q:
        return False
    return window == 0 or k0 < n_sink or k0 + block_k > q0 - window + 1


def flash_mha_bwd_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, n_sink: int = 0):
    """The backward kernel's three launches in plain torch, f32 math:
    (dq, dk, dv) in the dtypes of q and k, from the forward's inputs, its
    output ``o`` and ``dout``."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    if not causal:
        window = n_sink = 0
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qf, of, df = (t.float().permute(0, 2, 1, 3) for t in (q, o, dout))   # [B,H,Sq,hd]
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))             # [B,KV,Sk,hd]
    kh = kf.repeat_interleave(G, 1)                                       # [B,H,Sk,hd]
    vh = vf.repeat_interleave(G, 1)
    mask = dict(causal=causal, window=window, n_sink=n_sink)

    # (a) L and D per query row
    lse = torch.empty(B, H, Sq, device=dev)
    delta = (df * of).sum(-1)
    for q0 in range(0, Sq, BWD_ROWS):
        q1 = min(q0 + BWD_ROWS, Sq)
        rows = torch.arange(q0, q1, device=dev)[:, None]
        m = torch.full((B, H, q1 - q0), NEG, device=dev)
        l = torch.zeros_like(m)
        k_end = min(Sk, q0 + BWD_ROWS) if causal else Sk
        for k0 in range(0, k_end, BWD_KEYS):
            if not bwd_key_tile_visited(k0, q0, **mask):
                continue
            k1 = min(k0 + BWD_KEYS, Sk)
            cols = torch.arange(k0, k1, device=dev)[None, :]
            s = (qf[:, :, q0:q1] @ kh[:, :, k0:k1].transpose(-1, -2)) * scale
            s = s.masked_fill(~visible(rows, cols, Sk, **mask), NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(s <= NEG / 2, torch.zeros((), device=dev),
                            torch.exp(s - m_new[..., None]))
            l = l * torch.exp(m - m_new) + p.sum(-1)
            m = m_new
        lse[:, :, q0:q1] = torch.where(l > 0, m + torch.log(l),
                                       torch.full_like(l, float("inf")))

    def probs(s_raw, L, rows, cols):
        seen = visible(rows, cols, Sk, **mask) & (rows < Sq)
        return torch.where(seen, torch.exp(s_raw * scale - L), torch.zeros((), device=dev))

    # (b) dK, dV per key tile and kv head, over the G query heads in order
    dk = torch.zeros(B, KV, Sk, hd, device=dev)
    dv = torch.zeros_like(dk)
    qg, dg = qf.unflatten(1, (KV, G)), df.unflatten(1, (KV, G))
    lg, ddg = lse.unflatten(1, (KV, G)), delta.unflatten(1, (KV, G))
    for k0 in range(0, Sk, BWD_KEY_ROWS):
        k1 = min(k0 + BWD_KEY_ROWS, Sk)
        cols = torch.arange(k0, k1, device=dev)[:, None]               # [keys, 1]
        q_lo, q_hi = 0, Sq
        if causal:
            q_lo = k0
            if window > 0 and k0 >= n_sink:
                q_hi = min(Sq, k1 - 1 + window)
        for g in range(G):
            for q0 in range(q_lo, q_hi, BWD_Q_TILE):
                q1 = min(q0 + BWD_Q_TILE, Sq)
                rows = torch.arange(q0, q1, device=dev)[None, :]       # [1, rows]
                qt, dt = qg[:, :, g, q0:q1], dg[:, :, g, q0:q1]       # [B,KV,rows,hd]
                s = kf[:, :, k0:k1] @ qt.transpose(-1, -2)             # [B,KV,keys,rows]
                p = probs(s, lg[:, :, g, None, q0:q1], rows, cols)
                dp = vf[:, :, k0:k1] @ dt.transpose(-1, -2)
                ds = p * (dp - ddg[:, :, g, None, q0:q1])
                dv[:, :, k0:k1] += p @ dt
                dk[:, :, k0:k1] += ds @ qt
    dk = dk * scale

    # (c) dQ per query tile, over the visited key tiles
    dq = torch.zeros(B, H, Sq, hd, device=dev)
    for q0 in range(0, Sq, BWD_ROWS):
        q1 = min(q0 + BWD_ROWS, Sq)
        rows = torch.arange(q0, q1, device=dev)[:, None]
        k_end = min(Sk, q0 + BWD_ROWS) if causal else Sk
        for k0 in range(0, k_end, BWD_KEYS):
            if not bwd_key_tile_visited(k0, q0, **mask):
                continue
            k1 = min(k0 + BWD_KEYS, Sk)
            cols = torch.arange(k0, k1, device=dev)[None, :]
            s = qf[:, :, q0:q1] @ kh[:, :, k0:k1].transpose(-1, -2)
            p = probs(s, lse[:, :, q0:q1, None], rows, cols)
            dp = df[:, :, q0:q1] @ vh[:, :, k0:k1].transpose(-1, -2)
            dq[:, :, q0:q1] += (p * (dp - delta[:, :, q0:q1, None])) @ kh[:, :, k0:k1]
    dq = dq * scale
    return (dq.permute(0, 2, 1, 3).to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))
