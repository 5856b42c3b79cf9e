"""Plain PyTorch operations that the references share.

Everything here is float32 with TF32 off (``strict_f32``), written from the
equations and not from the measured program: no import of ``repro_torch``,
``repro`` or ``jax``. Every matrix product goes through ``mm``, so the same
reference also runs as the lower-precision control: with ``prec="fp8"`` each
product's operands are rounded to float8 e4m3 with one scale a tensor
(amax / 448), the products accumulate in float32, and under autograd the
backward's products round their operands the same way.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, List, Tuple

import torch

__all__ = ["strict_f32", "mm", "rms_norm", "rope", "attention", "swiglu", "fp8_round",
           "param_layout_runs", "layer_views", "Leaf", "FP8_MAX"]

FP8_MAX = 448.0     # the largest finite float8 e4m3fn


@dataclass(frozen=True)
class Leaf:
    """One parameter of a layout: its shape and how it is drawn: "normal"
    (a standard normal times ``scale``) or a constant ("ones", "zeros")."""
    shape: Tuple[int, ...]
    init: str = "normal"
    scale: float = 1.0


def strict_f32() -> None:
    """float32 products in float32: TF32 off for matmul and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one scale (amax / 448), back in f32."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale)


class _Fp8Matmul(torch.autograd.Function):
    """a @ b with both operands in float8 e4m3, forward and backward."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8_round(g)
        ga = qg @ qb.transpose(-1, -2)
        if qb.dim() == 2:
            gb = qa.reshape(-1, qa.shape[-1]).T @ qg.reshape(-1, qg.shape[-1])
        else:
            gb = qa.transpose(-1, -2) @ qg
        return ga, gb


def mm(a: torch.Tensor, b: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """a [..., k] @ b [k, n] (or batched b [..., k, n]) in ``prec``."""
    if prec == "f32":
        return a @ b
    if prec == "fp8":
        return _Fp8Matmul.apply(a, b)
    raise ValueError(f"unknown precision {prec!r}")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x · rsqrt(mean(x²) + eps) · w over the last dim."""
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x [B, S, H, hd] at positions 0..S-1, the two
    halves of the head rotated as pairs (x1, x2) -> (x1·c - x2·s, x2·c + x1·s)."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _mask(S: int, causal: bool, window: int, n_sink: int, device) -> torch.Tensor:
    """[S, S] True where query i sees key j: j <= i when causal; under a
    window also i - j < window or j < n_sink."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    if not causal:
        return torch.ones((S, S), dtype=torch.bool, device=device)
    m = j <= i
    if window:
        m &= (i - j < window) | (j < n_sink)
    return m


def attention(q, k, v, *, causal: bool, window: int = 0, n_sink: int = 0,
              prec: str = "f32") -> torch.Tensor:
    """Softmax attention, q [B,S,H,hd], k/v [B,S,KV,hd] (head h reads kv
    head h // (H / KV)), scale 1/sqrt(hd); one batch row at a time so the
    [H, S, S] scores of a row are the largest tensor."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    mask = _mask(S, causal, window, n_sink, q.device)
    out = []
    for b in range(B):
        qb = q[b].transpose(0, 1)                                  # [H,S,hd]
        kb = k[b].transpose(0, 1).repeat_interleave(G, 0)          # [H,S,hd]
        vb = v[b].transpose(0, 1).repeat_interleave(G, 0)
        s = mm(qb, kb.transpose(-1, -2), prec) / math.sqrt(hd)
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out.append(mm(p, vb, prec).transpose(0, 1))                # [S,H,hd]
    return torch.stack(out)


def swiglu(h, wg, wi, wo2, prec: str = "f32") -> torch.Tensor:
    """(silu(h @ wg) · (h @ wi)) @ wo2."""
    return mm(torch.nn.functional.silu(mm(h, wg, prec)) * mm(h, wi, prec), wo2, prec)


def param_layout_runs(n_layers: int, singles: Tuple[int, ...]) -> List[Tuple[bool, int, int]]:
    """The port's parameter layout of a layer stack: layers listed in
    ``singles`` are segments of their own with unstacked leaves, the runs
    between them one segment each with leaves stacked on a leading dim.
    Returns (single, first layer, length) per segment, in order."""
    out, i = [], 0
    for s in sorted(singles):
        if s > i:
            out.append((False, i, s - i))
        out.append((True, s, 1))
        i = s + 1
    if i < n_layers:
        out.append((False, i, n_layers - i))
    return out


def layer_views(segments, runs) -> Iterator[Tuple[int, dict]]:
    """(layer index, that layer's leaves) over a segment list laid out by
    ``param_layout_runs``."""
    for seg, (single, first, n) in zip(segments, runs):
        for j in range(n):
            yield first + j, (seg if single else {k: v[j] for k, v in seg.items()})
