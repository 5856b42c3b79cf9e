"""Layer blocks: parameter templates + forward/prefill/decode paths.

Counterpart of ``repro/models/blocks.py``, for the attention block of the
dense family (``ATTN_BLOCK``). Each block kind is a ``Block`` record whose
functions share one numeric core:

  template(cfg)                      -> tree of PT
  apply(cfg, p, x, ctx)              -> x                 (forward, no cache)
  prefill(cfg, p, x, ctx, cache)     -> (x, cache)
  decode(cfg, p, x, cache, ctx)      -> (x, cache)
  cache_template(cfg, B, ctx)        -> tree of PT

The KV cache is preallocated by the model and updated IN PLACE: ``prefill``
writes this layer's K/V into the cache slice it is given, and ``decode``
writes the new token's K/V at slot ``pos``; both return that same slice.
(The JAX package returns a new cache and donates the old one.)
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from .attention import attention, decode_attention
from .layers import PT, apply_rope, map_templates, rms_norm, swiglu

__all__ = ["Block", "BlockCtx", "BLOCKS", "ATTN_BLOCK", "stackify", "rope_at"]


@dataclass(frozen=True)
class BlockCtx:
    """Per-segment static + per-call dynamic context.

    ``rope`` holds the cos/sin tables [S, hd/2] for forward/prefill and the
    tables at the decode position [1, hd/2] for decode (None: no RoPE).
    ``pos`` is the absolute decode position as a Python int, so a decode
    step never syncs with the device to read it.
    """

    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    window: int = 0            # 0 = full attention
    causal: bool = True
    pos: Optional[int] = None  # decode position
    smax: int = 0              # cache capacity (decode)


@dataclass(frozen=True)
class Block:
    kind: str
    template: Callable[[ArchConfig], Any]
    apply: Callable[..., torch.Tensor]
    prefill: Callable[..., Tuple[torch.Tensor, Any]]
    decode: Callable[..., Tuple[torch.Tensor, Any]]
    cache_template: Callable[[ArchConfig, int, BlockCtx], Any]


def stackify(tmpl, n: int):
    """Add a leading 'stack' dim of size n to every PT in a template tree."""
    return map_templates(
        lambda t: replace(t, shape=(n,) + t.shape, axes=("stack",) + t.axes), tmpl)


def rope_at(pos: int, head_dim: int, theta: float, device=None):
    """cos/sin [1, hd/2] at a single position."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=device) / half))
    ang = freqs * float(pos)
    return torch.cos(ang)[None], torch.sin(ang)[None]


def _res_scale(cfg: ArchConfig) -> float:
    # MiniCPM depth-scaled residuals: scale_depth / sqrt(n_layers).
    return cfg.scale_depth / math.sqrt(cfg.n_layers) if cfg.scale_depth > 0 else 1.0


def _residual(x: torch.Tensor, f: torch.Tensor, res: float) -> torch.Tensor:
    return x + f if res == 1.0 else x + f * res


# ---------------------------------------------------------------------------
# attention (+ dense-FFN) block — dense family
# ---------------------------------------------------------------------------

def _attn_template(cfg: ArchConfig) -> Dict[str, Any]:
    if cfg.is_moe:
        raise NotImplementedError("the MoE FFN is ported with the MoE slice")
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p: Dict[str, Any] = {
        "ln1": PT((d,), (None,), init="ones"),
        "wq": PT((d, H, hd), ("embed", "heads", None), fan_in=d),
        "wk": PT((d, KV, hd), ("embed", "kv_heads", None), fan_in=d),
        "wv": PT((d, KV, hd), ("embed", "kv_heads", None), fan_in=d),
        "wo": PT((H, hd, d), ("heads", None, "embed"), fan_in=H * hd),
        "ln2": PT((d,), (None,), init="ones"),
    }
    if cfg.qkv_bias:
        p["bq"] = PT((H, hd), ("heads", None), init="zeros")
        p["bk"] = PT((KV, hd), ("kv_heads", None), init="zeros")
        p["bv"] = PT((KV, hd), ("kv_heads", None), init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = PT((hd,), (None,), init="ones")
        p["k_norm"] = PT((hd,), (None,), init="ones")
    f = cfg.d_ff
    p["wg"] = PT((d, f), ("embed", "ff"))
    p["wi"] = PT((d, f), ("embed", "ff"))
    p["wo2"] = PT((f, d), ("ff", "embed"))
    return p


def _proj_heads(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """'bsd,dhk->bshk' as one matrix product."""
    d, n, k = w.shape
    return (h @ w.reshape(d, n * k)).unflatten(-1, (n, k))


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """'bshk,hkd->bsd' as one matrix product."""
    n, k, d = wo.shape
    return o.flatten(-2) @ wo.reshape(n * k, d)


def _qkv(cfg: ArchConfig, p, h, rope):
    q = _proj_heads(h, p["wq"])
    k = _proj_heads(h, p["wk"])
    v = _proj_heads(h, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _ffn(cfg: ArchConfig, p, x, res):
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return _residual(x, swiglu(h2, p["wg"], p["wi"], p["wo2"]), res)


# decode runs the same dense FFN on one token
_ffn_decode = _ffn


def _attn_core(cfg: ArchConfig, p, x, ctx: BlockCtx):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, h, ctx.rope)
    o = attention(q, k, v, causal=ctx.causal, window=ctx.window)
    res = _res_scale(cfg)
    x = _ffn(cfg, p, _residual(x, _out_proj(o, p["wo"]), res), res)
    return x, k, v


def _attn_apply(cfg: ArchConfig, p, x, ctx: BlockCtx) -> torch.Tensor:
    return _attn_core(cfg, p, x, ctx)[0]


def _attn_cache_template(cfg: ArchConfig, B: int, ctx: BlockCtx):
    if ctx.window > 0:
        raise NotImplementedError(
            "the sliding-window ring cache is ported with the hybrid family")
    KV, hd = cfg.n_kv_heads, cfg.hd
    spec = PT((B, ctx.smax, KV, hd), ("batch", "kv_seq", "kv_heads", None),
              init="zeros")
    return {"k": spec, "v": spec}


def _pack_attn_cache(k, v, cache):
    """Write the prompt's K/V into the zeroed cache slice (in place): the
    first min(S, W) positions; later slots stay zero."""
    n = min(k.shape[1], cache["k"].shape[1])
    cache["k"][:, :n] = k[:, :n]
    cache["v"][:, :n] = v[:, :n]
    return cache


def _attn_prefill(cfg: ArchConfig, p, x, ctx: BlockCtx, cache):
    """Apply + fill this layer's preallocated cache slice from its K/V."""
    x, k, v = _attn_core(cfg, p, x, ctx)
    return x, _pack_attn_cache(k, v, cache)


def _attn_decode(cfg: ArchConfig, p, x, cache, ctx: BlockCtx):
    """x [B,1,d]; cache {k,v [B,W,KV,hd]}; ctx.pos = absolute position."""
    res = _res_scale(cfg)
    pos = ctx.pos
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, h, ctx.rope)
    W = cache["k"].shape[1]
    # the reference's dynamic_update_slice clamps the slot into the cache
    slot = min(pos, W - 1)
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    valid = torch.arange(W, device=x.device) <= pos
    o = decode_attention(q, cache["k"], cache["v"], valid)
    x = _residual(x, _out_proj(o, p["wo"]), res)
    return _ffn_decode(cfg, p, x, res), cache


ATTN_BLOCK = Block(
    kind="attn",
    template=_attn_template,
    apply=_attn_apply,
    prefill=_attn_prefill,
    decode=_attn_decode,
    cache_template=_attn_cache_template,
)

BLOCKS: Dict[str, Block] = {"attn": ATTN_BLOCK}
