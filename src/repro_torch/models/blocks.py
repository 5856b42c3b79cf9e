"""Layer blocks: parameter templates + forward/prefill/decode paths.

Counterpart of ``repro/models/blocks.py``, for every block kind of the
reference: the attention block of the dense, MoE, audio and VLM families
(``ATTN_BLOCK``; its FFN is the dense SwiGLU or, where the config has
experts, the MoE FFN), the gated cross-attention block of the VLM
(``CROSS_BLOCK``: text queries against the image tokens), the hybrid block
of Hymba (``HYBRID_BLOCK``: attention and Mamba heads in parallel on one
input) and the two xLSTM blocks (``MLSTM_BLOCK``, ``SLSTM_BLOCK``). Each
block kind is a ``Block`` record whose functions share one numeric core:

  template(cfg)                      -> tree of PT
  apply(cfg, p, x, ctx)              -> x                 (forward, no cache)
  prefill(cfg, p, x, ctx, cache)     -> (x, cache)
  decode(cfg, p, x, cache, ctx)      -> (x, cache)
  cache_template(cfg, B, ctx)        -> tree of PT

The cache is preallocated by the model and updated IN PLACE: ``prefill``
writes this layer's K/V (SSM state, image K/V, cell state) into the cache
slice it is given, and ``decode`` writes the new token's K/V (and state)
at its slot; both return that same slice. (The JAX package returns a new cache and donates the old one.)
A sliding-window layer keeps a ring: ``n_sink`` sink slots, then
``window`` slots that the positions after the sinks cycle through.
Under sharding rules the tensors are DTensors, the ``constrain`` calls sit
at the reference's sites, and each cache write lands in the local shard of
every rank that holds part of its slots (``write_along_``, ``store_``).

Spans (``obs/spans.py``, while a profiler records) mark the parts of the two
blocks the benchmark runs: ``attn.attn`` (ln1 through the out-projection's
residual) and ``attn.ffn``; ``hybrid.attn`` (q/k/v through the out
projection), ``hybrid.mamba`` and ``hybrid.ffn`` (fusion, ln2, SwiGLU). The
hybrid block's ln1 feeds both heads and stays in the layer's own time. The
"save-attn" remat policy recomputes the attention block in two pieces
(``ATTN_BLOCK.split``) with no ``attn.attn`` around them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..distributed.sharding import constrain, mesh_of, store_, to_mesh, write_along_
from ..obs.spans import span
from .attention import attention, cross_attention, decode_attention
from .layers import PT, apply_rope, column_parallel, dense, map_templates, rms_norm, swiglu
from .mamba import MambaState, mamba_decode_mix, mamba_mix
from .moe import moe_ffn
from .ssm import mlstm_chunked, mlstm_decode_step, slstm_decode_step, slstm_scan

__all__ = ["Block", "BlockCtx", "BLOCKS", "ATTN_BLOCK", "CROSS_BLOCK", "HYBRID_BLOCK",
           "MLSTM_BLOCK", "SLSTM_BLOCK", "stackify", "rope_at"]


@dataclass(frozen=True)
class BlockCtx:
    """Per-segment static + per-call dynamic context.

    ``rope`` holds the cos/sin tables [S, hd/2] for forward/prefill and the
    tables at the decode position [1, hd/2] for decode (None: no RoPE).
    ``img`` holds the VLM's image tokens [B, I, d] in the activation dtype
    (forward and prefill). ``pos`` is the absolute decode position as a
    Python int, so a decode step never syncs with the device to read it.
    """

    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    window: int = 0            # 0 = full attention
    n_sink: int = 0            # always-attended prefix (Hymba meta tokens)
    causal: bool = True
    img: Optional[torch.Tensor] = None
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
    # apply cut at its attention, for the "save-attn" remat policy:
    # (in(cfg, p, x, ctx) -> (q, k, v), mix(q, k, v, ctx) -> o,
    #  out(cfg, p, x, o) -> x); None where the block has no such cut
    split: Optional[Tuple[Callable, Callable, Callable]] = None


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


def _store(cache, **state):
    """Copy each named state into its preallocated cache leaf; the cache."""
    for key, t in state.items():
        store_(cache[key], t)
    return cache


def _res_scale(cfg: ArchConfig) -> float:
    # MiniCPM depth-scaled residuals: scale_depth / sqrt(n_layers).
    return cfg.scale_depth / math.sqrt(cfg.n_layers) if cfg.scale_depth > 0 else 1.0


def _residual(x: torch.Tensor, f: torch.Tensor, res: float) -> torch.Tensor:
    return x + f if res == 1.0 else x + f * res


# ---------------------------------------------------------------------------
# attention (+ dense or MoE FFN) block — dense and MoE families
# ---------------------------------------------------------------------------

def _attn_template(cfg: ArchConfig) -> Dict[str, Any]:
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
    if cfg.is_moe:
        E = cfg.n_experts
        p["router"] = PT((d, E), ("embed", None))
        p["we_gate"] = PT((E, d, f), ("expert", "embed", None))
        p["we_up"] = PT((E, d, f), ("expert", "embed", None))
        p["we_down"] = PT((E, f, d), ("expert", None, "embed"))
    else:
        p["wg"] = PT((d, f), ("embed", "ff"))
        p["wi"] = PT((d, f), ("embed", "ff"))
        p["wo2"] = PT((f, d), ("ff", "embed"))
    return p


def _proj_heads(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """'bsd,dhk->bshk' as one matrix product; on DTensors a column-parallel
    one over the heads each rank holds (``column_parallel``)."""
    d, n, k = w.shape
    mesh = mesh_of(h, w)
    if mesh is None:
        return (h @ w.reshape(d, n * k)).unflatten(-1, (n, k))
    return column_parallel(lambda x, wl: (x @ wl.reshape(d, -1)).unflatten(-1, (wl.shape[1], k)),
                           to_mesh(h, mesh), w)


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """'bshk,hkd->bsd' as one matrix product."""
    n, k, d = wo.shape
    return dense(o.flatten(-2), wo.reshape(n * k, d))


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
    q = constrain(q, "batch", "act_seq", "heads", None)
    return q, k, v


def _ffn(cfg: ArchConfig, p, x, res):
    """ln2, then the dense SwiGLU or the MoE FFN, and the residual."""
    with span("attn.ffn"):
        h2 = constrain(rms_norm(x, p["ln2"], cfg.norm_eps), "batch", "act_seq", None)
        if cfg.is_moe:
            f = moe_ffn(h2, p["router"], p["we_gate"], p["we_up"], p["we_down"],
                        k=cfg.experts_per_token, n_experts=cfg.n_experts,
                        capacity_factor=cfg.capacity_factor)
        else:
            f = swiglu(h2, p["wg"], p["wi"], p["wo2"])
        return constrain(_residual(x, f, res), "batch", "act_seq", None)


# decode runs the same FFN (dense or MoE) on one token
_ffn_decode = _ffn


def _attn_in(cfg: ArchConfig, p, x, ctx: BlockCtx):
    """ln1 and the projections: the part of the block before attention."""
    h = constrain(rms_norm(x, p["ln1"], cfg.norm_eps), "batch", "act_seq", None)
    return _qkv(cfg, p, h, ctx.rope)


def _attn_mix(q, k, v, ctx: BlockCtx):
    return attention(q, k, v, causal=ctx.causal, window=ctx.window, n_sink=ctx.n_sink)


def _attn_res(cfg: ArchConfig, p, x, o):
    """Out-projection and residual."""
    return _residual(x, _out_proj(o, p["wo"]), _res_scale(cfg))


def _attn_out(cfg: ArchConfig, p, x, o):
    """Out-projection, residual and FFN: the part of the block after
    attention."""
    return _ffn(cfg, p, _attn_res(cfg, p, x, o), _res_scale(cfg))


def _attn_core(cfg: ArchConfig, p, x, ctx: BlockCtx):
    with span("attn.attn"):
        q, k, v = _attn_in(cfg, p, x, ctx)
        x = _attn_res(cfg, p, x, _attn_mix(q, k, v, ctx))
    return _ffn(cfg, p, x, _res_scale(cfg)), k, v


def _attn_apply(cfg: ArchConfig, p, x, ctx: BlockCtx) -> torch.Tensor:
    return _attn_core(cfg, p, x, ctx)[0]


def _attn_cache_len(cfg: ArchConfig, ctx: BlockCtx) -> int:
    if ctx.window > 0:
        return ctx.n_sink + ctx.window
    return ctx.smax


def _attn_cache_template(cfg: ArchConfig, B: int, ctx: BlockCtx):
    KV, hd = cfg.n_kv_heads, cfg.hd
    seq_ax = "kv_seq" if ctx.window == 0 else None
    spec = PT((B, _attn_cache_len(cfg, ctx), KV, hd),
              ("batch", seq_ax, "kv_heads", None), init="zeros")
    return {"k": spec, "v": spec}


def _pack_attn_cache(k, v, cache, ctx: BlockCtx):
    """Write the prompt's K/V into the zeroed cache slice (in place).

    Full attention: the first min(S, W) positions; later slots stay zero.
    Window: the sinks in slots [0, n_sink), then the last min(window,
    S - n_sink) positions at their ring slots n_sink + (p - n_sink) % window.
    """
    S = k.shape[1]
    if ctx.window == 0:
        n = min(S, cache["k"].shape[1])
        write_along_(cache["k"], k[:, :n], 1, 0)
        write_along_(cache["v"], v[:, :n], 1, 0)
        return cache
    ns, w = ctx.n_sink, ctx.window            # S >= ns: the sinks lead every prompt
    write_along_(cache["k"], k[:, :ns], 1, 0)
    write_along_(cache["v"], v[:, :ns], 1, 0)
    tail = min(w, S - ns)
    start = (S - tail - ns) % w
    idx = ns + (start + torch.arange(tail, device=k.device)) % w
    write_along_(cache["k"], k[:, S - tail:], 1, index=idx)
    write_along_(cache["v"], v[:, S - tail:], 1, index=idx)
    return cache


def _attn_prefill(cfg: ArchConfig, p, x, ctx: BlockCtx, cache):
    """Apply + fill this layer's preallocated cache slice from its K/V."""
    x, k, v = _attn_core(cfg, p, x, ctx)
    return x, _pack_attn_cache(k, v, cache, ctx)


def _decode_attn_out(cfg: ArchConfig, p, h, cache, ctx: BlockCtx):
    """Write the new token's K/V at its slot and attend over the cache:
    h [B,1,d] (normed) -> out-projected attention [B,1,d]."""
    pos = ctx.pos
    q, k, v = _qkv(cfg, p, h, ctx.rope)
    # decode shards the CACHE over 'model' (flash-decoding); q keeps its
    # heads whole
    q = constrain(q, "batch", None, None, None)
    W = cache["k"].shape[1]
    if ctx.window == 0:
        slot = pos
    else:
        ns = ctx.n_sink
        slot = pos if pos < ns else ns + (pos - ns) % ctx.window
    # the reference's dynamic_update_slice clamps the slot into the cache
    slot = min(slot, W - 1)
    write_along_(cache["k"], k, 1, slot)
    write_along_(cache["v"], v, 1, slot)
    # the reference's ring mask (arange(W) <= pos) | (pos >= W) is this
    # one: once pos >= W every slot is <= pos
    valid = torch.arange(W, device=h.device) <= pos
    o = decode_attention(q, cache["k"], cache["v"], valid)
    return _out_proj(o, p["wo"])


def _attn_decode(cfg: ArchConfig, p, x, cache, ctx: BlockCtx):
    """x [B,1,d]; cache {k,v [B,W,KV,hd]}; ctx.pos = absolute position."""
    res = _res_scale(cfg)
    with span("attn.attn"):
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        x = _residual(x, _decode_attn_out(cfg, p, h, cache, ctx), res)
    return _ffn_decode(cfg, p, x, res), cache


ATTN_BLOCK = Block(
    kind="attn",
    template=_attn_template,
    apply=_attn_apply,
    prefill=_attn_prefill,
    decode=_attn_decode,
    cache_template=_attn_cache_template,
    split=(_attn_in, _attn_mix, _attn_out),
)


# ---------------------------------------------------------------------------
# cross-attention block (Llama-3.2-Vision): q from the text, k/v from the
# image tokens, attention and FFN each behind a tanh gate that starts at 0
# ---------------------------------------------------------------------------

def _cross_template(cfg: ArchConfig) -> Dict[str, Any]:
    d, H, KV, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    return {
        "ln1": PT((d,), (None,), init="ones"),
        "wq": PT((d, H, hd), ("embed", "heads", None), fan_in=d),
        "wk": PT((d, KV, hd), ("embed", "kv_heads", None), fan_in=d),
        "wv": PT((d, KV, hd), ("embed", "kv_heads", None), fan_in=d),
        "wo": PT((H, hd, d), ("heads", None, "embed"), fan_in=H * hd),
        "q_norm": PT((hd,), (None,), init="ones"),
        "k_norm": PT((hd,), (None,), init="ones"),
        "gate_attn": PT((), (), init="zeros"),
        "ln2": PT((d,), (None,), init="ones"),
        "wg": PT((d, f), ("embed", "ff")),
        "wi": PT((d, f), ("embed", "ff")),
        "wo2": PT((f, d), ("ff", "embed")),
        "gate_ffn": PT((), (), init="zeros"),
    }


def _img_kv(p, img, eps):
    """The image tokens' K (normed) and V [B, I, KV, hd]."""
    k = rms_norm(_proj_heads(img, p["wk"]), p["k_norm"], eps)
    return k, _proj_heads(img, p["wv"])


def _cross_core(cfg: ArchConfig, p, x, k_img, v_img):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q = rms_norm(_proj_heads(h, p["wq"]), p["q_norm"], cfg.norm_eps)
    q = constrain(q, "batch", "act_seq", "heads", None)
    o = _out_proj(cross_attention(q, k_img, v_img), p["wo"])
    x = x + torch.tanh(p["gate_attn"]) * o
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + torch.tanh(p["gate_ffn"]) * swiglu(h2, p["wg"], p["wi"], p["wo2"])
    return constrain(x, "batch", "act_seq", None)


def _cross_apply(cfg: ArchConfig, p, x, ctx: BlockCtx) -> torch.Tensor:
    return _cross_core(cfg, p, x, *_img_kv(p, ctx.img, cfg.norm_eps))


def _cross_prefill(cfg: ArchConfig, p, x, ctx: BlockCtx, cache):
    """Apply + write the image K/V into this layer's cache slice."""
    k_img, v_img = _img_kv(p, ctx.img, cfg.norm_eps)
    return _cross_core(cfg, p, x, k_img, v_img), _store(cache, k=k_img, v=v_img)


def _cross_decode(cfg: ArchConfig, p, x, cache, ctx: BlockCtx):
    """x [B,1,d] against the image K/V that prefill cached."""
    return _cross_core(cfg, p, x, cache["k"], cache["v"]), cache


def _cross_cache_template(cfg: ArchConfig, B: int, ctx: BlockCtx):
    KV, hd, I = cfg.n_kv_heads, cfg.hd, cfg.n_image_tokens
    spec = PT((B, I, KV, hd), ("batch", None, "kv_heads", None), init="zeros")
    return {"k": spec, "v": spec}


CROSS_BLOCK = Block(
    kind="cross",
    template=_cross_template,
    apply=_cross_apply,
    prefill=_cross_prefill,
    decode=_cross_decode,
    cache_template=_cross_cache_template,
)


# ---------------------------------------------------------------------------
# hybrid block (Hymba): parallel attention + Mamba heads on the same input,
# outputs normalized and fused, then dense FFN.
# ---------------------------------------------------------------------------

def _dt_rank(cfg: ArchConfig) -> int:
    return max(1, -(-cfg.d_model // 16))


def _hybrid_template(cfg: ArchConfig) -> Dict[str, Any]:
    d, H, KV, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    di = cfg.ssm_expand * d
    n, K, dtr = cfg.ssm_state, cfg.ssm_conv, _dt_rank(cfg)
    return {
        "ln1": PT((d,), (None,), init="ones"),
        # attention branch
        "wq": PT((d, H, hd), ("embed", "heads", None), fan_in=d),
        "wk": PT((d, KV, hd), ("embed", "kv_heads", None), fan_in=d),
        "wv": PT((d, KV, hd), ("embed", "kv_heads", None), fan_in=d),
        "wo": PT((H, hd, d), ("heads", None, "embed"), fan_in=H * hd),
        "norm_attn": PT((d,), (None,), init="ones"),
        # mamba branch
        "w_in": PT((d, 2 * di), ("embed", "ssm_inner")),
        "conv_w": PT((di, K), ("ssm_inner", None), init="small"),
        "w_x": PT((di, dtr + 2 * n), ("ssm_inner", None)),
        "w_dt": PT((dtr, di), (None, "ssm_inner")),
        "b_dt": PT((di,), ("ssm_inner",), init="small"),
        "a_log": PT((di, n), ("ssm_inner", None), init="small"),
        "d_skip": PT((di,), ("ssm_inner",), init="ones"),
        "wo_m": PT((di, d), ("ssm_inner", "embed")),
        "norm_ssm": PT((d,), (None,), init="ones"),
        # fusion + FFN
        "ln2": PT((d,), (None,), init="ones"),
        "wg": PT((d, f), ("embed", "ff")),
        "wi": PT((d, f), ("embed", "ff")),
        "wo2": PT((f, d), ("ff", "embed")),
    }


def _hybrid_mamba(cfg: ArchConfig, p, h, state: Optional[MambaState] = None,
                  decode: bool = False):
    """Mamba heads on the normed input h [B,S,d] -> (out [B,S,d], state)."""
    with span("hybrid.mamba", timed=True):
        x_in, z = constrain(dense(h, p["w_in"]), "batch", None, "ssm_inner").chunk(2, dim=-1)
        args = (x_in, z, p["conv_w"], p["w_x"], p["w_dt"], p["b_dt"], p["a_log"],
                p["d_skip"])
        kw = dict(n_state=cfg.ssm_state, dt_rank=_dt_rank(cfg), state=state)
        if decode:
            y, st = mamba_decode_mix(*args, **kw)
        else:
            y, st = mamba_mix(*args, return_state=True, **kw)
        return dense(y, p["wo_m"]), st


def _hybrid_fuse(cfg: ArchConfig, p, x, o_attn, o_ssm):
    with span("hybrid.ffn"):
        fused = 0.5 * (rms_norm(o_attn, p["norm_attn"], cfg.norm_eps)
                       + rms_norm(o_ssm, p["norm_ssm"], cfg.norm_eps))
        x = constrain(x + fused, "batch", "act_seq", None)
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        return constrain(x + swiglu(h2, p["wg"], p["wi"], p["wo2"]), "batch", "act_seq", None)


def _hybrid_core(cfg: ArchConfig, p, x, ctx: BlockCtx):
    h = constrain(rms_norm(x, p["ln1"], cfg.norm_eps), "batch", "act_seq", None)
    with span("hybrid.attn"):
        q, k, v = _qkv(cfg, p, h, ctx.rope)
        o = attention(q, k, v, causal=True, window=ctx.window, n_sink=ctx.n_sink)
        o_attn = _out_proj(o, p["wo"])
    o_ssm, st = _hybrid_mamba(cfg, p, h)
    return _hybrid_fuse(cfg, p, x, o_attn, o_ssm), k, v, st


def _hybrid_apply(cfg: ArchConfig, p, x, ctx: BlockCtx) -> torch.Tensor:
    return _hybrid_core(cfg, p, x, ctx)[0]


def _hybrid_cache_template(cfg: ArchConfig, B: int, ctx: BlockCtx):
    di = cfg.ssm_expand * cfg.d_model
    c = _attn_cache_template(cfg, B, ctx)
    c["conv"] = PT((B, di, cfg.ssm_conv - 1), ("batch", "ssm_inner", None),
                   init="zeros", dtype="float32")
    c["ssm"] = PT((B, di, cfg.ssm_state), ("batch", "ssm_inner", None),
                  init="zeros", dtype="float32")
    return c


def _hybrid_prefill(cfg: ArchConfig, p, x, ctx: BlockCtx, cache):
    x, k, v, st = _hybrid_core(cfg, p, x, ctx)
    _pack_attn_cache(k, v, cache, ctx)
    return x, _store(cache, conv=st.conv, ssm=st.ssm)


def _hybrid_decode(cfg: ArchConfig, p, x, cache, ctx: BlockCtx):
    """x [B,1,d]; cache {k,v [B,W,KV,hd], conv [B,di,K-1], ssm [B,di,n]}."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    with span("hybrid.attn"):
        o_attn = _decode_attn_out(cfg, p, h, cache, ctx)
    st = MambaState(conv=cache["conv"], ssm=cache["ssm"])
    o_ssm, st = _hybrid_mamba(cfg, p, h, state=st, decode=True)
    x = _hybrid_fuse(cfg, p, x, o_attn, o_ssm)
    # the states stay f32 in the cache, as the reference's prefill stores them
    return x, _store(cache, conv=st.conv, ssm=st.ssm)


HYBRID_BLOCK = Block(
    kind="hybrid",
    template=_hybrid_template,
    apply=_hybrid_apply,
    prefill=_hybrid_prefill,
    decode=_hybrid_decode,
    cache_template=_hybrid_cache_template,
)


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM): the cell is the whole layer (no separate FFN)
# ---------------------------------------------------------------------------

def _mlstm_template(cfg: ArchConfig) -> Dict[str, Any]:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    return {
        "ln": PT((d,), (None,), init="ones"),
        "wq": PT((d, H, hd), ("embed", "heads", None), fan_in=d),
        "wk": PT((d, H, hd), ("embed", "heads", None), fan_in=d),
        "wv": PT((d, H, hd), ("embed", "heads", None), fan_in=d),
        "w_if": PT((d, H, 2), ("embed", "heads", None), init="small"),
        "b_if": PT((H, 2), ("heads", None), init="zeros"),
        "wz": PT((d, d), ("embed", None)),
        "norm_cell": PT((d,), (None,), init="ones"),
        "wo": PT((d, d), (None, "embed")),
    }


def _mlstm_io(cfg: ArchConfig, p, x):
    h = constrain(rms_norm(x, p["ln"], cfg.norm_eps), "batch", "act_seq", None)
    q, k, v = (_proj_heads(h, p[w]) for w in ("wq", "wk", "wv"))
    gates = _proj_heads(h, p["w_if"]) + p["b_if"]            # [B,S,H,2]
    return q, k, v, gates[..., 0], gates[..., 1], dense(h, p["wz"])


def _mlstm_out(cfg: ArchConfig, p, x, hc, z):
    B, S = z.shape[0], z.shape[1]
    hc = rms_norm(hc.reshape(B, S, cfg.d_model), p["norm_cell"], cfg.norm_eps)
    out = hc * F.silu(z.float()).to(hc.dtype)
    return constrain(x + dense(out, p["wo"]), "batch", "act_seq", None)


def _mlstm_apply(cfg: ArchConfig, p, x, ctx: BlockCtx) -> torch.Tensor:
    q, k, v, ig, fg, z = _mlstm_io(cfg, p, x)
    return _mlstm_out(cfg, p, x, mlstm_chunked(q, k, v, ig, fg), z)


def _mlstm_cache_template(cfg: ArchConfig, B: int, ctx: BlockCtx):
    H, hd = cfg.n_heads, cfg.hd
    return {
        "C": PT((B, H, hd, hd), ("batch", "heads", None, None), init="zeros",
                dtype="float32"),
        "n": PT((B, H, hd), ("batch", "heads", None), init="zeros", dtype="float32"),
        "m": PT((B, H), ("batch", "heads"), init="neg_inf", dtype="float32"),
    }


def _mlstm_prefill(cfg: ArchConfig, p, x, ctx: BlockCtx, cache):
    q, k, v, ig, fg, z = _mlstm_io(cfg, p, x)
    hc, (C, n, m) = mlstm_chunked(q, k, v, ig, fg, return_state=True)
    return _mlstm_out(cfg, p, x, hc, z), _store(cache, C=C, n=n, m=m)


def _mlstm_decode(cfg: ArchConfig, p, x, cache, ctx: BlockCtx):
    q, k, v, ig, fg, z = _mlstm_io(cfg, p, x)
    hc, (C, n, m) = mlstm_decode_step(q, k, v, ig, fg, (cache["C"], cache["n"], cache["m"]))
    return _mlstm_out(cfg, p, x, hc, z), _store(cache, C=C, n=n, m=m)


MLSTM_BLOCK = Block(
    kind="mlstm",
    template=_mlstm_template,
    apply=_mlstm_apply,
    prefill=_mlstm_prefill,
    decode=_mlstm_decode,
    cache_template=_mlstm_cache_template,
)


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM): sequential scalar-memory cell + gated FFN
# ---------------------------------------------------------------------------

def _slstm_template(cfg: ArchConfig) -> Dict[str, Any]:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    f2 = 2 * d
    return {
        "ln": PT((d,), (None,), init="ones"),
        "w_gates": PT((d, H, 4, hd), ("embed", "heads", None, None), fan_in=d),
        "b_gates": PT((H, 4, hd), ("heads", None, None), init="zeros"),
        "r_gates": PT((H, hd, 4, hd), ("heads", None, None, None), init="small"),
        "norm_cell": PT((d,), (None,), init="ones"),
        "wo": PT((d, d), (None, "embed")),
        "ln2": PT((d,), (None,), init="ones"),
        "wg": PT((d, f2), ("embed", "ff")),
        "wi": PT((d, f2), ("embed", "ff")),
        "wo2": PT((f2, d), ("ff", "embed")),
    }


def _slstm_gates(cfg: ArchConfig, p, x):
    """'bsd,dhgk->bshgk' + bias: the gates' input part [B,S,H,4,hd]."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    d = p["w_gates"].shape[0]
    gx = dense(h, p["w_gates"].reshape(d, -1)).unflatten(-1, p["w_gates"].shape[1:])
    return gx + p["b_gates"]


def _slstm_post(cfg: ArchConfig, p, x, hs):
    B, S = x.shape[0], x.shape[1]
    hc = rms_norm(hs.reshape(B, S, cfg.d_model), p["norm_cell"], cfg.norm_eps)
    x = x + dense(hc, p["wo"])
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return constrain(x + swiglu(h2, p["wg"], p["wi"], p["wo2"]), "batch", "act_seq", None)


def _slstm_apply(cfg: ArchConfig, p, x, ctx: BlockCtx) -> torch.Tensor:
    hs, _ = slstm_scan(_slstm_gates(cfg, p, x), p["r_gates"])
    return _slstm_post(cfg, p, x, hs)


def _slstm_cache_template(cfg: ArchConfig, B: int, ctx: BlockCtx):
    def leaf(init):
        return PT((B, cfg.n_heads, cfg.hd), ("batch", "heads", None), init=init,
                  dtype="float32")
    return {"c": leaf("zeros"), "n": leaf("ones"), "h": leaf("zeros"), "m": leaf("neg_inf")}


def _slstm_prefill(cfg: ArchConfig, p, x, ctx: BlockCtx, cache):
    hs, (c, n, h, m) = slstm_scan(_slstm_gates(cfg, p, x), p["r_gates"])
    return _slstm_post(cfg, p, x, hs), _store(cache, c=c, n=n, h=h, m=m)


def _slstm_decode(cfg: ArchConfig, p, x, cache, ctx: BlockCtx):
    hs, (c, n, h, m) = slstm_decode_step(
        _slstm_gates(cfg, p, x), p["r_gates"],
        (cache["c"], cache["n"], cache["h"], cache["m"]))
    return _slstm_post(cfg, p, x, hs), _store(cache, c=c, n=n, h=h, m=m)


SLSTM_BLOCK = Block(
    kind="slstm",
    template=_slstm_template,
    apply=_slstm_apply,
    prefill=_slstm_prefill,
    decode=_slstm_decode,
    cache_template=_slstm_cache_template,
)

BLOCKS: Dict[str, Block] = {
    b.kind: b for b in (ATTN_BLOCK, CROSS_BLOCK, HYBRID_BLOCK, MLSTM_BLOCK, SLSTM_BLOCK)}
