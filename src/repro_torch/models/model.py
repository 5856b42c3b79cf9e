"""Model assembly: configs -> segments -> forward/prefill/decode programs.

Counterpart of ``repro/models/model.py`` for the dense family
(``[attn x L]``). A scanned segment (``jax.lax.scan`` over stacked params in
the reference) is a Python loop over the leading dim of the stacked tensors.
Parameters are a plain tree of tensors with the reference's paths:
``{"embed", "segments": [{<stacked block params>}], "final_norm"[, "head"]}``.
The KV cache is ``{"pos": int, "segments": [{"k", "v": [L,B,W,KV,hd]}]}``,
preallocated and updated in place by ``prefill`` and ``decode_step``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .blocks import BLOCKS, BlockCtx, rope_at, stackify
from .layers import PT, init_params, map_templates, rms_norm, rope_table

__all__ = ["Model", "Segment", "plan_segments", "build_model"]


@dataclass(frozen=True)
class Segment:
    """A stack of ``n`` identical blocks (params stacked on a leading dim)."""
    kind: str                  # block kind
    n: int                     # number of layers in this segment
    window: int = 0
    causal: bool = True


def plan_segments(cfg: ArchConfig) -> List[Segment]:
    if cfg.family == "dense":
        return [Segment("attn", cfg.n_layers, window=cfg.sliding_window)]
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (dense only)")


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    return {k: v[i] for k, v in tree.items()}


class Model:
    """One architecture's program set, built from its ArchConfig."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.segments = plan_segments(cfg)

    # ------------------------------------------------------------------
    # parameter templates
    # ------------------------------------------------------------------
    def template(self) -> Dict[str, Any]:
        cfg = self.cfg
        d = cfg.d_model
        t: Dict[str, Any] = {
            "embed": PT((cfg.padded_vocab, d), (None, "embed"), fan_in=d),
            "segments": [stackify(BLOCKS[seg.kind].template(cfg), seg.n)
                         for seg in self.segments],
            "final_norm": PT((d,), (None,), init="ones"),
        }
        if not cfg.tie_embeddings:
            t["head"] = PT((d, cfg.padded_vocab), ("embed", "vocab"), fan_in=d)
        return t

    def init(self, generator: torch.Generator, dtype: torch.dtype = torch.bfloat16,
             device=None):
        """Random parameters from ``generator`` (drawn on its device)."""
        return init_params(self.template(), generator, dtype, device)

    # ------------------------------------------------------------------
    # cache templates
    # ------------------------------------------------------------------
    def cache_template(self, B: int, smax: int) -> Dict[str, Any]:
        return {"segments": [
            stackify(BLOCKS[seg.kind].cache_template(self.cfg, B,
                                                     self._ctx(seg, smax=smax)),
                     seg.n)
            for seg in self.segments]}

    def init_cache(self, B: int, smax: int, dtype: torch.dtype = torch.bfloat16,
                   device=None):
        """Zeroed cache at ``pos`` 0."""
        def zeros(t: PT):
            return torch.zeros(t.shape, dtype=t.resolve_dtype(dtype), device=device)

        cache = map_templates(zeros, self.cache_template(B, smax))
        cache["pos"] = 0
        return cache

    # ------------------------------------------------------------------
    # forward paths
    # ------------------------------------------------------------------
    def _ctx(self, seg: Segment, rope=None, pos=None, smax: int = 0) -> BlockCtx:
        return BlockCtx(rope=rope, window=seg.window, causal=seg.causal,
                        pos=pos, smax=smax)

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        x = F.embedding(tokens, params["embed"])
        if self.cfg.scale_emb != 1.0:
            x = x * self.cfg.scale_emb
        return x

    def _rope_for(self, S: int, device):
        return rope_table(S, self.cfg.hd, self.cfg.rope_theta, device)

    def forward(self, params, batch) -> torch.Tensor:
        """Embedding -> all segments -> final norm. Returns [B, S, d]."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        rope = self._rope_for(x.shape[1], x.device)
        for seg, p in zip(self.segments, params["segments"]):
            ctx = self._ctx(seg, rope=rope)
            blk = BLOCKS[seg.kind]
            for i in range(seg.n):
                x = blk.apply(cfg, _layer(p, i), x, ctx)
        return rms_norm(x, params["final_norm"], cfg.norm_eps)

    # -- serving ----------------------------------------------------------
    def _logits(self, params, h_last: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.tie_embeddings:
            logits = F.linear(h_last, params["embed"])
        else:
            logits = h_last @ params["head"]
        logits = logits.float()
        if cfg.dim_model_base:
            logits = logits * (1.0 / (cfg.d_model / cfg.dim_model_base))
        return logits

    def prefill(self, params, batch, smax: int):
        """Process the prompt; returns (last-token logits [B,V] f32, cache).

        The cache is allocated here at capacity ``smax``, in the dtype of
        the parameters, and holds the prompt's K/V in its first slots.
        """
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        B, S = x.shape[0], x.shape[1]
        rope = self._rope_for(S, x.device)
        cache = self.init_cache(B, smax, x.dtype, x.device)
        for seg, p, c in zip(self.segments, params["segments"], cache["segments"]):
            ctx = self._ctx(seg, rope=rope, smax=smax)
            blk = BLOCKS[seg.kind]
            for i in range(seg.n):
                x, _ = blk.prefill(cfg, _layer(p, i), x, ctx, _layer(c, i))
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        cache["pos"] = S
        return self._logits(params, h[:, -1]), cache

    def decode_step(self, params, cache, tokens: torch.Tensor):
        """One decode step. tokens [B,1] -> (logits [B,V] f32, cache).

        The cache is updated in place and returned with ``pos`` advanced.
        """
        cfg = self.cfg
        pos = cache["pos"]
        x = self._embed(params, tokens)
        rope = rope_at(pos, cfg.hd, cfg.rope_theta, x.device)
        for seg, p, c in zip(self.segments, params["segments"], cache["segments"]):
            ctx = self._ctx(seg, rope=rope, pos=pos)
            blk = BLOCKS[seg.kind]
            for i in range(seg.n):
                x, _ = blk.decode(cfg, _layer(p, i), x, _layer(c, i), ctx)
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        cache["pos"] = pos + 1
        return self._logits(params, h[:, 0]), cache


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
