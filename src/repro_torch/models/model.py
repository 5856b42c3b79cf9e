"""Model assembly: configs -> segments -> forward/prefill/decode programs.

Counterpart of ``repro/models/model.py`` for two families:

  dense            [attn x L]
  hybrid (Hymba)   [SWA-hybrid runs] + [global-attention hybrid singles]

A scanned segment (``jax.lax.scan`` over stacked params in the reference)
is a Python loop over the leading dim of the stacked tensors; a single
segment keeps unstacked params and caches, as in the reference. Parameters
are a plain tree of tensors with the reference's paths:
``{"embed"[, "meta"], "segments": [{<block params>}], "final_norm"[, "head"]}``.
The cache is ``{"pos": int, "segments": [{"k", "v"[, "conv", "ssm"]}]}``,
preallocated and updated in place by ``prefill`` and ``decode_step``.
Hymba prepends ``n_meta_tokens`` learned meta tokens to every prompt: they
are the sinks of its windowed layers, ``forward`` returns [B, S+M, d], and
``pos`` counts real tokens only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .blocks import BLOCKS, BlockCtx, rope_at, stackify
from .layers import PT, init_params, map_templates, rms_norm, rope_table

__all__ = ["Model", "Segment", "plan_segments", "build_model"]


@dataclass(frozen=True)
class Segment:
    """``n`` identical blocks: stacked on a leading dim when ``scanned``,
    else one block with unstacked params and cache."""
    kind: str                  # block kind
    n: int                     # number of layers in this segment
    scanned: bool
    window: int = 0
    n_sink: int = 0
    causal: bool = True


def _runs(total: int, singles: Tuple[int, ...]):
    """Split [0, total) into (is_single, start, length) runs."""
    out = []
    i = 0
    for s in sorted(singles):
        if s > i:
            out.append((False, i, s - i))
        out.append((True, s, 1))
        i = s + 1
    if i < total:
        out.append((False, i, total - i))
    return out


def plan_segments(cfg: ArchConfig) -> List[Segment]:
    if cfg.family == "dense":
        return [Segment("attn", cfg.n_layers, True, window=cfg.sliding_window)]
    if cfg.family == "hybrid":
        return [Segment("hybrid", 1, False) if single else
                Segment("hybrid", n, True, window=cfg.sliding_window,
                        n_sink=cfg.n_meta_tokens)
                for single, _, n in _runs(cfg.n_layers, cfg.global_attn_layers)]
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (dense and hybrid only)")


def _layers(seg: Segment, tree) -> Iterator[Dict[str, Any]]:
    """The per-layer trees of a segment: views into a stacked tree, or the
    single block's own tree."""
    if not seg.scanned:
        yield tree
        return
    for i in range(seg.n):
        yield {k: v[i] for k, v in tree.items()}


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
            "segments": [self._stack(seg, BLOCKS[seg.kind].template(cfg))
                         for seg in self.segments],
            "final_norm": PT((d,), (None,), init="ones"),
        }
        if cfg.n_meta_tokens:
            t["meta"] = PT((cfg.n_meta_tokens, d), (None, None), init="small")
        if not cfg.tie_embeddings:
            t["head"] = PT((d, cfg.padded_vocab), ("embed", "vocab"), fan_in=d)
        return t

    @staticmethod
    def _stack(seg: Segment, tmpl):
        return stackify(tmpl, seg.n) if seg.scanned else tmpl

    def init(self, generator: torch.Generator, dtype: torch.dtype = torch.bfloat16,
             device=None):
        """Random parameters from ``generator`` (drawn on its device)."""
        return init_params(self.template(), generator, dtype, device)

    # ------------------------------------------------------------------
    # cache templates
    # ------------------------------------------------------------------
    def cache_template(self, B: int, smax: int) -> Dict[str, Any]:
        smax_tot = smax + self.cfg.n_meta_tokens
        return {"segments": [
            self._stack(seg, BLOCKS[seg.kind].cache_template(
                self.cfg, B, self._ctx(seg, smax=smax_tot)))
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
        return BlockCtx(rope=rope, window=seg.window, n_sink=seg.n_sink,
                        causal=seg.causal, pos=pos, smax=smax)

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        x = F.embedding(tokens, params["embed"])
        if self.cfg.scale_emb != 1.0:
            x = x * self.cfg.scale_emb
        return x

    def _embed_prompt(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """Token embeddings with the meta tokens (if any) prepended."""
        x = self._embed(params, tokens)
        if self.cfg.n_meta_tokens:
            meta = params["meta"].to(x.dtype).expand(x.shape[0], -1, -1)
            x = torch.cat([meta, x], dim=1)
        return x

    def _rope_for(self, S: int, device):
        return rope_table(S, self.cfg.hd, self.cfg.rope_theta, device)

    def forward(self, params, batch) -> torch.Tensor:
        """Embedding -> all segments -> final norm. Returns [B, S(+M), d]."""
        cfg = self.cfg
        x = self._embed_prompt(params, batch["tokens"])
        rope = self._rope_for(x.shape[1], x.device)
        for seg, p in zip(self.segments, params["segments"]):
            ctx = self._ctx(seg, rope=rope)
            blk = BLOCKS[seg.kind]
            for lp in _layers(seg, p):
                x = blk.apply(cfg, lp, x, ctx)
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

        The cache is allocated here at capacity ``smax`` (plus the meta
        tokens), in the dtype of the parameters (SSM states in f32), and
        holds the prompt's K/V in its first or ring slots.
        """
        cfg = self.cfg
        x = self._embed_prompt(params, batch["tokens"])
        B, S = x.shape[0], x.shape[1]
        rope = self._rope_for(S, x.device)
        cache = self.init_cache(B, smax, x.dtype, x.device)
        for seg, p, c in zip(self.segments, params["segments"], cache["segments"]):
            ctx = self._ctx(seg, rope=rope)
            blk = BLOCKS[seg.kind]
            for lp, lc in zip(_layers(seg, p), _layers(seg, c)):
                x, _ = blk.prefill(cfg, lp, x, ctx, lc)
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        # pos counts REAL tokens (meta prefix excluded); decode adds the meta
        # offset back for absolute positions and cache slots
        cache["pos"] = S - cfg.n_meta_tokens
        return self._logits(params, h[:, -1]), cache

    def decode_step(self, params, cache, tokens: torch.Tensor):
        """One decode step. tokens [B,1] -> (logits [B,V] f32, cache).

        The cache is updated in place and returned with ``pos`` advanced.
        """
        cfg = self.cfg
        pos = cache["pos"] + cfg.n_meta_tokens    # absolute, meta included
        x = self._embed(params, tokens)
        rope = rope_at(pos, cfg.hd, cfg.rope_theta, x.device)
        for seg, p, c in zip(self.segments, params["segments"], cache["segments"]):
            ctx = self._ctx(seg, rope=rope, pos=pos)
            blk = BLOCKS[seg.kind]
            for lp, lc in zip(_layers(seg, p), _layers(seg, c)):
                x, _ = blk.decode(cfg, lp, x, lc, ctx)
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        cache["pos"] += 1
        return self._logits(params, h[:, 0]), cache


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
