"""Model assembly: configs -> segments -> forward/prefill/decode programs.

Counterpart of ``repro/models/model.py`` for three families:

  dense, moe       [attn x L] (moe: the attention block's FFN is the MoE)
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

Training: ``loss`` is the memory-bounded chunked cross entropy of the
forward. When grad is enabled and ``remat`` is set, ``forward`` recomputes
each layer in the backward (``torch.utils.checkpoint``, non-reentrant, in
place of ``jax.checkpoint``): policy "full" keeps nothing of a layer but
its input; "save-attn" keeps the attention's inputs and output, running the
layer as two checkpointed parts around the attention call (the reference
names that output for ``save_only_these_names``; a kernel launched through
``ctypes`` inside an autograd Function is invisible to
``create_selective_checkpoint_contexts``, so the cut is made by hand). A
block with no such cut (the hybrid block, whose reference names nothing)
runs under "save-attn" as under "full", which is what the reference's
policy computes for it. Prefill and decode ignore remat.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from .blocks import BLOCKS, BlockCtx, rope_at, stackify
from .layers import (PT, cross_entropy_chunked, init_params, map_templates, rms_norm,
                     rope_table)

__all__ = ["Model", "Segment", "plan_segments", "build_model", "REMAT_POLICIES"]

REMAT_POLICIES = ("full", "save-attn")


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
    if cfg.family in ("dense", "moe"):
        return [Segment("attn", cfg.n_layers, True, window=cfg.sliding_window)]
    if cfg.family == "hybrid":
        return [Segment("hybrid", 1, False) if single else
                Segment("hybrid", n, True, window=cfg.sliding_window,
                        n_sink=cfg.n_meta_tokens)
                for single, _, n in _runs(cfg.n_layers, cfg.global_attn_layers)]
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (the ssm, vlm and audio families "
        f"wait for later slices)")


def _layers(seg: Segment, tree) -> Iterator[Dict[str, Any]]:
    """The per-layer trees of a segment: views into a stacked tree (one
    ``unbind`` per leaf, whose backward stacks the layers' gradients in one
    pass, where indexing would add a zero-filled [n, ...] gradient per
    layer), or the single block's own tree."""
    if not seg.scanned:
        yield tree
        return
    cols = {k: v.unbind(0) for k, v in tree.items()}
    for i in range(seg.n):
        yield {k: c[i] for k, c in cols.items()}


class Model:
    """One architecture's program set, built from its ArchConfig."""

    def __init__(self, cfg: ArchConfig, *, remat: bool = True, remat_policy: str = "full",
                 ce_chunks: int = 8):
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r} not in {REMAT_POLICIES}")
        self.cfg = cfg
        self.segments = plan_segments(cfg)
        self.remat = remat
        self.remat_policy = remat_policy
        self.ce_chunks = ce_chunks

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
        remat = self.remat and torch.is_grad_enabled()
        for seg, p in zip(self.segments, params["segments"]):
            ctx = self._ctx(seg, rope=rope)
            blk = BLOCKS[seg.kind]
            for lp in _layers(seg, p):
                x = self._remat_layer(blk, lp, x, ctx) if remat else blk.apply(cfg, lp, x, ctx)
        return rms_norm(x, params["final_norm"], cfg.norm_eps)

    def _remat_layer(self, blk, lp, x, ctx: BlockCtx) -> torch.Tensor:
        """One layer whose activations are recomputed in the backward."""
        cfg = self.cfg
        if self.remat_policy == "full" or blk.split is None:
            return checkpoint(blk.apply, cfg, lp, x, ctx, use_reentrant=False)
        first, mix, last = blk.split                # "save-attn"
        q, k, v = checkpoint(first, cfg, lp, x, ctx, use_reentrant=False)
        return checkpoint(last, cfg, lp, x, mix(q, k, v, ctx), use_reentrant=False)

    # -- training loss --------------------------------------------------
    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token cross entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` (meta tokens dropped; tied head = embed.T;
        MiniCPM's logit scale 1 / (d / dim_model_base))."""
        cfg = self.cfg
        h = self.forward(params, batch)
        if cfg.n_meta_tokens:
            h = h[:, cfg.n_meta_tokens:]
        head = params["embed"].T if cfg.tie_embeddings else params["head"]
        return cross_entropy_chunked(h, head, batch["labels"], logit_scale=self._logit_scale(),
                                     n_chunks=self.ce_chunks)

    def _logit_scale(self) -> float:
        """MiniCPM's muP logit scale, 1 / (d / dim_model_base); 1 elsewhere."""
        cfg = self.cfg
        return 1.0 / (cfg.d_model / cfg.dim_model_base) if cfg.dim_model_base else 1.0

    # -- serving ----------------------------------------------------------
    def _logits(self, params, h_last: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.tie_embeddings:
            logits = F.linear(h_last, params["embed"])
        else:
            logits = h_last @ params["head"]
        logits = logits.float()
        if cfg.dim_model_base:
            logits = logits * self._logit_scale()
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


def build_model(cfg: ArchConfig, *, remat: bool = True, remat_policy: str = "full",
                ce_chunks: int = 8) -> Model:
    return Model(cfg, remat=remat, remat_policy=remat_policy, ce_chunks=ce_chunks)
