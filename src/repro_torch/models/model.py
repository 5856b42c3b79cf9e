"""Model assembly: configs -> segments -> forward/prefill/decode programs.

Counterpart of ``repro/models/model.py`` for every family of the reference:

  dense, moe       [attn x L] (moe: the attention block's FFN is the MoE)
  audio (HuBERT)   [attn x L], non-causal, over input frames (no embedding)
  vlm              [vlm_group x G] (nested: ``inner`` self layers + 1 cross)
  ssm (xLSTM)      [mlstm runs] + [slstm singles] at cfg.slstm_layers
  hybrid (Hymba)   [SWA-hybrid runs] + [global-attention hybrid singles]

A scanned segment (``jax.lax.scan`` over stacked params in the reference)
is a Python loop over the leading dim of the stacked tensors; a single
segment keeps unstacked params and caches, as in the reference. A VLM group
segment stacks its self layers twice, ``[G, inner, ...]``, and its cross
layers once, ``[G, ...]``, as the reference's nested scan does. Parameters
are a plain tree of tensors with the reference's paths:
``{"embed" | "in_norm"[, "meta"], "segments": [...], "final_norm"[, "head"]}``.
The cache is ``{"pos": int, "segments": [...]}``, each leaf made by its
template's init (zeros, ones or -1e30: the xLSTM cells' stabilisers start
at -1e30, the sLSTM normaliser at 1), preallocated and updated in place by
``prefill`` and ``decode_step``. Hymba prepends ``n_meta_tokens`` learned
meta tokens to every prompt: they are the sinks of its windowed layers,
``forward`` returns [B, S+M, d], and ``pos`` counts real tokens only.

Inputs: ``batch["tokens"]`` [B, S]; the audio family reads
``batch["frames"]`` [B, S, d] instead (input norm, then fixed sinusoidal
positions), and the VLM also ``batch["images"]`` [B, I, d], cast to the
activation dtype. The audio family is an encoder: it has ``forward``,
``loss`` and ``prefill``, and ``decode_step`` refuses it, as the reference
has no such path (its decode reads ``params["embed"]``). The ssm and audio
families use no RoPE.

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
policy computes for it. A VLM group recomputes each self layer and the
whole group, nested as in the reference. Prefill and decode ignore remat.

Sharding: ``abstract``, ``pspecs``, ``batch_template``, ``abstract_cache``
and ``cache_pspecs`` are the reference's, with specs from
``distributed.sharding`` (``P``; ``layers.param_placements`` gives their
DTensor placements). Under sharding rules the parameters and batch are
DTensors, the ``constrain`` calls sit at the reference's sites, the cache
is allocated shard by shard by its specs, and a recomputed layer runs under
the rules of its forward (``layers.remat_call``: the backward of a CUDA
tensor runs on another thread, which sees no thread-local rules).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import math

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig, ShapeSpec
from ..distributed.sharding import P, active_rules, constrain, full_on_mesh, spec_of
from ..graph.capture import layer as capture_layer
from .blocks import BLOCKS, BlockCtx, rope_at, stackify
from .layers import (CONST_INITS, PT, abstract_params, const_leaf, cross_entropy_chunked,
                     init_params, map_templates, param_pspecs, remat_call,
                     rms_norm, rope_table)

__all__ = ["Model", "Segment", "plan_segments", "build_model", "REMAT_POLICIES"]

REMAT_POLICIES = ("full", "save-attn")


@dataclass(frozen=True)
class Segment:
    """``n`` identical blocks: stacked on a leading dim when ``scanned``,
    else one block with unstacked params and cache."""
    kind: str                  # block kind, or "vlm_group"
    n: int                     # number of layers (vlm_group: groups) in this segment
    scanned: bool
    window: int = 0
    n_sink: int = 0
    causal: bool = True
    inner: int = 0             # vlm_group: self layers per group


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
    if cfg.family == "audio":
        return [Segment("attn", cfg.n_layers, True, causal=False)]
    if cfg.family == "vlm":
        g = cfg.n_layers // (cfg.cross_attn_every + 1)
        return [Segment("vlm_group", g, True, inner=cfg.cross_attn_every)]
    if cfg.family == "ssm":
        return [Segment("slstm" if single else "mlstm", n, not single)
                for single, _, n in _runs(cfg.n_layers, cfg.slstm_layers)]
    if cfg.family == "hybrid":
        return [Segment("hybrid", 1, False) if single else
                Segment("hybrid", n, True, window=cfg.sliding_window,
                        n_sink=cfg.n_meta_tokens)
                for single, _, n in _runs(cfg.n_layers, cfg.global_attn_layers)]
    raise ValueError(f"unknown family {cfg.family!r}")


def _uses_rope(cfg: ArchConfig) -> bool:
    return cfg.family not in ("ssm", "audio")


def _unstack(tree, n: int) -> List[Any]:
    """The n trees of a tree stacked on its leading dim: views, one
    ``unbind`` per leaf, whose backward stacks the layers' gradients in one
    pass, where indexing would add a zero-filled [n, ...] gradient per
    layer."""
    cols = {k: (_unstack(v, n) if isinstance(v, dict) else v.unbind(0))
            for k, v in tree.items()}
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def _layers(seg: Segment, tree) -> List[Any]:
    """The per-layer (vlm_group: per-group) trees of a segment, or the
    single block's own tree."""
    return _unstack(tree, seg.n) if seg.scanned else [tree]


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
            "segments": [self._seg_tree(seg, lambda kind: BLOCKS[kind].template(cfg))
                         for seg in self.segments],
            "final_norm": PT((d,), (None,), init="ones"),
        }
        if cfg.family == "audio":
            # frontend stub: frames arrive at d_model; a learned input norm
            t["in_norm"] = PT((d,), (None,), init="ones")
        else:
            t["embed"] = PT((cfg.padded_vocab, d), (None, "embed"), fan_in=d)
        if cfg.n_meta_tokens:
            t["meta"] = PT((cfg.n_meta_tokens, d), (None, None), init="small")
        if not cfg.tie_embeddings:
            t["head"] = PT((d, cfg.padded_vocab), ("embed", "vocab"), fan_in=d)
        return t

    @staticmethod
    def _seg_tree(seg: Segment, make):
        """A segment's tree from ``make(kind)``, a block kind's template:
        stacked when scanned; a VLM group stacks the self layers' twice,
        ``[G, inner, ...]``, and the cross layer's once, ``[G, ...]``."""
        if seg.kind == "vlm_group":
            return {"self": stackify(stackify(make("attn"), seg.inner), seg.n),
                    "cross": stackify(make("cross"), seg.n)}
        t = make(seg.kind)
        return stackify(t, seg.n) if seg.scanned else t

    def init(self, generator: torch.Generator, dtype: torch.dtype = torch.bfloat16,
             device=None):
        """Random parameters from ``generator`` (drawn on its device)."""
        return init_params(self.template(), generator, dtype, device)

    def abstract(self, dtype: torch.dtype = torch.bfloat16, device="meta"):
        return abstract_params(self.template(), dtype, device)

    def pspecs(self, rules):
        return param_pspecs(self.template(), rules)

    # ------------------------------------------------------------------
    # batch templates (inputs)
    # ------------------------------------------------------------------
    def batch_template(self, shape: ShapeSpec) -> Dict[str, Any]:
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":             # one new token; the big inputs are the cache
            return {"tokens": PT((B, 1), ("batch", None), init="zeros", dtype="int32")}
        b: Dict[str, Any] = {}
        if shape.kind == "train":
            b["labels"] = PT((B, S), ("batch", None), init="zeros", dtype="int32")
        if cfg.family == "audio":
            b["frames"] = PT((B, S, cfg.d_model), ("batch", None, None))
        else:
            b["tokens"] = PT((B, S), ("batch", None), init="zeros", dtype="int32")
        if cfg.family == "vlm":
            b["images"] = PT((B, cfg.n_image_tokens, cfg.d_model), ("batch", None, None))
        return b

    # ------------------------------------------------------------------
    # cache templates
    # ------------------------------------------------------------------
    def cache_template(self, B: int, smax: int) -> Dict[str, Any]:
        cfg = self.cfg
        ctx = [self._ctx(seg, smax=smax + cfg.n_meta_tokens) for seg in self.segments]
        return {"segments": [
            self._seg_tree(seg, lambda kind, c=c: BLOCKS[kind].cache_template(cfg, B, c))
            for seg, c in zip(self.segments, ctx)]}

    def init_cache(self, B: int, smax: int, dtype: torch.dtype = torch.bfloat16,
                   device=None):
        """The cache at ``pos`` 0, each leaf filled by its template's init
        (zeros, ones or -1e30) in its own dtype (``dtype`` where the
        template names none). Under sharding rules each leaf is a DTensor
        laid out by ``cache_pspecs``, and each rank allocates its shard."""
        rules = active_rules()
        if rules is None:
            make = functools.partial(const_leaf, dtype=dtype, device=device)
        else:
            def make(t: PT):
                return full_on_mesh(t.shape, CONST_INITS[t.init], t.resolve_dtype(dtype), device,
                                    spec_of(t.shape, t.axes, rules), rules.mesh)
        cache = map_templates(make, self.cache_template(B, smax))
        cache["pos"] = 0
        return cache

    def abstract_cache(self, B: int, smax: int, dtype: torch.dtype = torch.bfloat16,
                       device="meta"):
        """The cache's leaves as empty tensors (``abstract``), at ``pos`` 0."""
        cache = abstract_params(self.cache_template(B, smax), dtype, device)
        cache["pos"] = 0
        return cache

    def cache_pspecs(self, B: int, smax: int, rules):
        """The cache's specs; ``pos`` is replicated (the reference's int32
        scalar; here a Python int)."""
        specs = param_pspecs(self.cache_template(B, smax), rules)
        specs["pos"] = P()
        return specs

    # ------------------------------------------------------------------
    # forward paths
    # ------------------------------------------------------------------
    def _ctx(self, seg: Segment, rope=None, img=None, pos=None, smax: int = 0) -> BlockCtx:
        return BlockCtx(rope=rope, window=seg.window, n_sink=seg.n_sink,
                        causal=seg.causal, img=img, pos=pos, smax=smax)

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        x = F.embedding(tokens, params["embed"])
        if self.cfg.scale_emb != 1.0:
            x = x * self.cfg.scale_emb
        return x

    def _embed_frames(self, params, frames: torch.Tensor) -> torch.Tensor:
        """Audio: the input norm, then fixed sinusoidal positions."""
        x = rms_norm(frames.to(params["in_norm"].dtype), params["in_norm"], self.cfg.norm_eps)
        S, d = x.shape[1], x.shape[2]
        pos = torch.arange(S, dtype=torch.float32, device=x.device)[:, None]
        div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=x.device)
                        * (-math.log(1e4) / d))
        pe = torch.zeros((S, d), dtype=torch.float32, device=x.device)
        pe[:, 0::2] = torch.sin(pos * div)
        pe[:, 1::2] = torch.cos(pos * div)
        return x + pe.to(x.dtype)[None]

    def _embed_prompt(self, params, batch) -> torch.Tensor:
        """The input embeddings (tokens, or audio frames) with the meta
        tokens (if any) prepended."""
        if self.cfg.family == "audio":
            x = self._embed_frames(params, batch["frames"])
        else:
            x = self._embed(params, batch["tokens"])
        if self.cfg.n_meta_tokens:
            # the embedding of a vocabulary split over ranks is a pending sum:
            # sum it before the concatenation, whose redistribution of such a
            # sum reads the data (no fake tensor holds any: the dry-run)
            x = constrain(x, "batch", None, None)
            meta = params["meta"].to(x.dtype).expand(x.shape[0], -1, -1)
            x = torch.cat([meta, x], dim=1)
        return constrain(x, "batch", "act_seq", None)

    def _rope_for(self, S: int, device):
        if not _uses_rope(self.cfg):
            return None
        return rope_table(S, self.cfg.hd, self.cfg.rope_theta, device)

    @staticmethod
    def _images(batch, x: torch.Tensor):
        img = batch.get("images")
        return None if img is None else img.to(x.dtype)

    def forward(self, params, batch) -> torch.Tensor:
        """Embedding -> all segments -> final norm. Returns [B, S(+M), d]."""
        cfg = self.cfg
        x = self._embed_prompt(params, batch)
        rope = self._rope_for(x.shape[1], x.device)
        img = self._images(batch, x)
        remat = self.remat and torch.is_grad_enabled()
        for seg, p in zip(self.segments, params["segments"]):
            ctx = self._ctx(seg, rope=rope, img=img)
            if seg.kind == "vlm_group":
                for gp in _layers(seg, p):
                    with capture_layer():
                        x = (remat_call(self._group, seg, gp, x, ctx, remat)
                             if remat else self._group(seg, gp, x, ctx, remat))
                continue
            blk = BLOCKS[seg.kind]
            for lp in _layers(seg, p):
                with capture_layer():
                    x = (self._remat_layer(blk, lp, x, ctx) if remat
                         else blk.apply(cfg, lp, x, ctx))
        return rms_norm(x, params["final_norm"], cfg.norm_eps)

    def _group(self, seg: Segment, gp, x, ctx: BlockCtx, remat: bool) -> torch.Tensor:
        """One VLM group: its self layers (each recomputed in the backward
        under ``remat``), then its cross layer."""
        attn = BLOCKS["attn"]
        for lp in _unstack(gp["self"], seg.inner):
            x = self._remat_layer(attn, lp, x, ctx) if remat else attn.apply(self.cfg, lp, x, ctx)
        return BLOCKS["cross"].apply(self.cfg, gp["cross"], x, ctx)

    def _remat_layer(self, blk, lp, x, ctx: BlockCtx) -> torch.Tensor:
        """One layer whose activations are recomputed in the backward."""
        cfg = self.cfg
        if self.remat_policy == "full" or blk.split is None:
            return remat_call(blk.apply, cfg, lp, x, ctx)
        first, mix, last = blk.split                # "save-attn"
        q, k, v = remat_call(first, cfg, lp, x, ctx)
        return remat_call(last, cfg, lp, x, mix(q, k, v, ctx))

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
        # keep the logits vocab-sharded (the reference's constraint)
        logits = constrain(logits.float(), "batch", "vocab")
        if cfg.dim_model_base:
            logits = logits * self._logit_scale()
        return logits

    def prefill(self, params, batch, smax: int):
        """Process the prompt; returns (last-token logits [B,V] f32, cache).

        The cache is allocated here at capacity ``smax`` (plus the meta
        tokens), in the dtype of the parameters (SSM and cell states in
        f32), and holds the prompt's K/V in its first or ring slots, the
        recurrent states after the prompt and the VLM's image K/V.
        """
        cfg = self.cfg
        x = self._embed_prompt(params, batch)
        B, S = x.shape[0], x.shape[1]
        rope = self._rope_for(S, x.device)
        img = self._images(batch, x)
        cache = self.init_cache(B, smax, x.dtype, x.device)
        for seg, p, c in zip(self.segments, params["segments"], cache["segments"]):
            ctx = self._ctx(seg, rope=rope, img=img)
            x = self._run_segment(seg, p, c, x, ctx, "prefill")
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        # pos counts REAL tokens (meta prefix excluded); decode adds the meta
        # offset back for absolute positions and cache slots
        cache["pos"] = S - cfg.n_meta_tokens
        return self._logits(params, h[:, -1]), cache

    def _run_segment(self, seg: Segment, p, c, x, ctx: BlockCtx, mode: str):
        """Prefill or decode (``mode``) of one segment's layers, each
        writing its cache slice in place."""
        cfg = self.cfg

        def step(blk, lp, lc, x):
            if mode == "prefill":
                return blk.prefill(cfg, lp, x, ctx, lc)[0]
            return blk.decode(cfg, lp, x, lc, ctx)[0]

        def group(lp, lc, x):
            for sp, sc in zip(_unstack(lp["self"], seg.inner), _unstack(lc["self"], seg.inner)):
                x = step(BLOCKS["attn"], sp, sc, x)
            return step(BLOCKS["cross"], lp["cross"], lc["cross"], x)

        for lp, lc in zip(_layers(seg, p), _layers(seg, c)):
            with capture_layer():          # a program capture's layer tag
                x = (group(lp, lc, x) if seg.kind == "vlm_group"
                     else step(BLOCKS[seg.kind], lp, lc, x))
        return x

    def decode_step(self, params, cache, tokens: torch.Tensor):
        """One decode step. tokens [B,1] -> (logits [B,V] f32, cache).

        The cache is updated in place and returned with ``pos`` advanced.
        """
        cfg = self.cfg
        if cfg.family == "audio":
            raise ValueError(f"{cfg.name}: the audio family is an encoder and has no decode "
                             f"step (use forward or prefill; the reference has no such path)")
        pos = cache["pos"] + cfg.n_meta_tokens    # absolute, meta included
        x = constrain(self._embed(params, tokens), "batch", None, None)
        rope = rope_at(pos, cfg.hd, cfg.rope_theta, x.device) if _uses_rope(cfg) else None
        for seg, p, c in zip(self.segments, params["segments"], cache["segments"]):
            x = self._run_segment(seg, p, c, x, self._ctx(seg, rope=rope, pos=pos), "decode")
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        cache["pos"] += 1
        return self._logits(params, h[:, 0]), cache


def build_model(cfg: ArchConfig, *, remat: bool = True, remat_policy: str = "full",
                ce_chunks: int = 8) -> Model:
    return Model(cfg, remat=remat, remat_policy=remat_policy, ce_chunks=ce_chunks)
