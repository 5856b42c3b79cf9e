"""Shared layer primitives + the parameter-template machinery.

Counterpart of ``repro/models/layers.py``. Every model family declares its
parameters as a tree (dicts and lists) of ``PT`` records — the port's own
copy of the JAX package's template — from which we derive:

  * ``init_params``      — the tensors, drawn with the same init laws
  * ``abstract_params``  — tensors with no storage (``meta``, or fake ones
    under a ``FakeTensorMode``) for the dry-run
  * ``param_pspecs``     — partition specs from the logical axes, and
    ``param_placements``, the same as DTensor placements over the mesh

Parameters and caches are plain trees of tensors (DTensors over a mesh under
sharding rules) with the same paths as the JAX package's pytrees.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..distributed.sharding import (ShardingRules, active_rules, bind_rules, constrain,
                                    kernel_placements, local_offset, on_shards, placements,
                                    spec_of, to_mesh)
from ..kernels.rmsnorm.ops import rmsnorm

__all__ = [
    "PT",
    "map_templates",
    "init_params",
    "abstract_params",
    "param_pspecs",
    "param_placements",
    "const_leaf",
    "rms_norm",
    "rope_table",
    "apply_rope",
    "swiglu",
    "cross_entropy_chunked",
    "remat_call",
    "dense",
    "column_parallel",
    "row_parallel",
]

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32}


@dataclass(frozen=True)
class PT:
    """Parameter/state template: shape + logical axes + init law (+dtype)."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"       # normal | zeros | ones | small | neg_inf
    fan_in: int = 0            # 0 -> last-but-one dim (normal init scale)
    dtype: str = ""            # "" = caller default (cache states: "float32")

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")

    def resolve_dtype(self, default: torch.dtype) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype] if self.dtype else default


def map_templates(fn: Callable[[PT], Any], tree):
    """Apply ``fn`` to every PT leaf, in sorted-key order (the order of
    ``jax.tree_util`` leaves), keeping the dict/list structure."""
    if isinstance(tree, PT):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_templates(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_templates(fn, t) for t in tree)
    raise TypeError(f"unexpected template node {type(tree).__name__}")


# a normal leaf of more elements than this is drawn one slice of its first
# axis at a time, into the destination tensor: a whole f32 draw and its
# scaled copy of qwen3-moe-30b-a3b's stacked expert leaf [48, 128, 2048, 768]
# would take 77 GB. Every leaf of smollm, minicpm, qwen2 and hymba lies
# below it, so their values are those of one draw per leaf; above it lie the
# expert leaves and qwen3-32b's stacked FFN leaves (8.4 G elements, whose
# whole draw never fitted on one card).
SLICED_DRAW_ELEMS = 1 << 30


# the init laws that draw nothing: the fill value of each
CONST_INITS = {"zeros": 0.0, "ones": 1.0, "neg_inf": -1e30}


def const_leaf(t: PT, dtype: torch.dtype, device=None) -> torch.Tensor:
    """A leaf of a constant init law (``CONST_INITS``: every cache leaf),
    in its own dtype, ``dtype`` where it names none."""
    return torch.full(t.shape, CONST_INITS[t.init], dtype=t.resolve_dtype(dtype),
                      device=device)


def init_params(template, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16, device=None):
    """Materialise a template: normal draws scaled by 1/sqrt(fan_in) (x0.1
    for "small"), zeros, ones or -1e30, drawn in f32 on the generator's
    device and cast to the leaf's dtype. One draw per leaf in tree order;
    a leaf above ``SLICED_DRAW_ELEMS`` elements takes one draw per slice of
    its first axis, in order."""
    device = torch.device(device) if device is not None else generator.device

    def draw(shape, scale: float, dt: torch.dtype) -> torch.Tensor:
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (x * scale).to(device=device, dtype=dt)

    def make(t: PT) -> torch.Tensor:
        dt = t.resolve_dtype(dtype)
        if t.init in CONST_INITS:
            return const_leaf(t, dtype, device)
        fan = t.fan_in or (t.shape[-2] if len(t.shape) >= 2 else t.shape[-1])
        scale = 1.0 / math.sqrt(max(fan, 1))
        if t.init == "small":
            scale *= 0.1
        if math.prod(t.shape) <= SLICED_DRAW_ELEMS:
            return draw(t.shape, scale, dt)
        out = torch.empty(t.shape, dtype=dt, device=device)
        for i in range(t.shape[0]):
            out[i] = draw(t.shape[1:], scale, dt)
        return out

    return map_templates(make, template)


def abstract_params(template, dtype: torch.dtype = torch.bfloat16, device="meta"):
    """Every leaf as an empty tensor of its shape and dtype on ``device``:
    no storage on ``meta``; a fake tensor when a ``FakeTensorMode`` is
    active."""
    return map_templates(
        lambda t: torch.empty(t.shape, dtype=t.resolve_dtype(dtype), device=device), template)


def param_pspecs(template, rules: ShardingRules):
    """PT -> partition spec, leaving any non-divisible dim unsharded (the
    same guard ``constrain`` applies to activations)."""
    return map_templates(lambda t: spec_of(t.shape, t.axes, rules), template)


def param_placements(template, rules: ShardingRules):
    """PT -> DTensor placements over ``rules.mesh`` (``param_pspecs`` by mesh
    dim)."""
    return map_templates(lambda t: placements(spec_of(t.shape, t.axes, rules), rules.mesh),
                         template)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim, f32 math, result in x.dtype (the fused
    rmsnorm kernel on the card)."""
    return rmsnorm(x, scale, eps)


def rope_table(seq_len: int, head_dim: int, theta: float, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [seq_len, head_dim/2], float32."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=device) / half))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    ang = torch.outer(t, freqs)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, hd]; cos/sin [S, hd/2] (broadcast over batch/heads)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def column_parallel(fn, x: DTensor, w: torch.Tensor) -> DTensor:
    """``fn(x_local, w_local)`` for ``x [..., d] @ w [d, f, ...]`` on each
    rank's shards: x's leading dims as they are split (d whole), w's dim 1
    split where x does not use that mesh dim and whole elsewhere; the
    output [..., f, ...] split as x's rows and w's dim 1. A DTensor product
    may choose to split the columns over more ranks than heads, or flatten
    rows split over two mesh dims, which no rule takes."""
    mesh = x.device_mesh
    w = to_mesh(w, mesh)
    xp = kernel_placements(x, range(x.ndim - 1))
    wp = [Replicate() if isinstance(a, Shard) or b != Shard(1) else b
          for a, b in zip(xp, w.placements)]
    op = [a if isinstance(a, Shard) else Shard(x.ndim - 1) if b == Shard(1) else Replicate()
          for a, b in zip(xp, wp)]
    return on_shards(fn, mesh, (x, w), (xp, wp), op)


def row_parallel(fn, x: DTensor, w: torch.Tensor) -> DTensor:
    """``fn(x_local, w_local)`` for ``x [..., k] @ w [k, n]`` with x's
    contracted dim split: each rank contracts its slice of k against the
    same slice of w's rows (w's columns whole), x's leading dims as they
    are split. The output [..., n] is a pending sum over the mesh dims that
    split k (GSPMD's row-parallel product: no rank gathers the hidden)."""
    mesh, nd = x.device_mesh, x.ndim
    w = to_mesh(w, mesh)
    xp = kernel_placements(x, range(nd))
    wp = [Shard(0) if a == Shard(nd - 1) else Replicate() for a in xp]
    op = [Partial() if a == Shard(nd - 1) else a for a in xp]
    return on_shards(fn, mesh, (x, w), (xp, wp), op)


def dense(x: torch.Tensor, w: torch.Tensor,
          out: Optional[Tuple[Optional[str], ...]] = None) -> torch.Tensor:
    """``x [..., d] @ w [d, f]``. Under rules of the sequence-parallel
    regime (``act_seq`` mapped), or on a DTensor split on more than one
    leading dim, a product on local shards, in the forward and so in the
    backward: flattening a batch split over 'data' and a sequence split
    over 'model' into one matrix row dim is a layout DTensor's matrix
    product has no rule for. With x's contracted dim split (the FFN's down
    projection, the Mamba x and out projections) it is row-parallel
    (``row_parallel``); otherwise column-parallel (``column_parallel``).
    Elsewhere it is DTensor's product (or the plain one). A product that
    leaves a pending sum (a contracted dim split) has it reduced here into
    the logical layout ``out`` (default: the residual stream's, ``("batch",
    "act_seq", None)``: a reduce-scatter over a split sequence, else an
    all-reduce), before anything adds to it, as GSPMD's program does: a
    pending sum met by a replicated operand is otherwise left to DTensor's
    rule for the add, which differs between torch versions."""
    if not isinstance(x, DTensor) or x.ndim < 3:
        return x @ w
    rules = active_rules()
    split = {p.dim % x.ndim for p in x.placements if isinstance(p, Shard)}
    if len(split - {x.ndim - 1}) > 1 or (rules is not None
                                         and rules.table.get("act_seq") is not None):
        y = (row_parallel if x.ndim - 1 in split else column_parallel)(torch.matmul, x, w)
    else:
        y = x @ w
    if isinstance(y, DTensor) and any(p.is_partial() for p in y.placements):
        y = constrain(y, *(out or ("batch", "act_seq") + (None,) * (x.ndim - 2)))
    return y


def swiglu(x: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor,
           wo: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: (silu(x@wg) * (x@wi)) @ wo, TP-sharded on the hidden dim."""
    g = dense(x, wg)
    u = dense(x, wi)
    h = F.silu(g.float()).to(x.dtype) * u
    if h.ndim == 3:
        h = constrain(h, "batch", "act_seq", "ff")
    return dense(h, wo)


def remat_call(fn, *args):
    """``torch.utils.checkpoint`` (non-reentrant) of ``fn(*args)``; under
    sharding rules the recomputation, which may run on the autograd
    engine's own thread, sees the same rules."""
    rules = active_rules()
    if rules is None:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), bind_rules(rules)))


def _target_logit(logits: DTensor, labels: torch.Tensor) -> DTensor:
    """The label's logit of DTensor logits [B,S,V] split over the vocabulary:
    each rank gathers it from its own vocabulary slice and reads 0 where
    the label lies outside it, a pending sum over the vocabulary's mesh dims
    (the value of the reference's one-hot contraction, with no [B,S,V]
    one-hot; a gather along a split dim has no working DTensor rule)."""
    mesh, nd = logits.device_mesh, logits.ndim
    out = [Partial() if isinstance(p, Shard) and p.dim % nd == nd - 1 else
           p if isinstance(p, Shard) else Replicate() for p in logits.placements]
    lab = [p if isinstance(p, Shard) else Replicate() for p in out]
    off = local_offset(logits, nd - 1)

    def gather(lg, lx):
        rel = lx.long() - off
        inside = (rel >= 0) & (rel < lg.shape[-1])
        got = lg.gather(-1, rel.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
        return torch.where(inside, got, torch.zeros((), dtype=got.dtype, device=got.device))

    return on_shards(gather, mesh, (logits, labels),
                     (kernel_placements(logits, range(nd)), lab), out)


def _ce_chunk(hx: torch.Tensor, lm_head: torch.Tensor, lx: torch.Tensor,
              mx: torch.Tensor, logit_scale: float) -> torch.Tensor:
    """Summed masked NLL of one chunk: f32 logits, logsumexp over the
    (padded) vocabulary, the target logit by ``gather`` (the value of the
    reference's one-hot contraction)."""
    logits = constrain(dense(hx, lm_head), "batch", None, "vocab").float() * logit_scale
    lse = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):
        tgt = _target_logit(logits, lx)
    else:
        tgt = logits.gather(-1, lx.long()[..., None])[..., 0]
    return ((lse - tgt) * mx).sum()


def cross_entropy_chunked(h: torch.Tensor, lm_head: torch.Tensor, labels: torch.Tensor, *,
                          logit_scale: float = 1.0, n_chunks: int = 8,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Memory-bounded mean cross entropy of h [B,S,d] @ lm_head [d,V]
    against labels [B,S] (counterpart of
    ``repro/models/layers.py::cross_entropy_chunked``): the sequence is cut
    into ``n_chunks`` chunks (fewer if they do not divide S), and each
    chunk's loss runs under ``torch.utils.checkpoint``, so its [B,Sc,V] f32
    logits are recomputed in the backward and never alive for the whole
    sequence at once."""
    B, S, _ = h.shape
    while S % n_chunks:
        n_chunks -= 1
    Sc = S // n_chunks
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
    remat = torch.is_grad_enabled()
    lm_head = constrain(lm_head, None, "vocab")      # vocab-parallel logits (the tied embed.T)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        sl = slice(i * Sc, (i + 1) * Sc)
        mx = mask[:, sl].float()
        args = (h[:, sl], lm_head, labels[:, sl], mx, logit_scale)
        nll = remat_call(_ce_chunk, *args) if remat else _ce_chunk(*args)
        tot = tot + nll
        cnt = cnt + mx.sum()
    return tot / cnt.clamp_min(1.0)
