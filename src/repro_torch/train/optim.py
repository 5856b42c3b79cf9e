"""Optimizer: AdamW with f32 moments + LR schedules (cosine, WSD).

Counterpart of ``repro/train/optim.py`` on trees (dicts and lists) of
tensors. Moments live in float32 beside every parameter. The step counter,
the bias corrections ``b1 ** t`` and ``b2 ** t`` and the schedules are
computed in f32 tensors, as the reference computes them.

Unlike the reference, which is pure, ``adamw_update`` writes the new
parameters and moments IN PLACE into the trees it is given (and returns
them), so a step allocates no second copy of the parameters and moments.

Weight decay is decoupled and applies to every STORED leaf of two or more
dims: a stacked segment's norm weight [L, d] is decayed, as in the
reference, because the port keeps the reference's stacked layout.

WSD (warmup-stable-decay) is the MiniCPM schedule: linear warmup, long
stable plateau, short exponential decay tail.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

__all__ = [
    "adamw_init",
    "adamw_update",
    "global_norm",
    "clip_by_global_norm",
    "cosine_schedule",
    "wsd_schedule",
    "tree_leaves",
    "tree_map",
]


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts and lists, dict keys sorted (the
    order of ``jax.tree_util`` leaves)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of trees of the same structure,
    in the order of ``tree_leaves``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in tree order) of each leaf's f32 sum
    of squares."""
    sq = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
    return torch.sqrt(sq)


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), norm


def adamw_init(params) -> Dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    leaf = tree_leaves(params)[0]
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


@torch.no_grad()
def adamw_update(params, grads, opt_state: Dict, lr: torch.Tensor, *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[Dict, Dict]:
    step = opt_state["step"] + 1
    t = step.float()
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t

    def upd(p, g, m, v):
        g32 = g.float()
        m.copy_(b1 * m + (1 - b1) * g32)
        v.copy_(b2 * v + (1 - b2) * g32 * g32)
        delta = (m / c1) / (torch.sqrt(v / c2) + eps)
        if p.dim() >= 2:                   # decoupled weight decay on matrices only
            delta = delta + weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))

    tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    opt_state["step"] = step
    return params, opt_state


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> Callable:
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = peak_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, peak_lr * cos)

    return lr


def wsd_schedule(peak_lr: float, warmup: int, total: int,
                 decay_frac: float = 0.1, floor_frac: float = 0.01) -> Callable:
    """MiniCPM warmup-stable-decay: plateau at peak, exp decay tail."""
    decay_steps = max(int(total * decay_frac), 1)
    stable_end = total - decay_steps

    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = peak_lr * s / max(warmup, 1)
        d = torch.clamp((s - stable_end) / decay_steps, 0.0, 1.0)
        # log in f32, as jnp.log of the Python float
        tail = peak_lr * torch.exp(torch.log(torch.tensor(floor_frac, device=s.device)) * d)
        return torch.where(s < warmup, warm,
                           torch.where(s < stable_end, torch.full_like(s, peak_lr), tail))

    return lr
