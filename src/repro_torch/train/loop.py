"""Training step factory: loss -> grads -> (optional EF-compressed) update.

Counterpart of ``repro/train/loop.py``. ``make_train_step(model, ...)``
returns ``train_step(state, batch) -> (state, metrics)``, with autograd in
place of ``jax.value_and_grad``:

  * gradient accumulation over microbatches (a Python loop in place of
    ``lax.scan``, f32 accumulators; the loss is the microbatches' mean)
  * global-norm clipping, then int8 error-feedback compression (cross-pod
    DCN modelling), then the LR at ``opt["step"]``, then AdamW
  * cosine / WSD schedules (MiniCPM uses WSD per its paper)

The step updates ``state`` in place (parameters and moments; see
``optim.adamw_update``) and returns it. With sharding ``rules`` the step
runs under them (``use_rules``): the state and batch are DTensors laid out
by ``state_pspecs`` / ``batch_pspecs`` (``launch.programs`` places them),
and every tree operation of the step (clipping's global norm, AdamW's
in-place update) runs on DTensors of matching placements.
``abstract_state`` is the state as empty tensors, for the dry-run.

While a ``torch.profiler`` session records, spans (``obs/spans.py``) mark
the forward (``train.forward``), the backward with remat's recompute
(``train.backward``), clipping (``train.clip``), EF compression
(``train.compress``) and AdamW (``train.optimizer``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..device import resolve_device
from ..distributed.sharding import P, ShardingRules, use_rules
from ..models.layers import param_pspecs
from ..models.model import Model
from ..obs.spans import span
from . import compress as compress_mod
from .optim import (adamw_init, adamw_update, clip_by_global_norm, cosine_schedule,
                    tree_leaves, tree_map, wsd_schedule)

__all__ = ["make_train_step", "init_state", "abstract_state", "state_pspecs", "batch_pspecs",
           "schedule_for"]


def schedule_for(cfg: ArchConfig, peak_lr: float = 3e-4, warmup: int = 2000,
                 total: int = 100_000) -> Callable:
    if cfg.name.startswith("minicpm"):
        return wsd_schedule(peak_lr, warmup, total)
    return cosine_schedule(peak_lr, warmup, total)


def init_state(model: Model, generator: torch.Generator, *,
               dtype: torch.dtype = torch.bfloat16, compress: bool = False,
               device=None) -> Dict:
    """Random parameters from ``generator``, zero AdamW moments (and EF
    residuals), on ``device``: the card unless told otherwise."""
    params = model.init(generator, dtype, resolve_device(device))
    state = {"params": params, "opt": adamw_init(params)}
    if compress:
        state["ef"] = compress_mod.ef_init(params)
    return state


def abstract_state(model: Model, *, dtype: torch.dtype = torch.bfloat16,
                   compress: bool = False, device="meta") -> Dict:
    """The state as empty tensors (no storage on ``meta``; fake under a
    ``FakeTensorMode``): parameters in ``dtype``, f32 moments."""
    params = model.abstract(dtype, device)
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device=device)  # noqa: E731
    state = {"params": params,
             "opt": {"m": tree_map(f32, params), "v": tree_map(f32, params),
                     "step": torch.empty((), dtype=torch.int32, device=device)}}
    if compress:
        state["ef"] = tree_map(f32, params)
    return state


def state_pspecs(model: Model, rules: ShardingRules, *, compress: bool = False) -> Dict:
    ps = model.pspecs(rules)
    state = {"params": ps, "opt": {"m": ps, "v": ps, "step": P()}}
    if compress:
        state["ef"] = ps
    return state


def batch_pspecs(model: Model, shape: ShapeSpec, rules: ShardingRules):
    return param_pspecs(model.batch_template(shape), rules)


def _value_and_grad(model: Model, params, batch):
    """(loss, grads) of ``model.loss`` at ``params``: autograd through
    detached leaves that share the parameters' storage."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        with span("train.forward"):
            loss = model.loss(live, batch)
        with span("train.backward"):
            grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
    return loss.detach(), tree_map(lambda _: next(grads), live)


def make_train_step(model: Model, rules: Optional[ShardingRules] = None, *,
                    lr_schedule: Optional[Callable] = None, clip_norm: float = 1.0,
                    weight_decay: float = 0.1, microbatches: int = 1,
                    compress: bool = False) -> Callable:
    lr_schedule = lr_schedule or schedule_for(model.cfg)

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        with use_rules(rules):
            return _step(state, batch)

    def _step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        if microbatches > 1:
            mbs = [{k: v.reshape((microbatches, v.shape[0] // microbatches) + v.shape[1:])[i]
                    for k, v in batch.items()} for i in range(microbatches)]
            leaf = tree_leaves(params)[0]
            loss = torch.zeros((), dtype=torch.float32, device=leaf.device)
            gacc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            for mb in mbs:
                mb_loss, grads = _value_and_grad(model, params, mb)
                loss = loss + mb_loss
                gacc = tree_map(lambda a, g: a.add_(g.float()), gacc, grads)
                del grads
            loss = loss / microbatches
            grads = tree_map(lambda g, p: (g / microbatches).to(p.dtype), gacc, params)
        else:
            loss, grads = _value_and_grad(model, params, batch)

        with span("train.clip", timed=True):
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
        if compress:
            with span("train.compress"):
                grads, state["ef"] = compress_mod.ef_compress_grads(grads, state["ef"])
        lr = lr_schedule(state["opt"]["step"])
        with span("train.optimizer", timed=True):
            adamw_update(params, grads, state["opt"], lr, weight_decay=weight_decay)
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step
