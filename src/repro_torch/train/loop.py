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
``optim.adamw_update``) and returns it. Sharding (``abstract_state``,
``state_pspecs``, ``batch_pspecs``) waits for the port's distributed slice.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..models.model import Model
from . import compress as compress_mod
from .optim import (adamw_init, adamw_update, clip_by_global_norm, cosine_schedule,
                    tree_leaves, tree_map, wsd_schedule)

__all__ = ["make_train_step", "init_state", "schedule_for"]


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


def _value_and_grad(model: Model, params, batch):
    """(loss, grads) of ``model.loss`` at ``params``: autograd through
    detached leaves that share the parameters' storage."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = model.loss(live, batch)
        grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
    return loss.detach(), tree_map(lambda _: next(grads), live)


def make_train_step(model: Model, *, lr_schedule: Optional[Callable] = None,
                    clip_norm: float = 1.0, weight_decay: float = 0.1,
                    microbatches: int = 1, compress: bool = False) -> Callable:
    lr_schedule = lr_schedule or schedule_for(model.cfg)

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        if microbatches > 1:
            mbs = [{k: v.reshape((microbatches, v.shape[0] // microbatches) + v.shape[1:])[i]
                    for k, v in batch.items()} for i in range(microbatches)]
            leaf = tree_leaves(params)[0]
            loss = torch.zeros((), dtype=torch.float32, device=leaf.device)
            gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
            for mb in mbs:
                mb_loss, grads = _value_and_grad(model, params, mb)
                loss = loss + mb_loss
                gacc = tree_map(lambda a, g: a.add_(g.float()), gacc, grads)
                del grads
            loss = loss / microbatches
            grads = tree_map(lambda g, p: (g / microbatches).to(p.dtype), gacc, params)
        else:
            loss, grads = _value_and_grad(model, params, batch)

        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        if compress:
            grads, state["ef"] = compress_mod.ef_compress_grads(grads, state["ef"])
        lr = lr_schedule(state["opt"]["step"])
        adamw_update(params, grads, state["opt"], lr, weight_decay=weight_decay)
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step
