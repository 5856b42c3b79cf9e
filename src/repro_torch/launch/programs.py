"""Shared program builder: (arch x shape x mesh) -> a program over a mesh.

Counterpart of ``repro/launch/programs.py``: one construction path for the
dry-run (on empty tensors), the train and serve drivers and the card's
checks (real data). A ``Program`` holds the function, its arguments as
empty tensors, and the partition specs (and DTensor placements) of its
inputs and outputs. There is no ``jit``/``lower``: ``fn`` runs eagerly on
DTensors placed by ``place``, and the dry-run (``launch/dryrun.py``) runs
it on fake tensors in place of lowering.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..bridge import place
from ..configs.base import ArchConfig, ShapeSpec
from ..distributed.sharding import P, ShardingRules, mesh_sizes, placements, rules_for, use_rules
from ..models.layers import abstract_params
from ..models.model import Model, build_model
from ..serve.engine import make_decode_fn, make_prefill_fn
from ..train.loop import abstract_state, batch_pspecs, make_train_step, state_pspecs

__all__ = ["Program", "build_program", "rules_for_arch", "tree_placements"]


def tree_placements(specs, mesh):
    """A tree of partition specs as a tree of DTensor placements."""
    if isinstance(specs, P):
        return placements(specs, mesh)
    if isinstance(specs, dict):
        return {k: tree_placements(v, mesh) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(tree_placements(v, mesh) for v in specs)
    return specs


@dataclass
class Program:
    name: str
    fn: Callable
    abstract_args: Tuple
    in_specs: Tuple
    out_specs: Any
    model: Model
    rules: ShardingRules

    @property
    def in_placements(self):
        return tree_placements(self.in_specs, self.rules.mesh)

    @property
    def out_placements(self):
        return tree_placements(self.out_specs, self.rules.mesh)

    def place(self, *args, src_data_rank: Optional[int] = 0) -> Tuple:
        """Concrete arguments (plain tensors of the abstract args' shapes)
        as DTensors laid out by ``in_specs``."""
        return tuple(place(a, s, self.rules.mesh, src_data_rank=src_data_rank)
                     for a, s in zip(args, self.in_specs))


def rules_for_arch(cfg: ArchConfig, mesh, *, serving: bool = False) -> ShardingRules:
    fsdp = True
    if serving:
        # serving memory planner: replicate weights over 'data' (no per-layer
        # FSDP all-gathers in each decode step) unless the TP-sharded
        # parameters alone would crowd the device's memory
        msize = mesh_sizes(mesh).get("model", 1)
        per_chip_param_bytes = 2.0 * cfg.param_count() / max(msize, 1)
        fsdp = per_chip_param_bytes > 8e9
    return rules_for(mesh, n_heads=cfg.n_heads, n_experts=cfg.n_experts, d_ff=cfg.d_ff,
                     moe=cfg.is_moe, fsdp=fsdp)


def build_program(cfg: ArchConfig, shape: ShapeSpec, mesh, *, microbatches: int = 1,
                  compress: bool = False, remat: bool = True,
                  model_kw: Optional[Dict] = None) -> Program:
    rules = rules_for_arch(cfg, mesh, serving=shape.kind != "train")
    model = build_model(cfg, remat=remat, **(model_kw or {}))
    batch_abs = abstract_params(model.batch_template(shape))
    batch_ps = batch_pspecs(model, shape, rules)

    if shape.kind == "train":
        fn = make_train_step(model, rules, microbatches=microbatches, compress=compress)
        st_ps = state_pspecs(model, rules, compress=compress)
        return Program(
            name=f"train_step[{cfg.name}/{shape.name}]",
            fn=fn,
            abstract_args=(abstract_state(model, compress=compress), batch_abs),
            in_specs=(st_ps, batch_ps),
            out_specs=(st_ps, {"loss": P(), "grad_norm": P(), "lr": P()}),
            model=model,
            rules=rules,
        )

    params_abs = model.abstract()
    params_ps = model.pspecs(rules)
    if shape.kind == "prefill":
        smax = shape.seq_len
        if cfg.encoder_only:
            # encoder "prefill" = full forward; no cache exists
            def enc_fn(params, batch):
                with torch.no_grad(), use_rules(rules):
                    return model.forward(params, batch)

            return Program(
                name=f"encode[{cfg.name}/{shape.name}]",
                fn=enc_fn,
                abstract_args=(params_abs, batch_abs),
                in_specs=(params_ps, batch_ps),
                out_specs=None,
                model=model,
                rules=rules,
            )
        cache_ps = model.cache_pspecs(shape.global_batch, smax, rules)
        return Program(
            name=f"prefill[{cfg.name}/{shape.name}]",
            fn=make_prefill_fn(model, smax, rules=rules),
            abstract_args=(params_abs, batch_abs),
            in_specs=(params_ps, batch_ps),
            out_specs=(P(rules.table.get("batch"), rules.table.get("vocab")), cache_ps),
            model=model,
            rules=rules,
        )

    # decode: one token against a cache of capacity seq_len
    smax = shape.seq_len
    B = shape.global_batch
    cache_ps = model.cache_pspecs(B, smax, rules)
    batch_guard = rules.table.get("batch")
    if batch_guard is not None and B % max(rules.axis_size("batch"), 1) != 0:
        batch_guard = None
    return Program(
        name=f"decode[{cfg.name}/{shape.name}]",
        fn=make_decode_fn(model, rules=rules),
        abstract_args=(params_abs, model.abstract_cache(B, smax),
                       torch.empty((B, 1), dtype=torch.int32, device="meta")),
        in_specs=(params_ps, cache_ps, P(batch_guard, None)),
        out_specs=(P(batch_guard, rules.table.get("vocab")), cache_ps),
        model=model,
        rules=rules,
    )

