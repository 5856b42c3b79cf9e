"""Dispatching wrapper for the list schedule (counterpart of
``repro/core/vectorized.py::_schedule_many_stats_impl``).

``list_schedule(feats, ints, params, n_units, repeats)`` takes the packed
task records of ``ref.py`` and K parameter vectors and returns (makespan
[K], busy [K, 4]) in f32, both times ``repeats``. Engine classes must lie
in [0, 4) and units in [0, n_units); the caller checks them. A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.
``variant`` forces one of ``ref.VARIANTS`` in place of the plan's choice
(to time and test each). On the card the plan is the C side's own
(``kernel.kernel_plan``); the global variant's scratch ``done`` and
``free`` are allocated only when it runs. ``list_schedule.launches``
counts kernel launches and nothing else, ``list_schedule.variant_launches``
the same by variant. The kernel has no backward: on the card, a call
under autograd with feats or params requiring grad raises rather than
return a result without a gradient path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernel import kernel_plan, list_schedule_cuda
from .ref import FEATS, INT_COLS, N_CLASSES, N_PARAMS, VARIANTS, list_schedule_ref

__all__ = ["list_schedule"]


def list_schedule(feats: torch.Tensor, ints: torch.Tensor, params: torch.Tensor,
                  n_units: int, repeats: int = 1, variant: Optional[str] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    N, K = feats.shape[0], params.shape[0]
    if (feats.shape != (N, len(FEATS)) or ints.shape != (N, INT_COLS)
            or params.shape != (K, N_PARAMS)):
        raise ValueError(f"list_schedule: want feats [N, {len(FEATS)}], ints "
                         f"[N, {INT_COLS}], params [K, {N_PARAMS}]; got "
                         f"{tuple(feats.shape)}, {tuple(ints.shape)}, "
                         f"{tuple(params.shape)}")
    if feats.dtype != torch.float32 or params.dtype != torch.float32 \
            or ints.dtype != torch.int32:
        raise TypeError("list_schedule: want feats and params f32, ints int32")
    if N == 0 or K == 0 or n_units < 1:
        raise ValueError(f"list_schedule: nothing to schedule (N {N}, K {K}, "
                         f"units {n_units})")
    if not (ints.device == params.device == feats.device):
        raise ValueError("list_schedule: feats, ints and params must share a device")
    if feats.device.type == "cpu":
        return list_schedule_ref(feats, ints, params, n_units, repeats)
    if feats.device.type != "cuda":
        raise ValueError(f"list_schedule: unsupported device {feats.device}")
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"list_schedule: unknown variant {variant!r}")
    if torch.is_grad_enabled() and (feats.requires_grad or params.requires_grad):
        raise NotImplementedError("list_schedule has no backward kernel")
    feats, ints, params = feats.contiguous(), ints.contiguous(), params.contiguous()
    if feats.data_ptr() % 16 or ints.data_ptr() % 16:
        raise ValueError("list_schedule: feats and ints must be 16-byte aligned")
    dev = feats.device
    makespan = torch.empty((K,), dtype=torch.float32, device=dev)
    busy = torch.empty((K, N_CLASSES), dtype=torch.float32, device=dev)
    plan = kernel_plan(N, K, n_units, variant)
    done = free = None
    if plan.variant == "global":
        done = torch.empty((N, K), dtype=torch.float32, device=dev)
        free = torch.empty((n_units, K), dtype=torch.float32, device=dev)
    list_schedule_cuda(feats, ints, params, n_units, repeats, variant, done, free,
                       makespan, busy)
    list_schedule.launches += 1
    list_schedule.variant_launches[plan.variant] += 1
    return makespan, busy


list_schedule.launches = 0
list_schedule.variant_launches = dict.fromkeys(VARIANTS, 0)
