"""Mixture-of-Experts FFN on one device: top-k routing, the dense oracle and
one-hot dispatch.

Counterpart of ``repro/models/moe.py``:

``router_topk``  softmax over experts (f32) of logits computed in the
                 activation dtype, top-k, gates renormalised.
``moe_dense``    every expert on every token, combined by a [T, E] weight
                 that is exactly 0 for the experts a token was not routed
                 to: the reference's oracle, and what its ``moe_ffn``
                 computes on one device. The port's serve and train paths
                 run it.
``moe_onehot``   capacity, rank within each expert and one-hot dispatch and
                 combine einsums (tokens past an expert's capacity are
                 dropped). The reference's ``constrain`` does nothing
                 outside a sharding-rules context, and the port has none.
                 The reference calls it only from ``moe_ffn`` under
                 sharding rules with ``moe_impl == "ep"``; in the port
                 nothing calls it until that distributed path comes.

``moe_ep`` and ``_bucket_by`` (expert parallelism over ``all_to_all``) wait
for the port's distributed slice. The expert products are batched matrix
products (``torch.matmul``), as the reference leaves its einsums to XLA.

Ties: ``jax.lax.top_k`` puts the lower index first among equal values and
``torch.topk`` promises no order, so the top k here come from a stable
descending sort. In bf16, with 128 experts, equal probabilities at the
k-th place are common; without the rule a token would reach other experts
than in the reference.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["router_topk", "moe_dense", "moe_onehot", "moe_ffn"]


def router_topk(x: torch.Tensor, w_router: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [T,d] -> (gates [T,k] f32 renormalised, ids [T,k] int64, probs [T,E]
    f32). Among equal probabilities the lower expert id comes first."""
    probs = torch.softmax((x @ w_router).float(), dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :k], ids[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, ids, probs


def _expert_ffn(x: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor
                ) -> torch.Tensor:
    """Batched-expert SwiGLU: x [E,C,d], weights [E,d,f] / [E,f,d] -> [E,C,d];
    silu in f32, cast back before the product with the up projection."""
    g = torch.matmul(x, wg)
    u = torch.matmul(x, wi)
    h = F.silu(g.float()).to(x.dtype) * u
    return torch.matmul(h, wo)


def moe_dense(x: torch.Tensor, w_router: torch.Tensor, we_gate: torch.Tensor,
              we_up: torch.Tensor, we_down: torch.Tensor, *, k: int) -> torch.Tensor:
    """Every expert on every token, combined by the routing weights. x [T,d]."""
    T, d = x.shape
    E = w_router.shape[-1]
    gates, ids, _ = router_topk(x, w_router, k)
    comb = torch.zeros((T, E), dtype=torch.float32, device=x.device).scatter_add(1, ids, gates)
    ys = _expert_ffn(x.expand(E, T, d), we_gate, we_up, we_down)      # [E,T,d]
    return torch.einsum("te,etd->td", comb.to(x.dtype), ys)


def moe_onehot(x: torch.Tensor, w_router: torch.Tensor, we_gate: torch.Tensor,
               we_up: torch.Tensor, we_down: torch.Tensor, *, k: int, n_experts: int,
               capacity_factor: float) -> torch.Tensor:
    """One-hot dispatch into [E, C, d] expert buffers of capacity C; a token
    past its expert's capacity contributes nothing. x [T,d]."""
    T, d = x.shape
    E = n_experts
    gates, ids, _ = router_topk(x, w_router, k)                      # [T,k]
    cap = int(max(4, -(-(T * k * capacity_factor) // E)))
    # rank of each (token, slot) within its expert: the earlier assignments
    # to the same expert, in flattened [T*k] order
    flat_ids = ids.reshape(-1)                                       # [T*k]
    onehot = F.one_hot(flat_ids, E)                                  # [T*k, E]
    rank = ((onehot.cumsum(0) - onehot) * onehot).sum(-1)            # [T*k]
    keep = rank < cap
    disp = (onehot.to(x.dtype)[:, :, None]
            * F.one_hot(torch.where(keep, rank, cap), cap + 1).to(x.dtype)[:, None, :cap])
    comb = disp * gates.reshape(-1)[:, None, None].to(x.dtype)       # [T*k, E, C]
    x_rep = x.repeat_interleave(k, dim=0)                            # [T*k, d]
    xe = torch.einsum("sec,sd->ecd", disp, x_rep)                    # [E,C,d]
    ye = _expert_ffn(xe, we_gate, we_up, we_down)                    # [E,C,d]
    y = torch.einsum("sec,ecd->sd", comb, ye)                        # [T*k, d]
    return y.reshape(T, k, d).sum(dim=1)


def moe_ffn(x: torch.Tensor, w_router: torch.Tensor, we_gate: torch.Tensor,
            we_up: torch.Tensor, we_down: torch.Tensor, *, k: int) -> torch.Tensor:
    """The MoE FFN of one device: ``moe_dense`` over the tokens of x
    [B,S,d], as the reference's ``moe_ffn`` computes it without sharding
    rules."""
    B, S, d = x.shape
    return moe_dense(x.reshape(-1, d), w_router, we_gate, we_up, we_down, k=k).reshape(B, S, d)
