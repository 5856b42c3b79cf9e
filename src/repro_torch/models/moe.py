"""Mixture-of-Experts FFN: top-k routing with capacity, three
implementations.

Counterpart of ``repro/models/moe.py``:

``router_topk``  softmax over experts (f32) of logits computed in the
                 activation dtype, top-k, gates renormalised.
``moe_dense``    every expert on every token, combined by a [T, E] weight
                 that is exactly 0 for the experts a token was not routed
                 to: the oracle, and what ``moe_ffn`` runs without sharding
                 rules.
``moe_ep``       expert parallelism (the reference's ``shard_map`` body, on
                 each rank's local shards, ``distributed.sharding.on_shards``):
                 tokens are bucketed by destination rank with a stable sort
                 (``_bucket_by``), exchanged with ``all_to_all`` over the
                 expert-parallel mesh dim's process group, bucketed again by
                 local expert, run through the local experts as one batched
                 product, and returned. A (token, expert) pair past a
                 bucket's capacity contributes nothing (token dropping).
``moe_onehot``   capacity, rank within each expert and one-hot dispatch and
                 combine einsums: the EP path when the sequence does not
                 split over the EP axis (one-token decode on a wide mesh).

``moe_ffn`` dispatches as the reference does: under rules with
``moe_impl == "ep"``, ``moe_ep`` when S divides over the EP axis, else
``moe_onehot``; without rules, ``moe_dense``. The expert products are
batched matrix products (``torch.matmul``), as the reference leaves its
einsums to XLA.

Ties: ``jax.lax.top_k`` puts the lower index first among equal values and
``torch.topk`` promises no order, so the top k here come from a stable
descending sort. In bf16, with 128 experts, equal probabilities at the
k-th place are common; without the rule a token would reach other experts
than in the reference.

``DROP_STATS``: None, or a list to which every ``_moe_ep_local`` call
appends (the (token, expert) pairs this rank routed, the pairs its local
experts computed); summed over the ranks they give the share of pairs
dropped at capacity.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import Replicate

from ..distributed.sharding import (P, ShardingRules, active_rules, constrain,
                                    kernel_placements, mesh_sizes, on_shards, placements, to_mesh,
                                    whole)

__all__ = ["router_topk", "moe_dense", "moe_ep", "moe_onehot", "moe_ffn", "constrain_expert"]

DROP_STATS: Optional[List[Tuple[int, torch.Tensor]]] = None


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


def _bucket_by(dest: torch.Tensor, n_buckets: int, cap: int, src_ids: torch.Tensor):
    """Sort-based bucketing: (slot_src [n_buckets*cap] int32 index into the
    src arrays, -1 where empty; valid [n_buckets*cap] bool). dest [N] in
    [0, n_buckets); an element past its bucket's ``cap`` is dropped. The
    sort is stable, so a bucket keeps its first ``cap`` elements in order."""
    N = dest.shape[0]
    order = torch.argsort(dest, stable=True)
    sdest = dest[order]
    first = torch.searchsorted(sdest, torch.arange(n_buckets, device=dest.device,
                                                   dtype=sdest.dtype), side="left")
    rank = torch.arange(N, device=dest.device) - first[sdest]
    keep = rank < cap
    slot = sdest * cap + rank.clamp(max=cap - 1)
    # dropped elements all go to one extra slot, cut off after the write
    slot_src = torch.full((n_buckets * cap + 1,), -1, dtype=torch.int32, device=dest.device)
    slot_src[torch.where(keep, slot, n_buckets * cap)] = src_ids[order].to(torch.int32)
    slot_src = slot_src[:-1]
    return slot_src, slot_src >= 0


class _AllToAll(torch.autograd.Function):
    """``all_to_all`` of equal blocks along dim 0 over ``group``: block j
    goes to peer j, and block j of the result came from peer j (the
    reference's ``all_to_all(x, axis, 0, 0, tiled=False)``). Its own
    transpose, so the backward is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g.contiguous(), ctx.group), None


def _moe_ep_local(x: torch.Tensor, w_router: torch.Tensor, we_gate: torch.Tensor,
                  we_up: torch.Tensor, we_down: torch.Tensor, *, k: int, n_experts: int,
                  capacity_factor: float, axis_name=None) -> torch.Tensor:
    """Per-rank body. x [T_loc, d]; experts [E_loc, ...]; ``axis_name`` is
    the EP process group (None: a single shard, no exchange)."""
    T, d = x.shape
    E_loc = we_gate.shape[0]
    Pn = n_experts // E_loc                       # peers along the EP axis
    gates, ids, _ = router_topk(x, w_router, k)   # [T,k]
    flat_ids = ids.reshape(-1)                    # [T*k]
    flat_gate = gates.reshape(-1)
    flat_tok = torch.arange(T, device=x.device).repeat_interleave(k)
    dest = flat_ids // E_loc                      # owning peer
    cap = int(max(8, -(-(T * k * capacity_factor) // Pn)))
    cap = -(-cap // 8) * 8
    slot_src, valid = _bucket_by(dest, Pn, cap, torch.arange(T * k, device=x.device))
    src = torch.where(valid, slot_src, 0).long()

    gather_tok = torch.where(valid, flat_tok[src], 0)
    send_x = torch.where(valid[:, None], x[gather_tok], 0).reshape(Pn, cap, d)
    send_eid = torch.where(valid, flat_ids[src] % E_loc, -1).reshape(Pn, cap)

    if axis_name is not None:
        recv_x = _AllToAll.apply(send_x, axis_name)
        recv_eid = _AllToAll.apply(send_eid, axis_name)
    else:                                         # single-shard EP (tests)
        recv_x, recv_eid = send_x, send_eid
    recv_x = recv_x.reshape(Pn * cap, d)
    recv_eid = recv_eid.reshape(Pn * cap)

    # second bucketing: group received tokens by local expert
    C2 = -(-(Pn * cap) // E_loc)
    C2 = -(-C2 // 8) * 8
    eid_ok = torch.where(recv_eid >= 0, recv_eid, E_loc)   # invalid -> overflow bucket
    slot2, valid2 = _bucket_by(eid_ok, E_loc + 1, C2,
                               torch.arange(Pn * cap, device=x.device))
    slot2 = slot2[: E_loc * C2].long()
    valid2 = valid2[: E_loc * C2]
    if DROP_STATS is not None:
        DROP_STATS.append((T * k, valid2.sum()))
    xe = torch.where(valid2[:, None], recv_x[torch.where(valid2, slot2, 0)], 0)
    ye = _expert_ffn(xe.reshape(E_loc, C2, d), we_gate, we_up, we_down)   # [E_loc, C2, d]

    # return to recv-slot order (one extra row takes the empty slots), then
    # all_to_all back
    y_recv = torch.zeros((Pn * cap + 1, d), dtype=ye.dtype, device=x.device).index_put(
        (torch.where(valid2, slot2, Pn * cap),), ye.reshape(E_loc * C2, d))[:-1]
    y_send = y_recv.reshape(Pn, cap, d)
    y_back = _AllToAll.apply(y_send, axis_name) if axis_name is not None else y_send
    y_back = y_back.reshape(Pn * cap, d)

    # combine at source: out[tok] += gate * y  (dropped slots contribute 0)
    contrib = y_back * torch.where(valid, flat_gate[src], 0.0)[:, None].to(y_back.dtype)
    out = torch.zeros((T + 1, d), dtype=y_back.dtype, device=x.device)
    return out.index_add(0, torch.where(valid, gather_tok, T), contrib)[:T]


def moe_ep(x: torch.Tensor, w_router: torch.Tensor, we_gate: torch.Tensor,
           we_up: torch.Tensor, we_down: torch.Tensor, *, k: int, n_experts: int,
           capacity_factor: float, rules: ShardingRules) -> torch.Tensor:
    """Expert-parallel MoE over the EP mesh dim. x [B,S,d] global: inside,
    its batch split over the batch axes and its sequence over the EP axis,
    the experts split over the EP axis, the router replicated; the output
    in x's layout."""
    B, S, d = x.shape
    mesh = rules.mesh
    ep = rules.ep_axis
    x_pl = placements(P(rules.table.get("batch"), ep, None), mesh)
    w_pl = placements(P(ep), mesh)
    group = mesh.get_group(ep)

    def body(xx, wr, wg, wu, wd):
        return _moe_ep_local(xx.reshape(-1, d), wr, wg, wu, wd, k=k, n_experts=n_experts,
                             capacity_factor=capacity_factor,
                             axis_name=group).reshape(xx.shape)

    x = to_mesh(x, mesh)
    y = on_shards(body, mesh, (x, w_router, we_gate, we_up, we_down),
                  (x_pl, [Replicate()] * mesh.ndim, w_pl, w_pl, w_pl), x_pl)
    # back in x's layout, so that neither the output nor its gradient carries
    # the sequence split over the EP axis into the residual stream
    return y.redistribute(mesh, x.placements)


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
    xe = constrain_expert(torch.einsum("sec,sd->ecd", disp, x_rep))  # [E,C,d]
    ye = constrain_expert(_expert_ffn(xe, we_gate, we_up, we_down))  # [E,C,d]
    # the combine reads every expert's rows: on a mesh, gathered first (a
    # product over (e, c) flattened from a split e has no DTensor rule)
    y = torch.einsum("sec,ecd->sd", comb, whole(ye))                 # [T*k, d]
    return y.reshape(T, k, d).sum(dim=1)


def constrain_expert(xe: torch.Tensor) -> torch.Tensor:
    return constrain(xe, "expert", None, None)


def moe_ffn(x: torch.Tensor, w_router: torch.Tensor, we_gate: torch.Tensor,
            we_up: torch.Tensor, we_down: torch.Tensor, *, k: int, n_experts: int,
            capacity_factor: float) -> torch.Tensor:
    """Dispatch on the active sharding rules: ``moe_ep`` for token streams
    whose sequence splits over the EP axis, ``moe_onehot`` when it cannot
    (decode), ``moe_dense`` otherwise (on each rank's tokens under rules
    whose mesh does not split the experts). x [B,S,d] -> [B,S,d]."""
    rules = active_rules()
    B, S, d = x.shape
    if rules is not None and rules.moe_impl == "ep" and rules.ep_axis is not None:
        if S % mesh_sizes(rules.mesh)[rules.ep_axis] == 0:
            return moe_ep(x, w_router, we_gate, we_up, we_down, k=k, n_experts=n_experts,
                          capacity_factor=capacity_factor, rules=rules)
        y = moe_onehot(x.reshape(-1, d), w_router, we_gate, we_up, we_down, k=k,
                       n_experts=n_experts, capacity_factor=capacity_factor)
        return y.reshape(B, S, d)

    def dense(xx, *w):
        return moe_dense(xx.reshape(-1, d), *w, k=k).reshape(xx.shape)

    if rules is None:
        return dense(x, w_router, we_gate, we_up, we_down)
    # the oracle is a function of each token alone: each rank runs its own
    # tokens against the whole experts
    mesh = rules.mesh
    x_pl = kernel_placements(to_mesh(x, mesh), (0, 1))
    rep = [Replicate()] * mesh.ndim
    return on_shards(dense, mesh, (x, w_router, we_gate, we_up, we_down),
                     (x_pl, rep, rep, rep, rep), x_pl)
