"""Dispatching wrapper for flash attention (counterpart of
``repro/kernels/flash_attention/ops.py::flash_mha``).

``flash_mha(q, k, v, causal=True, window=0, n_sink=0, q_off=0)`` takes the
model layout q [B,S,H,hd], k/v [B,Sk,KV,hd] and returns [B,S,H,hd] in
q.dtype. Under ``causal``, ``window > 0`` limits each row to its last
``window`` keys, and the first ``n_sink`` keys stay visible to every row
after them (``ref.py`` states the mask); ``q_off`` is the global index of
q's first row (a query shard against the whole K and V: row ``r`` of q is
row ``q_off + r`` of the mask). Every kernel takes ``q_off`` as a runtime
scalar in its predicates; at 0 each computes what it computed without it.
A CPU tensor takes the plain version; a CUDA tensor launches a kernel or
raises.

Dispatch on the card, by dtype and shape only: bf16 at hd 64, 80 (HuBERT's)
or 128 goes to the tensor-core kernel (``csrc/flash_attention_wgmma.cu``);
every other call (f32, whose products would run as TF32 on the tensor
cores, and bf16 at the reduced configs' hd 16/32) to the CUDA-core kernel
(``csrc/flash_attention.cu``: register-tiled f32 products, SIMT). The
tensor-core path raises on what it does not take (a pointer that is not
16-byte aligned), and nothing falls back to the CUDA-core kernel; with Sk
= 0 it launches nothing and returns the zero rows that the kernel's
contract gives.
``flash_mha.launches`` counts every forward kernel launch and nothing
else; ``flash_mha.wgmma_launches`` counts the tensor-core kernel's launches.

Under autograd (grad enabled and q, k or v requiring grad) the forward
launch runs inside ``_FlashFn``, a ``torch.autograd.Function``: the same
kernel, in its instance that also stores each row's logsumexp L (the serve
path, without grad, keeps the instance without it). It saves q, k, v, the
output and L; its backward launches ``csrc/flash_attention_bwd.cu`` (D, dK
and dV over a balanced grid as ordered partial sums, dQ, the partials'
sum: no atomics). bf16 at hd 64/80/128 (``WGMMA_BWD_HEAD_DIMS``, HuBERT's
hd 80 among them) runs its tensor-core kernels (16-byte aligned q, k, v,
else it raises), every other call (f32, bf16 at hd 16/32) its CUDA-core
ones. out and dout must be 16-byte aligned in every call. Every head dim
of ``HEAD_DIMS`` has both a forward and a backward kernel.
``flash_mha.bwd_launches`` counts backward calls, each one such launch;
``flash_mha.wgmma_bwd_launches`` those that ran the tensor-core kernels. On
the CPU the plain version's autograd is the backward.

DTensors (under sharding rules) run on each rank's local batch rows, heads
and query rows, K and V over the whole sequence (``_flash_on_shards``): the
kernel only ever sees plain local tensors, and a query shard passes its
first row as ``q_off``.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import Replicate, Shard

from ...distributed.sharding import (kernel_placements, local_offset, mesh_of, on_shards,
                                     to_mesh)
from .._build import DTYPE_CODES
from .kernel import (HEAD_DIMS, WGMMA_BWD_HEAD_DIMS, WGMMA_HEAD_DIMS,
                     flash_attention_bwd_cuda, flash_attention_cuda,
                     flash_attention_wgmma_cuda, lse_rows)
from .ref import flash_mha_ref

__all__ = ["flash_mha"]


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, n_sink: int = 0,
              q_off: int = 0) -> torch.Tensor:
    mesh = mesh_of(q, k, v)
    if mesh is not None:
        return _flash_on_shards(mesh, q, k, v, causal=causal, window=window, n_sink=n_sink,
                                q_off=q_off)
    if q.device.type == "cpu":
        return flash_mha_ref(q, k, v, causal=causal, window=window, n_sink=n_sink,
                             q_off=q_off)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_mha: want q [B,S,H,hd], k/v [B,Sk,KV,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % KV != 0:
        raise ValueError(f"flash_mha: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} do not pair (H % KV must be 0)")
    for t in (k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("flash_mha: q, k, v must share device and dtype")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_mha: dtype {q.dtype} not supported")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_mha: head dim {hd} not in {HEAD_DIMS}")
    if window < 0 or n_sink < 0 or q_off < 0:
        raise ValueError(f"flash_mha: window {window}, n_sink {n_sink} and q_off {q_off} "
                         f"must be >= 0")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    mask = (causal, window, n_sink, q_off)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashFn.apply(q, k, v, mask)
    return _forward(q, k, v, mask)


def _flash_on_shards(mesh, q, k, v, *, q_off: int = 0, **mask) -> torch.Tensor:
    """DTensors: each rank runs the kernel on its batch rows, heads and
    query rows. A query split over the sequence (sequence-parallel
    attention) stays split: K and V are gathered over the sequence, and the
    rank passes its shard's first row (``local_offset``) as ``q_off``. The
    output keeps the query's layout (the reference's ``constrain(out,
    "batch", "act_seq", "heads", None)``). K and V, replicated over the mesh
    dims that split the query's rows, get a gradient that is a pending sum
    there (``on_shards``): that sum adds dK and dV over the query shards.
    Where the heads are split over more ranks than there are K/V heads, K
    and V are repeated to one head per query head (GQA group 1), so every
    rank holds the K/V heads of its queries."""
    q = to_mesh(q, mesh)
    pl_q = kernel_placements(q, (0, 1, 2))
    pl_kv = [Replicate() if p == Shard(1) else p for p in pl_q]
    n_head_split = 1
    for i, p in enumerate(pl_q):
        if p == Shard(2):
            n_head_split *= mesh.size(i)
    if k.shape[2] % n_head_split:
        g = q.shape[2] // k.shape[2]
        k, v = (to_mesh(t, mesh).repeat_interleave(g, dim=2) for t in (k, v))
    off = q_off + local_offset(q, 1)
    return on_shards(lambda a, b, c: flash_mha(a, b, c, q_off=off, **mask), mesh, (q, k, v),
                     (pl_q, pl_kv, pl_kv), pl_q)


def _tensor_cores(q, head_dims=WGMMA_HEAD_DIMS) -> bool:
    """Does a call on q run on the tensor cores (the forward's head dims, or
    the backward's with ``WGMMA_BWD_HEAD_DIMS``)?"""
    return q.dtype == torch.bfloat16 and q.shape[3] in head_dims


def _check_aligned(*tensors) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("flash_mha: the kernels need 16-byte aligned tensors (TMA "
                             "on the tensor cores; 16-byte loads of out and dout in the "
                             "backward)")


def _forward(q, k, v, mask, lse=None) -> torch.Tensor:
    """One forward launch; with ``lse``, the instance that also stores L."""
    causal, window, n_sink, q_off = mask
    B, S, H, hd = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if B * H * S == 0:
        return out
    if _tensor_cores(q):
        if k.shape[1] == 0:          # no key: every row comes out 0
            return out.zero_()
        _check_aligned(q, k, v, out)
        flash_attention_wgmma_cuda(q, k, v, out, causal=causal, window=window,
                                   n_sink=n_sink, q_off=q_off, lse=lse)
        flash_mha.wgmma_launches += 1
    else:
        flash_attention_cuda(q, k, v, out, causal=causal, window=window,
                             n_sink=n_sink, q_off=q_off, lse=lse)
    flash_mha.launches += 1
    return out


class _FlashFn(torch.autograd.Function):
    """The forward kernels and the backward kernel as one differentiable op
    (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        B, S, H, _ = q.shape
        lse = torch.empty((B * H, lse_rows(S)), dtype=torch.float32, device=q.device)
        out = _forward(q, k, v, mask, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = mask
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        if q.numel() == 0 or k.shape[1] == 0:    # no visible pair: every gradient is 0
            return dq.zero_(), dk.zero_(), dv.zero_(), None
        dout = dout.contiguous()
        tensor_cores = _tensor_cores(q, WGMMA_BWD_HEAD_DIMS)
        _check_aligned(out, dout, *((q, k, v) if tensor_cores else ()))
        causal, window, n_sink, q_off = ctx.mask
        flash_attention_bwd_cuda(q, k, v, out, dout, lse, dq, dk, dv, causal=causal,
                                 window=window, n_sink=n_sink, q_off=q_off)
        flash_mha.bwd_launches += 1
        flash_mha.wgmma_bwd_launches += tensor_cores
        return dq, dk, dv, None


flash_mha.launches = 0
flash_mha.wgmma_launches = 0
flash_mha.bwd_launches = 0
flash_mha.wgmma_bwd_launches = 0
