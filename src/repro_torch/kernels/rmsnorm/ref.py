"""Plain PyTorch version of fused RMSNorm (counterpart of
``repro/kernels/rmsnorm/ref.py::rmsnorm_ref``): math in f32, cast back.
Its backward is autograd of it (``rmsnorm_bwd_ref``), the counterpart of
``jax.grad`` of the reference.

Beside it, the CPU twins of the CUDA kernel (``csrc/rmsnorm.cu``):

* ``rmsnorm_plan`` — the kernel's plan, a pure function of the shape, the
  dtype, the 16-byte alignment of the pointers and the SM count; the C
  ``repro_rmsnorm_plan`` computes the same (the card tests compare them).
* ``plan_coverage`` — how many threads each element of ``[rows, d]`` goes
  to under a plan, walking the kernel's own loops (tests only).
* ``rmsnorm_tiled`` — the kernel's partition of each row and its order of
  reduction, emulated in f32 (tests only).

and of the backward kernel (``csrc/rmsnorm_bwd.cu``):

* ``rmsnorm_bwd_plan`` — its plan (``repro_rmsnorm_bwd_plan`` on the C side);
* ``rmsnorm_bwd_tiled`` — its lanes, rows and orders of summation (each
  row's two sums, dw over the rows of a lane group, then the groups, warps
  and blocks in order), emulated in f32 (tests only).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["rmsnorm_ref", "rmsnorm_bwd_ref", "RmsnormPlan", "rmsnorm_plan", "plan_coverage",
           "rmsnorm_tiled", "SCALAR", "LATENCY", "ROWS", "STREAM", "VARIANTS",
           "SMEM_LIMIT", "MAX_THREADS", "RmsnormBwdPlan", "rmsnorm_bwd_plan",
           "rmsnorm_bwd_tiled", "BWD_SCALAR", "BWD_VECTOR", "BWD_VARIANTS"]


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                    eps: float = 1e-6):
    """(dx, dw) of ``rmsnorm_ref`` at (x, w) for the output gradient ``g``,
    by autograd."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        wr = w.detach().requires_grad_(True)
        return torch.autograd.grad(rmsnorm_ref(xr, wr, eps), (xr, wr), g)


# -- the plan (constants as in csrc/rmsnorm.cu) --------------------------------

SCALAR, LATENCY, ROWS, STREAM = 0, 1, 2, 3
VARIANTS = ("scalar", "latency", "rows", "stream")
SMEM_LIMIT = 232448        # shared memory one block may use on the H100 (227 KiB)
SMEM_PER_SM = 233472       # shared memory of one SM (228 KiB)
SMEM_PER_BLOCK = 1024      # of which the system keeps per block
MAX_THREADS = 1024
ROWS_WARPS = 4             # rows, scalar: warps per block
STREAM_MIN_BYTES = 4096    # stream: narrowest row (narrower ones take rows)
CONSUMER_WARPS = 8         # stream: warps that reduce and write (+1 producer warp)
STAGES = 2                 # stream: stages of the ring
WARP_VECS = 512            # stream: 16-byte vectors of a row one warp takes alone


class RmsnormPlan(NamedTuple):
    variant: int     # SCALAR, LATENCY, ROWS or STREAM
    grid: int        # blocks
    threads: int     # threads per block
    tpr: int         # threads that share one row
    vec: int         # elements per load (16 bytes, or 1 in the scalar variant)
    vpt: int         # loads of x per thread and row, at most
    tile_rows: int   # rows per block (rows, scalar), per stage of the ring (stream)
    stages: int      # stages of the ring (stream)
    smem: int        # dynamic shared memory per block, bytes


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def stream_smem(row_bytes: int, stage_bytes: int) -> int:
    """w, the ring, a full and an empty mbarrier per stage, one for w, and
    the cross-warp partial sums (two rows' worth)."""
    return row_bytes + STAGES * stage_bytes + 8 * (2 * STAGES + 1) + 4 * 2 * CONSUMER_WARPS


def rmsnorm_plan(rows: int, d: int, dtype: torch.dtype, aligned: bool,
                 n_sm: int) -> RmsnormPlan:
    """The variant and launch shape the kernel takes for x ``[rows, d]``.

    * scalar — any d, any pointer: one warp per row, element loads.
    * latency — 16-byte loads possible and fewer rows than SMs (decode):
      one block per row, each thread one or two vectors of x and w.
    * rows — 16-byte loads possible, many rows under 4 KiB: ``tpr``
      lanes per row (a power of two, several rows to a warp for narrow
      rows), two passes over the row.
    * stream — 16-byte loads possible, many rows of 4 KiB or more: one or two
      persistent blocks per SM stream their rows through a two-stage ring
      of shared memory by bulk copy; ``tpr`` is 1, 2 or 4 warps.
    """
    esize = dtype.itemsize
    vec = 16 // esize
    if not aligned or d % vec:
        return RmsnormPlan(SCALAR, _cdiv(rows, ROWS_WARPS), 32 * ROWS_WARPS, 32, 1,
                           _cdiv(d, 32), ROWS_WARPS, 0, 0)
    nvec = d // vec
    if rows < n_sm:
        vpt = 1 if nvec <= MAX_THREADS else 2
        threads = 32 * _cdiv(_cdiv(nvec, vpt), 32)
        return RmsnormPlan(LATENCY, rows, threads, threads, vec, vpt, 1, 0, 0)
    row_bytes = d * esize
    if row_bytes < STREAM_MIN_BYTES:
        tpr = min(32, _pow2(nvec))
        per_block = 32 * ROWS_WARPS // tpr
        return RmsnormPlan(ROWS, _cdiv(rows, per_block), 32 * ROWS_WARPS, tpr, vec,
                           _cdiv(nvec, tpr), per_block, 0, 0)
    tpr = 32 if nvec <= WARP_VECS else 32 * _pow2(_cdiv(nvec, WARP_VECS))
    tile_rows = 32 * CONSUMER_WARPS // tpr
    smem = stream_smem(row_bytes, tile_rows * row_bytes)
    per_sm = 2 if 2 * (smem + SMEM_PER_BLOCK) <= SMEM_PER_SM else 1
    return RmsnormPlan(STREAM, min(rows, per_sm * n_sm), 32 * (CONSUMER_WARPS + 1), tpr,
                       vec, _cdiv(nvec, tpr), tile_rows, STAGES, smem)


# -- the partition, walked as the kernel walks it -----------------------------

def _count(rows_idx: np.ndarray, elems: np.ndarray, rows: int, d: int) -> np.ndarray:
    """Each of ``rows_idx`` (the rows a set of threads reduces) against each
    of ``elems`` (the elements of a row those threads hold)."""
    flat = (rows_idx[:, None] * d + elems[None, :]).ravel()
    return np.bincount(flat, minlength=rows * d)


def _elems(plan: RmsnormPlan, nvec: int, threads: int) -> np.ndarray:
    """The elements thread ``t`` of a row holds: vectors t, t + threads, ..."""
    i = (np.arange(threads)[:, None] + threads * np.arange(plan.vpt)[None, :]).ravel()
    i = i[i < nvec]
    return (i[:, None] * plan.vec + np.arange(plan.vec)[None, :]).ravel()


def plan_coverage(plan: RmsnormPlan, rows: int, d: int) -> np.ndarray:
    """How many threads' slices hold each element of ``[rows, d]`` under
    ``plan``, following the kernel's loops (1 everywhere when the plan is
    a partition)."""
    nvec = d // plan.vec
    e = _elems(plan, nvec, plan.tpr)
    if plan.variant in (SCALAR, ROWS):
        # block b, thread t: row b * tile_rows + t // tpr, lane group t % tpr
        r = (np.arange(plan.grid)[:, None] * plan.tile_rows
             + np.arange(plan.threads // plan.tpr)[None, :]).ravel()
        counts = _count(r[r < rows], e, rows, d)
    elif plan.variant == LATENCY:
        counts = _count(np.arange(plan.grid), e, rows, d)     # block b: row b
    else:
        # block b owns rows [b*rows//grid, (b+1)*rows//grid) in stages of
        # tile_rows; group g (consumer threads g*tpr ...) takes row g of each
        starts = []
        for b in range(plan.grid):
            r0, r1 = b * rows // plan.grid, (b + 1) * rows // plan.grid
            starts += [(r, min(plan.tile_rows, r1 - r))
                       for r in range(r0, r1, plan.tile_rows)]
        start, n = np.array(starts).T
        g = np.arange(32 * CONSUMER_WARPS // plan.tpr)
        r = (start[:, None] + g[None, :])[g[None, :] < n[:, None]]
        counts = _count(r, e, rows, d)
    return counts.reshape(rows, d)


def rmsnorm_tiled(x: torch.Tensor, w: torch.Tensor, eps: float,
                  plan: RmsnormPlan) -> torch.Tensor:
    """The kernel's arithmetic in f32: thread t of a row sums the squares of
    its vectors t, t + tpr, ... in order (elements in order); a butterfly
    of xor shuffles closes the sum over the row's lanes of each warp; the
    warps' partial sums are added in warp order. Then x·rsqrt(sum/d + eps)·w."""
    d = x.shape[-1]
    xf = x.reshape(-1, d).float()
    rows = xf.shape[0]
    vec, tpr = plan.vec, plan.tpr
    steps = _cdiv(d // vec, tpr)
    xp = F.pad(xf, (0, steps * tpr * vec - d)).view(rows, steps, tpr, vec)
    ss = torch.zeros(rows, tpr)
    for s in range(steps):
        for j in range(vec):
            f = xp[:, s, :, j]
            ss = ss + f * f
    width = min(tpr, 32)
    ss = ss.view(rows, tpr // width, width)
    off = width // 2
    while off:
        ss = ss + ss[..., torch.arange(width) ^ off]
        off //= 2
    total = torch.zeros(rows)
    for k in range(tpr // width):
        total = total + ss[:, k, 0]
    r = torch.rsqrt(total / d + eps)
    return (xf * r[:, None] * w.float()).to(x.dtype).reshape(x.shape)


# -- the backward's plan (constants as in csrc/rmsnorm_bwd.cu) -----------------

BWD_SCALAR, BWD_VECTOR = 0, 1
BWD_VARIANTS = ("scalar", "vector")
BWD_THREADS = 256                  # vector: eight warps a block
BWD_MAX_VECS = {4: 12, 2: 6}       # vector: 16-byte vectors of x per lane and row (48 values)
BWD_SCALAR_SMEM = 96 * 1024        # scalar: the warps' [d] f32 dw accumulators
BWD_SCALAR_MAX_WARPS = 8
BWD_DW_SLICES = 8                  # the dw launch: slices of the partial rows, each in order


class RmsnormBwdPlan(NamedTuple):
    variant: int     # BWD_SCALAR or BWD_VECTOR
    tpr: int         # lanes that share one row
    vec: int         # elements a load (16 bytes; 1 in the scalar variant)
    vpt: int         # loads of a row per lane, at most
    blocks: int      # blocks of the rows launch = partial rows of dw
    smem: int        # dynamic shared memory per block, bytes


def rmsnorm_bwd_plan(rows: int, d: int, dtype: torch.dtype, aligned: bool,
                     blocks: int) -> RmsnormBwdPlan:
    """The backward's variant and launch shape for x ``[rows, d]``, given at
    most ``blocks`` blocks (the wrapper's min(rows, SMs)).

    * vector — x, g, dx and w 16-byte aligned, d a multiple of the vector:
      ``tpr`` lanes a row (the fewest powers of two that keep each lane at
      most ``BWD_MAX_VECS`` vectors), ``BWD_THREADS // tpr`` rows a block at
      a time, one pass;
    * scalar — otherwise: one warp a row, as many warps as the [d] f32
      accumulators fit in ``BWD_SCALAR_SMEM``.
    """
    esize = dtype.itemsize
    vec = 16 // esize
    if not aligned or d % vec:
        warps = max(1, min(BWD_SCALAR_MAX_WARPS, BWD_SCALAR_SMEM // (d * 4)))
        return RmsnormBwdPlan(BWD_SCALAR, 32, 1, _cdiv(d, 32), min(blocks, rows), warps * d * 4)
    nvec = d // vec
    tpr = 1
    while _cdiv(nvec, tpr) > BWD_MAX_VECS[esize]:
        tpr *= 2
    need = _cdiv(rows, BWD_THREADS // tpr)
    return RmsnormBwdPlan(BWD_VECTOR, tpr, vec, _cdiv(nvec, tpr), min(blocks, need), d * 4)


def _butterfly(v: torch.Tensor, width: int) -> torch.Tensor:
    """An xor butterfly over the last dim (``width`` lanes, offsets
    width/2 .. 1): every lane ends with the same tree sum."""
    off = width // 2
    while off:
        v = v + v[..., torch.arange(width) ^ off]
        off //= 2
    return v


def rmsnorm_bwd_tiled(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, eps: float,
                      plan: RmsnormBwdPlan):
    """(dx, dw) as the backward kernel sums them, in f32: lane l of a row
    sums its elements (vectors l, l + tpr, ... in order, elements in order),
    an xor butterfly closes the sums over the row's lanes of a warp, and a
    row spanning warps adds them in warp order. dw: each lane adds g·x·r of
    its columns over its group's rows in order; the groups of a warp meet by
    an xor butterfly, then the warps (the groups, when a row spans warps) in
    order; the blocks' partial rows are added in ``BWD_DW_SLICES`` slices of
    consecutive blocks, each in order, then the slices in order."""
    d = x.shape[-1]
    xf, gf = x.reshape(-1, d).float(), g.reshape(-1, d).float()
    wf = w.float()
    rows = xf.shape[0]
    tpr, vec, vpt = plan.tpr, plan.vec, plan.vpt
    n_groups = (BWD_THREADS // tpr if plan.variant == BWD_VECTOR
                else plan.smem // (4 * d))
    width = min(tpr, 32)
    span = max(1, tpr // 32)
    pad = vpt * tpr * vec - d

    def lanes(t):                   # [n, d] -> [n, vpt, tpr, vec]: lane l, its i-th run
        return F.pad(t, (0, pad)).view(t.shape[0], vpt, tpr, vec)

    xl, gl, wl = lanes(xf), lanes(gf), lanes(wf[None])
    ss = torch.zeros(rows, tpr)
    sgwx = torch.zeros(rows, tpr)
    for i in range(vpt):
        for e in range(vec):
            xv = xl[:, i, :, e]
            ss = ss + xv * xv
            sgwx = sgwx + gl[:, i, :, e] * wl[:, i, :, e] * xv

    def close(v):
        v = _butterfly(v.view(rows, span, width), width)[..., 0]
        total = torch.zeros(rows)
        for k in range(span):
            total = total + v[:, k]
        return total

    inv_d = 1.0 / d
    r = torch.rsqrt(close(ss) * inv_d + eps)
    coef = r * r * r * (close(sgwx) * inv_d)
    dx = r[:, None] * (gf * wf) - xf * coef[:, None]
    contrib = gf * xf * r[:, None]

    per = _cdiv(rows, plan.blocks)
    parts = []
    for b in range(plan.blocks):
        r0, r1 = b * per, min(rows, (b + 1) * per)
        acc = torch.zeros(n_groups, d)
        for step in range(_cdiv(max(r1 - r0, 0), n_groups)):
            idx = r0 + step * n_groups + torch.arange(n_groups)
            ok = idx < r1
            acc[ok] = acc[ok] + contrib[idx[ok]]
        if tpr < 32:                # the groups of a warp: butterfly over the group bits
            gpw = 32 // tpr
            acc = _butterfly(acc.view(-1, gpw, d).transpose(1, 2), gpw)[..., 0]
        part = torch.zeros(d)       # warps (whole rows) or groups (rows spanning warps)
        for k in range(acc.shape[0]):
            part = part + acc[k]
        parts.append(part)
    dw = torch.zeros(d)
    per_slice = _cdiv(plan.blocks, BWD_DW_SLICES)
    for k in range(BWD_DW_SLICES):
        sl = torch.zeros(d)
        for part in parts[k * per_slice:(k + 1) * per_slice]:
            sl = sl + part
        dw = dw + sl
    return dx.to(x.dtype).reshape(x.shape), dw.to(w.dtype)
