"""Plain PyTorch version of the list-schedule kernel (counterpart of
``repro/core/vectorized.py``: ``_durations``, ``schedule`` and
``schedule_stats`` under ``jax.vmap``).

Inputs, packed task-major so that one task is one contiguous record:

* ``feats`` [N, 8] f32: flops, elems, bytes, io_bytes, gemm_m, gemm_n,
  coll_phases, coll_bytes (the order of ``FEATS``);
* ``ints`` [N, 12] int32: engine class, engine unit, cross-pod flag, a
  zero pad, then the 8 dependency slots (-1 = none);
* ``params`` [K, 13] f32, the order of ``core.vectorized.PARAM_NAMES``.

Every float operation is f32 and in the reference's order, one rounding
each, so the result equals the JAX package's bit for bit: the durations
as one [K, N] matrix, then a loop over the tasks on [K] vectors. A
dependency outside [0, i) reads 0.0, as the reference's ``done`` row
(zeros until task i writes it) does. The busy time of a class is summed
in task order.

``list_schedule_plan`` is the twin of the CUDA kernel's launch plan
(``make_plan`` in ``csrc/list_schedule.cu``), and ``list_schedule_tiled``
emulates its shared-memory variant step by step on the CPU: the duration
pre-pass into ``done``, then the chain with its loads one task ahead and
the previous end forwarded from a register.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

__all__ = ["FEATS", "N_PARAMS", "N_CLASSES", "MAX_DEPS", "INT_COLS",
           "SMEM_LIMIT", "MAX_VECTORS", "VARIANTS", "ListSchedulePlan",
           "durations_ref", "list_schedule_ref", "list_schedule_plan",
           "list_schedule_tiled"]

FEATS = ("flops", "elems", "bytes_", "io_bytes", "gemm_m", "gemm_n",
         "coll_phases", "coll_bytes")
N_PARAMS = 13
N_CLASSES = 4
MAX_DEPS = 8
INT_COLS = 4 + MAX_DEPS      # class, unit, cross_pod, pad, deps
ENG_MXU, ENG_VPU, ENG_DMA = 0, 1, 2


def durations_ref(feats: torch.Tensor, ints: torch.Tensor,
                  params: torch.Tensor) -> torch.Tensor:
    """[K, N] task durations (ns) under each parameter vector."""
    (macs, f, vpu_rate, hbm, dma_oh, link, lat, dcn, dcn_lat, rows,
     vmem_bw, t_oh, cols) = (params[:, j:j + 1] for j in range(N_PARAMS))
    (flops, elems, bytes_, io_bytes, gemm_m, gemm_n, phases,
     cbytes) = (feats[:, j] for j in range(len(FEATS)))
    one = torch.ones((), dtype=feats.dtype, device=feats.device)
    m = torch.maximum(gemm_m, one)
    nn = torch.maximum(gemm_n, one)
    pad = (torch.ceil(m / rows) * rows * torch.ceil(nn / cols) * cols) / (m * nn)
    io = io_bytes / vmem_bw
    d_mxu = torch.maximum(flops * pad / (2.0 * macs * f), io) + t_oh
    d_vpu = torch.maximum(elems / (vpu_rate * f), io) + t_oh
    d_dma = dma_oh + bytes_ / hbm
    cross = ints[:, 2] != 0
    bw = torch.where(cross, dcn, link)
    latv = torch.where(cross, dcn_lat, lat)
    d_ici = phases * (latv + cbytes / bw)
    cls = ints[:, 0]
    return torch.where(cls == ENG_MXU, d_mxu,
                       torch.where(cls == ENG_VPU, d_vpu,
                                   torch.where(cls == ENG_DMA, d_dma, d_ici)))


def list_schedule_ref(feats: torch.Tensor, ints: torch.Tensor,
                      params: torch.Tensor, n_units: int, repeats: int = 1
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(makespan [K], busy [K, 4]) in f32, both times ``repeats``."""
    dur = durations_ref(feats, ints, params)
    K, N = dur.shape
    cls, unit, deps = ints[:, 0].tolist(), ints[:, 1].tolist(), ints[:, 4:].tolist()
    # column N of `done` stays 0.0: the slot a missing dependency reads
    done = torch.zeros((K, N + 1), dtype=dur.dtype, device=dur.device)
    free = torch.zeros((K, n_units), dtype=dur.dtype, device=dur.device)
    busy = torch.zeros((K, N_CLASSES), dtype=dur.dtype, device=dur.device)
    for i in range(N):
        idx = [d if 0 <= d < i else N for d in deps[i]]
        ready = torch.amax(done[:, idx], dim=1)
        u = unit[i]
        end = torch.maximum(ready, free[:, u]) + dur[:, i]
        done[:, i] = end
        free[:, u] = end
        busy[:, cls[i]] += dur[:, i]
    makespan = torch.amax(done[:, :N], dim=1)
    r = float(repeats)
    return makespan * r, busy * r


# -- the launch plan (twin of make_plan in csrc/list_schedule.cu) -------------

SMEM_LIMIT = 232_448        # opt-in dynamic shared memory of one block, H100
MAX_VECTORS = 64            # parameter vectors (chain threads) per block
SHARED_THREADS = 512        # threads per block of the shared variant
GLOBAL_THREADS = 64         # threads (= vectors) per block of the global one
TASK_BYTES = 20             # a packed task of the shared variant
# variant codes of the C side, in order
VARIANTS = ("global", "shared")


@dataclass(frozen=True)
class ListSchedulePlan:
    variant: str        # one of VARIANTS
    vectors: int        # T, parameter vectors per block (a power of two)
    grid: int
    threads: int
    smem: int           # dynamic shared memory per block, bytes


def _shared_bytes(n: int, n_units: int, vectors: int) -> int:
    """N + 2 packed tasks (two dummies past the end), then ``done``
    [N + 1][T] (row N is the zero row a missing dependency reads) and
    ``free`` [n_units][T] f32."""
    return TASK_BYTES * (n + 2) + 4 * vectors * (n + 1 + n_units)


def list_schedule_plan(n: int, k: int, n_units: int,
                       variant: Optional[str] = None) -> ListSchedulePlan:
    """How the kernel schedules N tasks under K vectors: ``shared`` (the
    packed tasks, ``done`` and ``free`` in shared memory) where it fits at
    T 1, at the largest power-of-two T, at most 64 and no more than K needs,
    that fits; else ``global`` (``done`` and ``free`` in device memory, one
    thread a vector). ``variant`` forces one variant instead; ``shared``
    forced where nothing fits gets T 1, a launch the card refuses."""
    if variant is None:
        variant = "shared" if _shared_bytes(n, n_units, 1) <= SMEM_LIMIT else "global"
    if variant not in VARIANTS:
        raise ValueError(f"list_schedule: unknown variant {variant!r}")
    if variant == "global":
        return ListSchedulePlan("global", GLOBAL_THREADS, -(-k // GLOBAL_THREADS),
                                GLOBAL_THREADS, 0)
    t = 1
    while t < MAX_VECTORS and t < k:
        t *= 2
    while t > 1 and _shared_bytes(n, n_units, t) > SMEM_LIMIT:
        t //= 2
    return ListSchedulePlan("shared", t, -(-k // t), SHARED_THREADS,
                            _shared_bytes(n, n_units, t))


def _jmax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's max: a NaN wins (the first one), ties keep ``a``."""
    return torch.where((a == a) & ~(a >= b), b, a)


def list_schedule_tiled(feats: torch.Tensor, ints: torch.Tensor,
                        params: torch.Tensor, n_units: int, repeats: int = 1,
                        vectors: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(makespan [K], busy [K, 4]) as the kernel's shared variant computes
    them, block by block of ``vectors`` (default: the plan's T).

    Per block: the pre-pass writes every task's duration into its ``done``
    slot and zeros ``free``; it packs each task's dependency slots as rows
    of ``done``, a slot outside ``0 <= dp < i`` as the zero row (a slot at
    i or later holds a duration, not 0.0). The chain then walks the tasks;
    at task i it first loads what task i+1 reads (its duration, its slots,
    its engine's free time), and only then writes task i's end over its
    duration. So the slot i-1, and the free time of the engine that task
    i-1 wrote, are taken from the previous end instead of the loaded value.
    The max over the slots is the kernel's tree; busy adds +0.0 to the
    other classes, as the kernel does."""
    N, K = feats.shape[0], params.shape[0]
    T = vectors or list_schedule_plan(N, K, n_units).vectors
    dur = durations_ref(feats, ints, params)                      # [K, N]
    cls, unit, deps = ints[:, 0].tolist(), ints[:, 1].tolist(), ints[:, 4:].tolist()
    ucl = [min(max(u, 0), n_units - 1) for u in unit]
    makespan = torch.empty((K,), dtype=dur.dtype)
    busy = torch.empty((K, N_CLASSES), dtype=dur.dtype)
    zero = torch.zeros((), dtype=dur.dtype)
    for k0 in range(0, K, T):
        cols = min(T, K - k0)
        done = torch.cat([dur[k0:k0 + cols].t(),                    # [N + 1, cols]
                          torch.zeros((1, cols), dtype=dur.dtype)])
        free = torch.zeros((n_units, cols), dtype=dur.dtype)
        slots = [[d if 0 <= d < i else N for d in deps[i]] for i in range(N)]

        def loads(i):
            """What task i reads, loaded before task i-1 writes its end."""
            return done[slots[i]].unbind(0), done[i].clone(), free[ucl[i]].clone()

        cur = loads(0)
        prev = torch.zeros((cols,), dtype=dur.dtype)
        mk = torch.full((cols,), float("-inf"), dtype=dur.dtype)
        b = [torch.zeros((cols,), dtype=dur.dtype) for _ in range(N_CLASSES)]
        for i in range(N):
            nxt = loads(i + 1) if i + 1 < N else None
            vals, d_i, f_i = cur
            v = [prev if (i > 0 and d == i - 1) else x for d, x in zip(deps[i], vals)]
            ready = _jmax(_jmax(_jmax(v[0], v[1]), _jmax(v[2], v[3])),
                          _jmax(_jmax(v[4], v[5]), _jmax(v[6], v[7])))
            from_prev = i > 0 and unit[i - 1] == ucl[i - 1] == ucl[i]
            end = _jmax(ready, prev if from_prev else f_i) + d_i
            done[i] = end
            if unit[i] == ucl[i]:
                free[unit[i]] = end
            mk = _jmax(mk, end)
            for c in range(N_CLASSES):
                b[c] = b[c] + (d_i if cls[i] == c else zero)
            prev, cur = end, nxt
        r = float(repeats)
        makespan[k0:k0 + cols] = mk * r
        busy[k0:k0 + cols] = torch.stack(b, dim=1) * r
    return makespan, busy
