"""ctypes bindings of the CUDA flash attention kernels.

Counterpart of ``repro/kernels/flash_attention/kernel.py::flash_attention``.
The Pallas kernel takes heads flattened into the batch ([BH, S, hd]); the
CUDA kernels read the model layout [B, S, H, hd] / [B, S, KV, hd] directly,
so no transpose is materialised around them.

* ``flash_attention_cuda`` — ``csrc/flash_attention.cu``: register-tiled
  f32 products on the CUDA cores (SIMT; ``SIMT_TILE`` query rows a block,
  key tiles of ``SIMT_TILE``, two blocks an SM), f32 or bf16, head dims
  ``HEAD_DIMS``.
* ``flash_attention_wgmma_cuda`` — ``csrc/flash_attention_wgmma.cu``: bf16
  on the tensor cores (wgmma) with K/V streamed by TMA, head dims
  ``WGMMA_HEAD_DIMS``, Sk > 0, 16-byte aligned tensors. hd 64 and 128 take
  64-column boxes under the 128-byte swizzle; HuBERT's hd 80 (160-byte
  rows) five 16-column boxes under the 32-byte swizzle
  (``wgmma_smem_plan``).

Every entry point takes ``q_off``, the global index of q's first row (a
query shard against the whole K and V): a runtime scalar of the causal
mask and its tile predicates, no instance of its own.

Either forward, given ``lse``, launches its instance that also stores each
row's logsumexp L for the backward ([B*H, lse_rows(Sq)] f32, in the exp2
domain: L = m·scale·log2(e) + log2(l)); without it, the serve path's.

* ``flash_attention_bwd_cuda`` — ``csrc/flash_attention_bwd.cu``: dQ, dK,
  dV from the forward's L in four launches: D = rowsum(dO·O); dK, dV as f32
  partial sums over a balanced grid (each key tile's (head, query tile)
  units cut into splits of at most ``BWD_SPLIT_UNITS``); dQ per query tile;
  the partials added in split order. bf16 at ``WGMMA_BWD_HEAD_DIMS`` (64,
  80, 128) on the tensor cores (wgmma + TMA, 16-byte aligned tensors; hd 80
  in five 16-column boxes under the 32-byte swizzle, as the forward:
  ``wgmma_bwd_smem_plan``), everything else (f32, bf16 at hd 16/32) as
  register-tiled f32 products on the CUDA cores; head dims ``HEAD_DIMS``,
  Sk > 0.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

__all__ = ["HEAD_DIMS", "WGMMA_HEAD_DIMS", "WGMMA_BWD_HEAD_DIMS",
           "WGMMA_BLOCK_Q", "WGMMA_BLOCK_K", "SMEM_PER_BLOCK", "wgmma_smem_plan", "SIMT_TILE",
           "SMEM_PER_SM", "SMEM_RESERVED_PER_BLOCK", "flash_kernel_attrs", "BWD_SPLIT_UNITS",
           "BWD_KERNELS", "lse_rows",
           "flash_attention_cuda", "flash_attention_wgmma_cuda",
           "flash_attention_bwd_cuda", "bwd_slots",
           "wgmma_kernel_attrs", "wgmma_bwd_smem_plan", "bwd_kernel_attrs"]

# head dims of the forward kernels and of the backward's
HEAD_DIMS = (16, 32, 64, 80, 128)
# head dims where bf16 runs on the tensor cores: the forward's and the
# backward's
WGMMA_HEAD_DIMS = (64, 80, 128)
WGMMA_BWD_HEAD_DIMS = (64, 80, 128)
# query rows per block and keys per K/V tile of the tensor-core kernel
# (kRows, kKeys in csrc/flash_attention_wgmma.cu)
WGMMA_BLOCK_Q = 128
WGMMA_BLOCK_K = 128
# shared memory one block of an H100 may use (232,448 bytes)
SMEM_PER_BLOCK = 227 * 1024
# K/V stages of the tensor-core forward by head dim (kStages)
_WGMMA_STAGES = {64: 3, 80: 3, 128: 2}


def wgmma_smem_plan(hd: int) -> dict:
    """The shared-memory plan of the tensor-core forward at ``hd``, the twin
    of ``Cfg<HD>`` in ``csrc/flash_attention_wgmma.cu``: a TMA box of
    ``box_cols`` columns, one row of it ``row_bytes`` wide under a swizzle
    of ``swizzle_bytes`` (128 where hd is a multiple of 64, else 32: hd
    80's 160-byte rows), ``boxes`` of them side by side; Q, then ``stages``
    K/V stages, then the mbarriers, after 1 KiB of slack for the 1024-byte
    alignment of the base. ``smem_bytes`` is what a block asks for."""
    if hd not in WGMMA_HEAD_DIMS:
        raise ValueError(f"wgmma_smem_plan: head dim {hd} not in {WGMMA_HEAD_DIMS}")
    swizzle = 128 if hd % 64 == 0 else 32
    box_cols = swizzle // 2
    stages = _WGMMA_STAGES[hd]
    q_bytes = WGMMA_BLOCK_Q * hd * 2
    tile_bytes = WGMMA_BLOCK_K * hd * 2
    return dict(box_cols=box_cols, row_bytes=box_cols * 2, swizzle_bytes=swizzle,
                boxes=hd // box_cols, stages=stages, q_bytes=q_bytes, tile_bytes=tile_bytes,
                smem_bytes=1024 + q_bytes + stages * 2 * tile_bytes + 8 * (1 + 2 * stages))


# the tile of the CUDA-core kernels (kTile in csrc/flash_simt.cuh): keys per
# key tile and rows per query tile in every backward kernel and in the
# CUDA-core forward; L and D rows are padded to it
SIMT_TILE = 64
# (Q, dO) or (K, V) stages of the tensor-core backward by head dim (WCfg::kStages)
_WGMMA_BWD_STAGES = {64: 3, 80: 3, 128: 2}
# shared memory of an SM of an H100, and what it reserves for each block
SMEM_PER_SM, SMEM_RESERVED_PER_BLOCK = 228 * 1024, 1024


def wgmma_bwd_smem_plan(hd: int) -> dict:
    """The shared-memory plan of the tensor-core backward's dQ and dK/dV
    kernels at ``hd``, the twin of ``WCfg<HD>`` in
    ``csrc/flash_attention_bwd.cu``: a 64-row tile is ``boxes`` TMA boxes of
    ``box_cols`` columns, a box row ``row_bytes`` wide under a swizzle of
    ``swizzle_bytes`` (128 where hd is a multiple of 64, else 32: hd 80's
    160-byte rows); two fixed tiles (K, V or Q, dO), ``stages`` pairs of
    streamed tiles, each stage's L and D (64 f32 each), the mbarriers, after
    1 KiB of slack for the 1024-byte alignment of the base. ``smem_bytes``
    is what a block asks for: two blocks an SM must fit ``SMEM_PER_SM``,
    with ``SMEM_RESERVED_PER_BLOCK`` each."""
    if hd not in WGMMA_BWD_HEAD_DIMS:
        raise ValueError(f"wgmma_bwd_smem_plan: head dim {hd} not in {WGMMA_BWD_HEAD_DIMS}")
    swizzle = 128 if hd % 64 == 0 else 32
    box_cols = swizzle // 2
    stages = _WGMMA_BWD_STAGES[hd]
    tile_bytes = SIMT_TILE * hd * 2
    smem = (1024 + 2 * tile_bytes + stages * 2 * tile_bytes + stages * 2 * SIMT_TILE * 4
            + 8 * (1 + 2 * stages))
    return dict(box_cols=box_cols, row_bytes=box_cols * 2, swizzle_bytes=swizzle,
                boxes=hd // box_cols, box_bytes=SIMT_TILE * box_cols * 2, stages=stages,
                tile_bytes=tile_bytes, smem_bytes=smem)


# most (head, query tile) units one dK/dV block walks (kSplitUnits)
BWD_SPLIT_UNITS = 32
# the backward's kernels, by the `kind` of repro_flash_attention_bwd_attrs
BWD_KERNELS = ("dq", "dkdv", "delta", "finalize")


def lse_rows(Sq: int) -> int:
    """Row stride of L and D: Sq rounded up to ``SIMT_TILE``."""
    return -(-Sq // SIMT_TILE) * SIMT_TILE


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, *, causal: bool, window: int = 0,
                         n_sink: int = 0, q_off: int = 0,
                         lse: torch.Tensor | None = None) -> None:
    """Launch the CUDA-core (SIMT) kernel into ``out`` [B,Sq,H,hd] with
    scale 1/sqrt(hd) (and L into ``lse``, if given); the caller has checked
    device, dtype, shapes and contiguity."""
    lib = _build.load()
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    err = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(lse),
        B, Sq, Sk, H, KV, hd, int(causal), int(window), int(n_sink), int(q_off),
        1.0 / math.sqrt(hd), _build.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("repro_flash_attention", err)


def flash_attention_wgmma_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               out: torch.Tensor, *, causal: bool, window: int = 0,
                               n_sink: int = 0, q_off: int = 0,
                               lse: torch.Tensor | None = None) -> None:
    """Launch the tensor-core kernel into ``out`` [B,Sq,H,hd] with scale
    1/sqrt(hd) (and L into ``lse``, if given); the caller has checked
    device, bf16, shapes, contiguity, alignment, hd in ``WGMMA_HEAD_DIMS``
    and Sk > 0."""
    lib = _build.load()
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    err = lib.repro_flash_attention_wgmma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(lse),
        B, Sq, Sk, H, KV, hd, int(causal), int(window), int(n_sink), int(q_off),
        1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("repro_flash_attention_wgmma", err)


def bwd_slots(Sq: int, Sk: int, H: int, KV: int, *, causal: bool, window: int = 0,
              n_sink: int = 0, q_off: int = 0) -> int:
    """dK/dV blocks (= partial rows) of one (b, kv head) of the backward
    (``repro_flash_attention_bwd_slots``; twin ``ref.py::bwd_split_plan``)."""
    n = _build.load().repro_flash_attention_bwd_slots(Sq, Sk, H, KV, int(causal),
                                                      int(window), int(n_sink), int(q_off))
    if n < 0:
        raise ValueError(f"bwd_slots: bad shape Sq={Sq} Sk={Sk} H={H} KV={KV}")
    return n


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                             dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor, *,
                             causal: bool, window: int = 0, n_sink: int = 0,
                             q_off: int = 0) -> None:
    """Launch the backward into ``dq``, ``dk``, ``dv`` (q's and k's shapes)
    from the forward's inputs, its output ``o``, its L (``lse``) and
    ``dout``; the D rows and the dK/dV partial sums are allocated here. The
    caller has checked device, dtype, shapes, contiguity, alignment and
    Sk > 0."""
    lib = _build.load()
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    n_slots = bwd_slots(Sq, Sk, H, KV, causal=causal, window=window, n_sink=n_sink,
                        q_off=q_off)
    delta = torch.empty((B * H, lse_rows(Sq)), dtype=torch.float32, device=q.device)
    part_k = torch.empty((B * KV, n_slots, SIMT_TILE, hd), dtype=torch.float32,
                         device=q.device)
    part_v = torch.empty_like(part_k)
    err = lib.repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        part_k.data_ptr(), part_v.data_ptr(), n_slots, B, Sq, Sk, H, KV, hd, int(causal),
        int(window), int(n_sink), int(q_off), 1.0 / math.sqrt(hd), _build.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("repro_flash_attention_bwd", err)


def _attrs(name: str, *args) -> dict:
    regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _build.check(name, getattr(_build.load(), name)(
        *args, ctypes.byref(regs), ctypes.byref(local), ctypes.byref(smem)))
    return {"registers": regs.value, "spill_bytes": local.value,
            "smem_bytes": smem.value}


def flash_kernel_attrs(hd: int, dtype: torch.dtype, lse: bool = False) -> dict:
    """Registers per thread, spill bytes per thread and shared memory per
    block of the CUDA-core forward at ``hd`` in ``dtype``
    (cudaFuncGetAttributes), and the blocks of it an SM of the current card
    holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor); ``lse``: the
    instance that stores L (autograd), else the serve path's."""
    n = ctypes.c_int()
    a = _attrs("repro_flash_attention_attrs", hd, _build.DTYPE_CODES[dtype], int(lse),
               ctypes.byref(n))
    return {"blocks_per_sm": n.value, **a}


def wgmma_kernel_attrs(hd: int, windowed: bool, lse: bool = False) -> dict:
    """Registers per thread at launch (setmaxnreg then moves them to the
    consumer warpgroups), spill bytes per thread and shared memory per block
    of the tensor-core forward for ``hd`` (cudaFuncGetAttributes); ``lse``:
    the instance that stores L (autograd), else the serve path's."""
    return _attrs("repro_flash_attention_wgmma_attrs", hd, int(windowed), int(lse))


def bwd_kernel_attrs(kernel: str, hd: int, dtype: torch.dtype) -> dict:
    """The same for one kernel of the backward (``BWD_KERNELS``) that a call
    in ``dtype`` at ``hd`` launches (bf16 at ``WGMMA_BWD_HEAD_DIMS``: the
    tensor-core dQ and dK/dV), with the blocks of it an SM of the current
    card holds (the occupancy calculator)."""
    n = ctypes.c_int()
    a = _attrs("repro_flash_attention_bwd_attrs", BWD_KERNELS.index(kernel), hd,
               _build.DTYPE_CODES[dtype], ctypes.byref(n))
    return {"blocks_per_sm": n.value, **a}
