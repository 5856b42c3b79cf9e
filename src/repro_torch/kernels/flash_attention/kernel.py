"""ctypes bindings of the CUDA flash attention kernels.

Counterpart of ``repro/kernels/flash_attention/kernel.py::flash_attention``.
The Pallas kernel takes heads flattened into the batch ([BH, S, hd]); the
CUDA kernels read the model layout [B, S, H, hd] / [B, S, KV, hd] directly,
so no transpose is materialised around them.

* ``flash_attention_cuda`` — ``csrc/flash_attention.cu``: scalar f32 FMAs,
  f32 or bf16, head dims ``HEAD_DIMS``.
* ``flash_attention_wgmma_cuda`` — ``csrc/flash_attention_wgmma.cu``: bf16
  on the tensor cores (wgmma) with K/V streamed by TMA, head dims
  ``WGMMA_HEAD_DIMS``, Sk > 0, 16-byte aligned tensors.
* ``flash_attention_bwd_cuda`` — ``csrc/flash_attention_bwd.cu``: dQ, dK,
  dV in three launches (the row logsumexp L and D = rowsum(dO·O); dK and
  dV per key tile and kv head; dQ per query tile), scalar f32 FMAs, f32 or
  bf16, head dims ``HEAD_DIMS``, Sk > 0.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

__all__ = ["HEAD_DIMS", "WGMMA_HEAD_DIMS", "WGMMA_BLOCK_Q", "WGMMA_BLOCK_K",
           "BWD_ROWS", "BWD_KEYS", "BWD_KEY_ROWS", "BWD_Q_TILE",
           "flash_attention_cuda", "flash_attention_wgmma_cuda",
           "flash_attention_bwd_cuda", "wgmma_kernel_attrs"]

HEAD_DIMS = (16, 32, 64, 128)
WGMMA_HEAD_DIMS = (64, 128)
# query rows per block and keys per K/V tile of the tensor-core kernel
# (kRows, kKeys in csrc/flash_attention_wgmma.cu)
WGMMA_BLOCK_Q = 128
WGMMA_BLOCK_K = 128
# tiles of the backward (kRows, kKeys, kKeyRows, kQTile in
# csrc/flash_attention_bwd.cu): query rows per block of the pre-pass and of
# dQ, keys per shared tile there; keys per block of dK/dV, query rows per
# shared tile there
BWD_ROWS = 64
BWD_KEYS = 32
BWD_KEY_ROWS = 64
BWD_Q_TILE = 32


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, *, causal: bool, window: int = 0,
                         n_sink: int = 0) -> None:
    """Launch the scalar kernel into ``out`` [B,Sq,H,hd] with scale
    1/sqrt(hd); the caller has checked device, dtype, shapes and
    contiguity."""
    lib = _build.load()
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    err = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, KV, hd, int(causal), int(window), int(n_sink),
        1.0 / math.sqrt(hd),
        _build.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("repro_flash_attention", err)


def flash_attention_wgmma_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               out: torch.Tensor, *, causal: bool, window: int = 0,
                               n_sink: int = 0) -> None:
    """Launch the tensor-core kernel into ``out`` [B,Sq,H,hd] with scale
    1/sqrt(hd); the caller has checked device, bf16, shapes, contiguity,
    alignment, hd in ``WGMMA_HEAD_DIMS`` and Sk > 0."""
    lib = _build.load()
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    err = lib.repro_flash_attention_wgmma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, KV, hd, int(causal), int(window), int(n_sink),
        1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("repro_flash_attention_wgmma", err)


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, dout: torch.Tensor, dq: torch.Tensor,
                             dk: torch.Tensor, dv: torch.Tensor, *, causal: bool,
                             window: int = 0, n_sink: int = 0) -> None:
    """Launch the backward into ``dq``, ``dk``, ``dv`` (q's and k's shapes)
    from the forward's inputs, its output ``o`` and ``dout``; the L and D
    scratch rows are allocated here. The caller has checked device, dtype,
    shapes, contiguity and Sk > 0."""
    lib = _build.load()
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    lse = torch.empty((B * H, Sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    err = lib.repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        B, Sq, Sk, H, KV, hd, int(causal), int(window), int(n_sink), 1.0 / math.sqrt(hd),
        _build.DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("repro_flash_attention_bwd", err)


def wgmma_kernel_attrs(hd: int, windowed: bool) -> dict:
    """Registers per thread at launch (setmaxnreg then moves them to the
    consumer warpgroups), spill bytes per thread and shared memory per block
    of the tensor-core instance for ``hd`` (cudaFuncGetAttributes)."""
    lib = _build.load()
    regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _build.check("repro_flash_attention_wgmma_attrs",
                 lib.repro_flash_attention_wgmma_attrs(
                     hd, int(windowed), ctypes.byref(regs), ctypes.byref(local),
                     ctypes.byref(smem)))
    return {"registers": regs.value, "spill_bytes": local.value,
            "smem_bytes": smem.value}
