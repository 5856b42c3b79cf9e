"""Hand-written CUDA kernels for Hopper (sm_90a), one per Pallas TPU kernel
of the JAX package on the ported path.

flash_attention — online-softmax attention (prefill / forward), model layout,
  causal with an optional sliding window and sinks: bf16 at hd 64/128 on the
  tensor cores (wgmma + TMA), everything else on a scalar kernel.
rmsnorm — fused RMSNorm (every norm of the dense block, qk-norm per head).
ssm_scan — diagonal linear scan h_t = a_t·h_{t-1} + b_t (Mamba heads).

Each kernel keeps a plain PyTorch version in its ``ref.py``; the wrapper in
``ops.py`` takes it only for a CPU tensor, launches the kernel for a CUDA
tensor, and counts its launches. All ``csrc/*.cu`` sources build into one
shared library at first use (``_build.py``).
"""
from .flash_attention.ops import flash_mha
from .rmsnorm.ops import rmsnorm
from .ssm_scan.ops import ssm_scan_batched

__all__ = ["flash_mha", "rmsnorm", "ssm_scan_batched"]
