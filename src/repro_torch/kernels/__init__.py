"""Hand-written CUDA kernels for Hopper (sm_90a), one per Pallas TPU kernel
of the JAX package on the ported path, and one for the campaign prescreen's
XLA program.

flash_attention — online-softmax attention (prefill / forward), model layout,
  causal with an optional sliding window and sinks: bf16 at hd 64/128 on the
  tensor cores (wgmma + TMA), everything else as register-tiled f32
  products on the CUDA cores (SIMT).
rmsnorm — fused RMSNorm (every norm of the dense block, qk-norm per head).
ssm_scan — diagonal linear scan h_t = a_t·h_{t-1} + b_t (Mamba heads).
selective_scan — a Mamba head's selective scan and readout in one pass,
  the states in registers (inference: the serve engine's prefill).
list_schedule — the list schedule of one task graph under K hardware-
  parameter vectors (makespan and busy time per engine class), bit for bit
  the JAX package's f32 ``core.vectorized.schedule_many_stats``.

Each kernel keeps a plain PyTorch version in its ``ref.py``; the wrapper in
``ops.py`` takes it only for a CPU tensor, launches the kernel for a CUDA
tensor, and counts its launches. All ``csrc/*.cu`` sources build into one
shared library at first use (``_build.py``).
"""
from .flash_attention.ops import flash_mha
from .list_schedule.ops import list_schedule
from .rmsnorm.ops import rmsnorm
from .selective_scan.ops import selective_scan_fused
from .ssm_scan.ops import ssm_scan_batched

__all__ = ["flash_mha", "list_schedule", "rmsnorm", "selective_scan_fused", "ssm_scan_batched"]
