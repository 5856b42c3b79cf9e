"""Shared pieces of the parity tests between ``repro`` (JAX) and
``repro_torch``: the tolerance table, the card gate, and numpy helpers.

Inputs are drawn with numpy from a seed and handed to both packages, since
``jax.random`` and ``torch.Generator`` give different numbers.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

# (rtol, atol) per check. f32 parity differs only in summation order; bf16
# rounds at different places in the two frameworks.
TOL = {
    "rmsnorm_f32": 1e-5,
    "rmsnorm_bf16": 2e-2,
    "flash_f32": 2e-5,
    "flash_bf16": 3e-2,
    "scan_f32": 1e-4,            # tests/test_kernels.py::test_ssm_scan_property
    "scan_bf16": 2e-2,           # one bf16 rounding of the f32 state
    "model_f32": 1e-4,           # port vs JAX logits / hidden states
    "decode_vs_forward": 2e-3,   # tests/test_models_smoke.py's bound
}


# (rows, d, n_sm) over which the rmsnorm kernel's plan is checked, in f32 and
# bf16, aligned or not: on the CPU for a partition, on the card against the C
# plan. Rows below and above the SM count, d of every tpr class.
RMS_PLAN_GRID = [(rows, d, n_sm)
                 for rows in (1, 4, 31, 37, 132, 133, 300)
                 for d in (1, 3, 4, 8, 16, 24, 100, 128, 136, 1024, 1536, 1600, 2048, 4100, 8192)
                 for n_sm in (1, 8, 132)]


def require_sm90() -> None:
    """Skip unless a CUDA card of compute capability >= 9.0 is present.
    Called inside a test, never at import, so every worker collects the
    same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90); none is available")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability >= 9.0 for the sm_90a build")


def randn(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def to_np(x) -> np.ndarray:
    """JAX array or tensor -> f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def close(got, want, tol: float) -> None:
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol, atol=tol)
