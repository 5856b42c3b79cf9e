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


def random_task_arrays(seed: int, n: int, n_units: int, *, classes=(0, 1, 2, 3),
                       cross: float = 0.3, max_deps: int = 8, dep_hi=None):
    """A random task graph for the list schedule (the port's ``TaskArrays``):
    engine classes drawn from ``classes``, a share ``cross`` of cross-pod
    tasks, 0..``max_deps`` dependencies a task. Dependencies lie in [0, i),
    or in [0, dep_hi) when given (those at i or later read 0.0)."""
    from repro_torch.core.vectorized import MAX_DEPS, TaskArrays

    rng = np.random.default_rng(seed)

    def logu(lo, hi):
        return np.exp(rng.uniform(np.log(lo), np.log(hi), n))

    deps = np.full((n, MAX_DEPS), -1, np.int32)
    for i in range(n):
        hi = i if dep_hi is None else dep_hi
        k = int(rng.integers(0, max_deps + 1)) if hi > 0 else 0
        deps[i, :k] = rng.integers(0, hi, k) if k else []
    return TaskArrays(
        engine_class=rng.choice(np.asarray(classes, np.int32), n),
        engine_unit=rng.integers(0, n_units, n).astype(np.int32), n_units=n_units,
        flops=logu(1e3, 1e12), elems=logu(1, 1e8), bytes_=logu(1, 1e9),
        io_bytes=logu(1, 1e9), gemm_m=np.floor(logu(1, 8192)),
        gemm_n=np.floor(logu(1, 8192)),
        coll_phases=rng.integers(1, 16, n).astype(np.float64),
        coll_bytes=logu(1, 1e9), cross_pod=rng.random(n) < cross, deps=deps)


def hw_param_matrix() -> np.ndarray:
    """[12, 13] parameter vectors around the v5e preset: clock x HBM x DCN."""
    import dataclasses

    from repro_torch.core.vectorized import params_of
    from repro_torch.hw.presets import resolve_preset

    base = resolve_preset("v5e")
    return np.stack([params_of(dataclasses.replace(base, clock_ghz=c, hbm_gbps=h,
                                                   dcn_gbps=d))
                     for c in (0.6, 0.94, 1.5) for h in (409.0, 819.0)
                     for d in (25.0, 100.0)])
