"""The rmsnorm kernel's plan and its arithmetic, checked on the CPU.

``rmsnorm_tiled`` emulates the CUDA kernel's partition of each row and its
order of reduction in f32; it is held against the Pallas kernel (interpret
mode) and the JAX oracle, one case per variant. ``rmsnorm_plan`` (the twin
of the C ``repro_rmsnorm_plan``; the card tests compare the two) is checked
over a grid of shapes, dtypes, alignments and SM counts: every element goes
to exactly one thread, and no block asks for more than the card has.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import RMS_PLAN_GRID, TOL, close, randn
from repro.kernels.rmsnorm.kernel import fused_rmsnorm
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro_torch.kernels.rmsnorm.ref import (LATENCY, MAX_THREADS, ROWS, SCALAR,
                                             SMEM_LIMIT, STREAM, plan_coverage,
                                             rmsnorm_plan, rmsnorm_ref, rmsnorm_tiled)

H100_SMS = 132
_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.parametrize("rows,d,dt,aligned,variant,tpr", [
    (37, 100, "bf16", True, SCALAR, 32),        # d not a multiple of 8
    (4, 1536, "f32", False, SCALAR, 32),        # a misaligned pointer
    (4, 1536, "bf16", True, LATENCY, 192),      # qwen2 decode
    (1, 8192, "f32", True, LATENCY, 1024),      # two vectors per thread
    (37, 16, "bf16", True, LATENCY, 32),
    (300, 128, "bf16", True, ROWS, 16),         # qk-norm heads: 2 rows per warp
    (300, 16, "f32", True, ROWS, 4),
    (300, 1536, "bf16", True, ROWS, 32),
    (300, 1536, "f32", True, STREAM, 32),       # 6 KiB rows
    (300, 8192, "f32", True, STREAM, 128),      # a row across 4 warps
])
def test_tiled_emulation_vs_pallas_and_ref(rows, d, dt, aligned, variant, tpr):
    plan = rmsnorm_plan(rows, d, _TDT[dt], aligned, H100_SMS)
    assert (plan.variant, plan.tpr) == (variant, tpr)
    x_np, w_np = randn(0, (rows, d)), randn(1, (d,))
    xt, wt = torch.from_numpy(x_np).to(_TDT[dt]), torch.from_numpy(w_np).to(_TDT[dt])
    xj, wj = jnp.asarray(x_np, _JDT[dt]), jnp.asarray(w_np, _JDT[dt])
    got = rmsnorm_tiled(xt, wt, 1e-6, plan)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    tol = TOL[f"rmsnorm_{dt}"]
    close(got, fused_rmsnorm(xj, wj, eps=1e-6), tol)
    close(got, jax_rmsnorm_ref(xj, wj, eps=1e-6), tol)
    close(got, rmsnorm_ref(xt, wt, 1e-6), tol)


@pytest.mark.parametrize("rows,d,dt,variant,grid", [
    (4, 1536, "bf16", LATENCY, 4), (4, 1600, "bf16", LATENCY, 4),      # decode
    (4096, 1536, "bf16", ROWS, 1024), (4608, 1600, "bf16", ROWS, 1152),  # prefill
    (49152, 128, "bf16", ROWS, 6144),                                  # qk-norm heads
    (4096, 1536, "f32", STREAM, 2 * H100_SMS), (4608, 1600, "f32", STREAM, 2 * H100_SMS),
    (4, 1600, "f32", LATENCY, 4),
])
def test_plan_at_main_path_shapes(rows, d, dt, variant, grid):
    plan = rmsnorm_plan(rows, d, _TDT[dt], True, H100_SMS)
    assert (plan.variant, plan.grid) == (variant, grid)
    if variant == STREAM:   # two blocks share an SM: two stages of 8 rows each
        assert plan.stages == 2 and plan.tile_rows == 8
        assert 2 * (plan.smem + 1024) <= 233472


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_partitions_every_row_and_fits_the_card(dt, aligned):
    esize = _TDT[dt].itemsize
    seen = set()
    for rows, d, n_sm in RMS_PLAN_GRID:
        p = rmsnorm_plan(rows, d, _TDT[dt], aligned, n_sm)
        seen.add(p.variant)
        where = f"rows={rows} d={d} {dt} aligned={aligned} n_sm={n_sm}: {p}"
        assert 1 <= p.threads <= MAX_THREADS and p.threads % 32 == 0, where
        assert p.grid >= 1 and p.smem <= SMEM_LIMIT, where
        assert p.tpr & (p.tpr - 1) == 0 or p.variant == LATENCY, where
        if p.variant != SCALAR:
            assert aligned and (d * esize) % 16 == 0 and p.vec * esize == 16, where
        if p.variant in (ROWS, STREAM):
            assert rows >= n_sm and p.grid <= rows, where
            assert (d * esize < 4096) == (p.variant == ROWS), where
        if p.variant == STREAM:
            assert p.tpr >= 32 and p.tile_rows * p.tpr == 256 and p.stages == 2, where
        cov = plan_coverage(p, rows, d)
        assert cov.shape == (rows, d) and (cov == 1).all(), where
    assert seen == ({SCALAR, LATENCY, ROWS, STREAM} if aligned else {SCALAR})


def test_plan_is_a_pure_function_of_its_inputs():
    a = rmsnorm_plan(4096, 1536, torch.bfloat16, True, H100_SMS)
    assert a == rmsnorm_plan(4096, 1536, torch.bfloat16, True, H100_SMS)
    assert rmsnorm_plan(4096, 1536, torch.bfloat16, True, 4097).variant == LATENCY
    assert rmsnorm_plan(4096, 1536, torch.bfloat16, False, H100_SMS).variant == SCALAR


def test_tiled_emulation_tracks_the_plain_version_in_f32():
    """Only the order of the f32 sum differs from the plain version."""
    x, w = torch.from_numpy(randn(2, (133, 4100))), torch.from_numpy(randn(3, (4100,)))
    for aligned, n_sm in ((True, H100_SMS), (True, 1000), (False, H100_SMS)):
        plan = rmsnorm_plan(133, 4100, torch.float32, aligned, n_sm)
        got = rmsnorm_tiled(x, w, 1e-6, plan)
        np.testing.assert_allclose(got.numpy(), rmsnorm_ref(x, w, 1e-6).numpy(),
                                   rtol=1e-5, atol=1e-5)
