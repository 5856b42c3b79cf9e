"""The port's CUDA kernels against their plain versions on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA card of
compute capability >= 9.0. The file imports torch only (no JAX), so it runs
on the machine with the card:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from _torch_common import (RMS_PLAN_GRID, TOL, close, hw_param_matrix, randn,
                           random_task_arrays, require_sm90)
from repro_torch.core.vectorized import from_tasks, task_tensors
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.kernel import (SIMT_TILE, SMEM_PER_BLOCK,
                                                        WGMMA_BWD_HEAD_DIMS, WGMMA_HEAD_DIMS,
                                                        bwd_slots, flash_attention_cuda,
                                                        flash_attention_wgmma_cuda,
                                                        flash_kernel_attrs, lse_rows,
                                                        wgmma_bwd_smem_plan, wgmma_kernel_attrs,
                                                        wgmma_smem_plan)
from repro_torch.kernels.flash_attention.kernel import bwd_kernel_attrs as flash_bwd_attrs
from repro_torch.kernels.flash_attention.ops import flash_mha
from repro_torch.kernels.flash_attention.ref import (bwd_split_plan, flash_mha_bwd_ref,
                                                     flash_mha_bwd_tiled, flash_mha_ref,
                                                     flash_mha_tiled, visible)
from repro_torch.kernels.list_schedule import ops as sched_ops
from repro_torch.kernels.list_schedule.kernel import kernel_plan as sched_kernel_plan
from repro_torch.kernels.list_schedule.ops import list_schedule
from repro_torch.kernels.list_schedule.ref import (SMEM_LIMIT, VARIANTS, list_schedule_plan,
                                                   list_schedule_ref)
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.kernel import (bwd_blocks, bwd_kernel_attrs, bwd_kernel_plan,
                                                kernel_attrs,
                                                kernel_plan, rmsnorm_bwd_cuda,
                                                rmsnorm_variant_cuda)
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import (BWD_SCALAR, BWD_VECTOR, LATENCY, ROWS, SCALAR,
                                             STREAM, rmsnorm_bwd_plan, rmsnorm_bwd_ref,
                                             rmsnorm_bwd_tiled, rmsnorm_plan, rmsnorm_ref,
                                             rmsnorm_tiled)
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.kernels.ssm_scan.kernel import scan_kernel_attrs
from repro_torch.kernels.ssm_scan.ops import ssm_scan_batched
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref, ssm_scan_ref

_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _no_plain(monkeypatch):
    """Make the plain versions unreachable from the wrappers."""
    def boom(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(rms_ops, "rmsnorm_ref", boom)
    monkeypatch.setattr(flash_ops, "flash_mha_ref", boom)
    monkeypatch.setattr(scan_ops, "ssm_scan_ref", boom)
    monkeypatch.setattr(scan_ops, "ssm_scan_bwd_ref", boom)
    monkeypatch.setattr(sched_ops, "list_schedule_ref", boom)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4096, 1536), (4, 1536), (1, 1, 128),
                                   (37, 100), (3, 50, 512), (2, 20, 4, 16),
                                   (5, 8192)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rmsnorm_cuda_vs_plain(shape, dt, monkeypatch):
    require_sm90()
    x = torch.from_numpy(randn(0, shape)).to("cuda", _TDT[dt])
    w = torch.from_numpy(randn(1, shape[-1:])).to("cuda", _TDT[dt])
    want = rmsnorm_ref(x, w, 1e-6)
    _no_plain(monkeypatch)
    before = rmsnorm.launches
    got = rmsnorm(x, w, 1e-6)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    close(got, want, TOL[f"rmsnorm_{dt}"])


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d,dt,offset,variant,tpr", [
    (4, 1536, "bf16", 0, LATENCY, 192),       # qwen2 decode
    (4, 1600, "bf16", 0, LATENCY, 224),       # hymba decode
    (5, 8192, "f32", 0, LATENCY, 1024),       # two vectors of x per thread
    (4096, 1536, "bf16", 0, ROWS, 32),        # qwen2 prefill
    (49152, 128, "bf16", 0, ROWS, 16),        # qk-norm heads: two rows per warp
    (1000, 24, "bf16", 0, ROWS, 4),           # 3 vectors a row, one idle lane
    (4096, 2048, "bf16", 0, STREAM, 32),      # 4 KiB rows, the narrowest that stream
    (4096, 1536, "f32", 0, STREAM, 32),       # qwen2 prefill in f32: 6 KiB rows
    (4608, 1600, "f32", 0, STREAM, 32),       # hymba prefill in f32
    (300, 8192, "bf16", 0, STREAM, 64),       # a row across 2 warps
    (300, 8192, "f32", 0, STREAM, 128),       # a row across 4 warps
    (37, 100, "bf16", 0, SCALAR, 32),         # d not a multiple of 8
    (4, 1536, "f32", 1, SCALAR, 32),          # x at an odd element offset
    (4096, 1536, "bf16", 3, SCALAR, 32),
])
def test_rmsnorm_each_variant_vs_plain(rows, d, dt, offset, variant, tpr, monkeypatch):
    """Each variant of the plan on the card, against the plain version and
    the CPU emulation of its own partition and order of reduction."""
    require_sm90()
    tdt = _TDT[dt]
    buf = torch.from_numpy(randn(0, (rows * d + offset,))).to("cuda", tdt)
    x = buf[offset:].view(rows, d)                 # contiguous, maybe misaligned
    w = torch.from_numpy(randn(1, (d,))).to("cuda", tdt)
    plan = kernel_plan(rows, d, tdt, offset == 0)
    assert (plan.variant, plan.tpr) == (variant, tpr)
    want = rmsnorm_ref(x, w, 1e-6)
    _no_plain(monkeypatch)
    before = rmsnorm.launches
    got = rmsnorm(x, w, 1e-6)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    close(got, want, TOL[f"rmsnorm_{dt}"])
    close(got, rmsnorm_tiled(x.cpu(), w.cpu(), 1e-6, plan), TOL[f"rmsnorm_{dt}"])
    attrs = kernel_attrs(plan, tdt)
    assert attrs["spill_bytes"] == 0 and attrs["smem_bytes"] >= plan.smem


@pytest.mark.gpu
@pytest.mark.parametrize("variant", [ROWS, STREAM])
@pytest.mark.parametrize("rows,d,dt", [(4096, 2304, "bf16"), (4096, 1024, "f32"),
                                       (300, 8192, "bf16")])
def test_rmsnorm_forced_variant_vs_plain(rows, d, dt, variant):
    """The entry point that times rows against stream (chip_smoke.py phase 3)
    launches the variant it was asked for, right at either width; inputs
    that rule out 16-byte loads raise."""
    require_sm90()
    tdt = _TDT[dt]
    x = torch.from_numpy(randn(0, (rows, d))).to("cuda", tdt)
    w = torch.from_numpy(randn(1, (d,))).to("cuda", tdt)
    y = torch.empty_like(x)
    rmsnorm_variant_cuda(x, w, y, rows, d, 1e-6, variant)
    close(y, rmsnorm_ref(x, w, 1e-6), TOL[f"rmsnorm_{dt}"])
    with pytest.raises(RuntimeError):
        rmsnorm_variant_cuda(x.view(-1)[1:1 + (rows - 1) * d].view(rows - 1, d), w, y,
                             rows - 1, d, 1e-6, variant)


@pytest.mark.gpu
def test_rmsnorm_c_plan_is_the_python_plan():
    require_sm90()
    for dt in (torch.float32, torch.bfloat16):
        for aligned in (True, False):
            for rows, d, n_sm in RMS_PLAN_GRID:
                assert kernel_plan(rows, d, dt, aligned, n_sm) == \
                    rmsnorm_plan(rows, d, dt, aligned, n_sm), (rows, d, dt, aligned, n_sm)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    assert kernel_plan(4096, 1536, torch.bfloat16, True) == \
        rmsnorm_plan(4096, 1536, torch.bfloat16, True, n_sm)


def _flash_launched(q, k, v, **kw):
    """flash_mha(q, k, v, **kw) and the rise of (launches, wgmma_launches):
    bf16 at hd 64/80/128 with a key is one tensor-core launch, Sk = 0 there
    none, anything else one CUDA-core (SIMT) launch."""
    before = flash_mha.launches, flash_mha.wgmma_launches
    got = flash_mha(q, k, v, **kw)
    torch.cuda.synchronize()
    tc = q.dtype == torch.bfloat16 and q.shape[-1] in WGMMA_HEAD_DIMS
    want = (0, 0) if tc and k.shape[1] == 0 else (1, int(tc))
    assert (flash_mha.launches - before[0], flash_mha.wgmma_launches - before[1]) == want
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal", [
    (2, 256, 256, 12, 2, 128, True),    # qwen2 heads
    (1, 300, 300, 4, 2, 64, True),      # ragged S
    (1, 300, 300, 4, 2, 64, False),
    (2, 96, 160, 4, 2, 32, True),       # Sq < Sk, top-left
    (2, 160, 96, 4, 2, 32, True),       # Sq > Sk
    (1, 130, 130, 8, 1, 16, True),      # MQA, hd 16
    (2, 64, 200, 3, 3, 128, False),     # MHA, non-causal, Sq != Sk
    (1, 5, 0, 2, 1, 16, True),          # no key at all: rows come out 0
    (1, 5, 0, 2, 1, 128, True),         # ... and at a tensor-core head dim
    (2, 333, 517, 6, 2, 128, True),     # tails of neither tile size, Sq < Sk
    (2, 517, 333, 6, 2, 128, True),     # Sq > Sk: rows past Sk see a ragged tile
    (1, 77, 300, 5, 1, 64, False),      # MQA, non-causal, one short query tile
    (2, 1, 129, 4, 4, 64, True),        # one row, one key past a tile
    (2, 300, 300, 16, 16, 80, False),   # HuBERT's heads (hd 80), ragged tiles
    (2, 333, 517, 6, 2, 80, True),      # hd 80, causal, Sq < Sk
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_cuda_vs_plain(B, Sq, Sk, H, KV, hd, causal, dt, monkeypatch):
    require_sm90()
    q = torch.from_numpy(randn(0, (B, Sq, H, hd))).to("cuda", _TDT[dt])
    k = torch.from_numpy(randn(1, (B, Sk, KV, hd))).to("cuda", _TDT[dt])
    v = torch.from_numpy(randn(2, (B, Sk, KV, hd))).to("cuda", _TDT[dt])
    want = flash_mha_ref(q, k, v, causal=causal)
    _no_plain(monkeypatch)
    got = _flash_launched(q, k, v, causal=causal)
    close(got, want, 1e-4 if dt == "f32" else TOL["flash_bf16"])


@pytest.mark.gpu
def test_flash_cuda_rejects_unsupported_head_dim():
    require_sm90()
    q = torch.zeros(1, 8, 2, 48, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        flash_mha(q, q, q)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [300, 1500])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_hd80_backward_vs_plain_and_twin(S, dt, monkeypatch):
    """HuBERT's attention (B 4, 16 heads of 80, non-causal) at its T 1500
    and at S 300, both ragged (1500 = 23 x 64 + 28), under autograd: one
    forward and one backward (bf16: both on the tensor cores; f32: both on
    the CUDA cores), against the plain backward (f32 1e-4; bf16 within the
    share of each gradient's max of the f32 backward) and the kernels' twin
    ``flash_mha_bwd_tiled`` on the same output (bf16: P and dS rounded as
    the tensor cores take them, within 1e-2 of each gradient's max); a
    second backward gives the same bits."""
    require_sm90()
    shape = (4, S, 16, 80)
    q, k, v, do = (torch.from_numpy(randn(40 + i, shape)).to("cuda", _TDT[dt])
                   for i in range(4))
    kw = dict(causal=False)
    want = flash_mha_bwd_ref(q.float(), k.float(), v.float(), do.float(), **kw)
    _no_plain(monkeypatch)
    out, grads = _flash_bwd_launched(q, k, v, do, kw)
    twin = flash_mha_bwd_tiled(q, k, v, out.detach(), do, tensor_cores=dt == "bf16", **kw)
    for got, w, t in zip(grads, want, twin):
        if dt == "f32":
            close(got, w, _BWD_TOL[("flash", dt)])
            close(got, t, _BWD_TOL[("flash", dt)])
        else:
            assert bool(torch.isfinite(got).all())
            err = float((got.float() - w).abs().max())
            assert err <= _FLASH_BWD_BF16 * float(w.abs().max()), err
            err = float((got.float() - t.float()).abs().max())
            assert err <= _TWIN_SHARE * float(t.float().abs().max()), err
    _, again = _flash_bwd_launched(q, k, v, do, kw)
    for a, b in zip(grads, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,hd,window,n_sink", [
    (2, 1152, 25, 5, 64, 1024, 128),    # hymba heads, S = window + sinks
    (1, 700, 25, 5, 64, 256, 128),      # S > window + sinks: skipped key tiles
    (2, 300, 4, 2, 64, 100, 7),         # ragged sinks and window vs the tiles
    (1, 200, 4, 2, 16, 16, 8),          # reduced-config shape
    (1, 130, 4, 1, 32, 5, 0),           # window without sinks, shorter than a tile
    (1, 600, 6, 2, 128, 200, 64),       # hd 128 under a window: skipped tiles
    (2, 427, 5, 5, 64, 5, 0),           # window of 5, no sinks, ragged S
    (1, 900, 5, 1, 64, 128, 300),       # sinks past the first tile, MQA
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_window_sink_cuda_vs_plain(B, S, H, KV, hd, window, n_sink, dt, monkeypatch):
    require_sm90()
    q = torch.from_numpy(randn(3, (B, S, H, hd))).to("cuda", _TDT[dt])
    k = torch.from_numpy(randn(4, (B, S, KV, hd))).to("cuda", _TDT[dt])
    v = torch.from_numpy(randn(5, (B, S, KV, hd))).to("cuda", _TDT[dt])
    want = flash_mha_ref(q, k, v, causal=True, window=window, n_sink=n_sink)
    _no_plain(monkeypatch)
    got = _flash_launched(q, k, v, causal=True, window=window, n_sink=n_sink)
    close(got, want, 1e-4 if dt == "f32" else TOL["flash_bf16"])


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window,n_sink", [
    (2, 1024, 1024, 12, 2, 128, True, 0, 0),     # qwen2 prefill heads
    (1, 1152, 1152, 25, 5, 64, True, 1024, 128),  # hymba, S = window + sinks
    (1, 700, 700, 25, 5, 64, True, 256, 128),    # hymba heads, skipped tiles
    (2, 333, 517, 6, 2, 128, True, 0, 0),
    (2, 300, 300, 4, 1, 64, False, 0, 0),
    # hd 80 (five 16-column boxes under the 32-byte swizzle): HuBERT's heads
    # (MHA, non-causal, ragged tiles), causal GQA with Sq < Sk, window and
    # sinks, Sq > Sk MQA, and no key at all (no launch, rows come out 0)
    (2, 1500, 1500, 16, 16, 80, False, 0, 0),
    (2, 333, 517, 6, 2, 80, True, 0, 0),
    (1, 300, 300, 4, 2, 80, True, 100, 7),
    (1, 517, 77, 4, 1, 80, False, 0, 0),
    (1, 5, 0, 2, 1, 80, False, 0, 0),
])
def test_flash_wgmma_vs_tiled_emulation(B, Sq, Sk, H, KV, hd, causal, window, n_sink,
                                        monkeypatch):
    """The tensor-core kernel against its tile loop in plain torch
    (``flash_mha_tiled``: the same tiles, P rounded to bf16 before P·V, l
    over the f32 p). What is left is sum order and the hardware exp2, which
    can move a p across a bf16 rounding edge; the output itself is one bf16
    rounding (2^-8 relative): tolerance 1e-2."""
    require_sm90()
    q = torch.from_numpy(randn(11, (B, Sq, H, hd))).to("cuda", torch.bfloat16)
    k = torch.from_numpy(randn(12, (B, Sk, KV, hd))).to("cuda", torch.bfloat16)
    v = torch.from_numpy(randn(13, (B, Sk, KV, hd))).to("cuda", torch.bfloat16)
    kw = dict(causal=causal, window=window, n_sink=n_sink)
    want = flash_mha_tiled(q, k, v, **kw)
    _no_plain(monkeypatch)
    close(_flash_launched(q, k, v, **kw), want, 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", WGMMA_HEAD_DIMS)
def test_flash_wgmma_c_plan_is_the_python_plan(hd):
    """Shared memory per block of each serve instance of the tensor-core
    forward (windowed and not) is ``wgmma_smem_plan(hd)``'s, the twin of
    ``Cfg<HD>``."""
    require_sm90()
    for windowed in (False, True):
        assert wgmma_kernel_attrs(hd, windowed)["smem_bytes"] == \
            wgmma_smem_plan(hd)["smem_bytes"]


@pytest.mark.gpu
def test_flash_wgmma_hd80_attrs():
    """The hd-80 instances (32-byte swizzle, 3 stages), serve and the one
    that stores L for the backward: no spill, shared memory within the 227
    KiB a block may use, and the L instance's output equal to the serve
    instance's bit for bit (HuBERT's heads, non-causal; causal with a
    window)."""
    require_sm90()
    for windowed in (False, True):
        for lse in (False, True):
            a = wgmma_kernel_attrs(80, windowed, lse=lse)
            assert a["spill_bytes"] == 0 and 0 < a["registers"] <= 255, a
            assert 140 * 1024 <= a["smem_bytes"] <= SMEM_PER_BLOCK, a
    for B, S, H, KV, kw in ((2, 1500, 16, 16, dict(causal=False)),
                            (1, 300, 4, 2, dict(causal=True, window=100, n_sink=7))):
        q = torch.from_numpy(randn(14, (B, S, H, 80))).to("cuda", torch.bfloat16)
        k = torch.from_numpy(randn(15, (B, S, KV, 80))).to("cuda", torch.bfloat16)
        v = torch.from_numpy(randn(16, (B, S, KV, 80))).to("cuda", torch.bfloat16)
        serve, with_l = torch.empty_like(q), torch.empty_like(q)
        lse = torch.full((B * H, lse_rows(S)), float("nan"), device="cuda")
        flash_attention_wgmma_cuda(q, k, v, serve, **kw)
        flash_attention_wgmma_cuda(q, k, v, with_l, lse=lse, **kw)
        torch.cuda.synchronize()
        assert torch.equal(serve, with_l)
        assert bool(torch.isfinite(lse[:, :S]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_flash_without_window_is_bitwise_the_plain_causal_kernel(causal, monkeypatch):
    """window = n_sink = 0, and a window no row can reach past, launch the
    kernel with the plain causal mask: the outputs are equal bit for bit."""
    require_sm90()
    q = torch.from_numpy(randn(6, (2, 300, 12, 128))).to("cuda", torch.bfloat16)
    k = torch.from_numpy(randn(7, (2, 300, 2, 128))).to("cuda", torch.bfloat16)
    v = torch.from_numpy(randn(8, (2, 300, 2, 128))).to("cuda", torch.bfloat16)
    _no_plain(monkeypatch)
    old = flash_mha(q, k, v, causal=causal)
    assert torch.equal(flash_mha(q, k, v, causal=causal, window=0, n_sink=0), old)
    assert torch.equal(flash_mha(q, k, v, causal=causal, window=300, n_sink=0), old)


# the CUDA-core forward's twin: its tiles, P kept in f32
_SIMT_TWIN = dict(block_q=SIMT_TILE, block_k=SIMT_TILE, tensor_cores=False)


def _rows_without_keys(Sq, Sk, causal, window, n_sink):
    rows = torch.arange(Sq)[:, None]
    cols = torch.arange(max(Sk, 1))[None, :]
    vis = visible(rows, cols, Sk, causal=causal, window=window if causal else 0,
                  n_sink=n_sink if causal else 0).expand(Sq, -1)
    return ~vis.any(1)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window,n_sink,dt", [
    (4, 1024, 1024, 12, 2, 128, True, 0, 0, "f32"),      # qwen2 train
    (1, 1152, 1152, 25, 5, 64, True, 1024, 128, "f32"),  # hymba, S = window + sinks
    (1, 700, 700, 25, 5, 64, True, 256, 128, "f32"),     # skipped key tiles
    (2, 333, 517, 6, 2, 128, True, 0, 0, "f32"),         # tails of neither tile, Sq < Sk
    (2, 517, 333, 6, 2, 32, True, 0, 0, "f32"),          # Sq > Sk
    (2, 300, 300, 4, 1, 16, False, 0, 0, "f32"),         # MQA, non-causal
    (1, 77, 300, 3, 3, 64, False, 0, 0, "f32"),          # MHA, one short query tile
    (1, 200, 64, 4, 2, 64, True, 16, 0, "f32"),          # rows 79.. see no key
    (1, 5, 0, 2, 1, 128, True, 0, 0, "f32"),             # no key at all
    (2, 130, 130, 8, 2, 16, True, 0, 0, "bf16"),         # reduced configs' hd
    (2, 300, 300, 4, 2, 32, True, 100, 7, "bf16"),
    (1, 77, 300, 5, 1, 32, False, 0, 0, "bf16"),
    # hd 80 in f32 (HuBERT: 16 heads, MHA, non-causal): every column of the
    # five a thread owns, staged in a partial last group of loads (bf16 at
    # hd 80 runs the tensor-core kernel: test_flash_wgmma_vs_tiled_emulation)
    (2, 1500, 1500, 16, 16, 80, False, 0, 0, "f32"),
    (2, 333, 517, 6, 2, 80, True, 0, 0, "f32"),          # causal, ragged, GQA
    (1, 300, 300, 4, 2, 80, True, 100, 7, "f32"),        # window and sinks
])
def test_flash_simt_vs_tiled_emulation(B, Sq, Sk, H, KV, hd, causal, window, n_sink, dt,
                                       monkeypatch):
    """The CUDA-core kernel against its tile loop in plain torch
    (``flash_mha_tiled`` at ``SIMT_TILE`` x ``SIMT_TILE``, P in f32):
    the same tiles, skips and online softmax; what is left is sum order and
    the hardware exp2. f32 to 1e-4; bf16 to 1e-2, one bf16 rounding of the
    output (2^-8). A row that sees no key comes out exactly 0, and a second
    call gives the same bits."""
    require_sm90()
    q = torch.from_numpy(randn(21, (B, Sq, H, hd))).to("cuda", _TDT[dt])
    k = torch.from_numpy(randn(22, (B, Sk, KV, hd))).to("cuda", _TDT[dt])
    v = torch.from_numpy(randn(23, (B, Sk, KV, hd))).to("cuda", _TDT[dt])
    kw = dict(causal=causal, window=window, n_sink=n_sink)
    want = flash_mha_tiled(q, k, v, **kw, **_SIMT_TWIN)
    _no_plain(monkeypatch)
    got = _flash_launched(q, k, v, **kw)
    close(got, want, 1e-4 if dt == "f32" else 1e-2)
    empty = _rows_without_keys(Sq, Sk, causal, window, n_sink).cuda()
    assert torch.all(got[:, empty] == 0)
    assert torch.equal(flash_mha(q, k, v, **kw), got)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_forward_simt_attrs(hd, dt):
    """Registers, spill and shared memory of the CUDA-core forward's serve
    and L instances: neither spills, f32 at hd 128 included; the card's
    occupancy calculator fits at least the two blocks an SM the kernel is
    built for, as do the SM's registers (65,536) and shared memory (228 KiB,
    1 KiB of it reserved per block)."""
    require_sm90()
    for lse in (False, True):
        a = flash_kernel_attrs(hd, _TDT[dt], lse)
        assert a["blocks_per_sm"] >= 2 and a["registers"] > 0, a
        assert a["spill_bytes"] == 0, a
        assert 2 * 256 * a["registers"] <= 65536, a
        assert 2 * (a["smem_bytes"] + 1024) <= 228 * 1024, a


@pytest.mark.gpu
@pytest.mark.parametrize("dt,hd", [("f32", 128), ("f32", 16), ("bf16", 32), ("f32", 80),
                                   ("bf16", 80)])
def test_flash_simt_reads_misaligned_inputs(dt, hd, monkeypatch):
    """Contiguous q, k, v that do not start on 16 bytes: the CUDA-core
    kernel stages them element by element (its 16-byte loads need aligned
    rows) and writes what the aligned call writes, bit for bit. bf16 at hd
    80 runs on the tensor cores (TMA needs 16-byte aligned tensors): the
    wrapper raises before any launch, and nothing falls back to the
    CUDA-core kernel."""
    require_sm90()
    shapes = ((2, 200, 4, hd), (2, 200, 2, hd), (2, 200, 2, hd))
    mis = []
    for i, shape in enumerate(shapes):
        n = shape[0] * shape[1] * shape[2] * shape[3]
        buf = torch.from_numpy(randn(27 + i, (n + 1,))).to("cuda", _TDT[dt])
        mis.append(buf[1:].view(shape))
        assert mis[-1].data_ptr() % 16
    aligned = [t.clone() for t in mis]
    _no_plain(monkeypatch)
    for kw in (dict(causal=True), dict(causal=True, window=50, n_sink=3)):
        if _TDT[dt] == torch.bfloat16 and hd in WGMMA_HEAD_DIMS:
            before = flash_mha.launches, flash_mha.wgmma_launches
            with pytest.raises(ValueError, match="16-byte aligned"):
                flash_mha(*mis, **kw)
            assert (flash_mha.launches, flash_mha.wgmma_launches) == before
            continue
        assert torch.equal(_flash_launched(*mis, **kw), _flash_launched(*aligned, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 257, 51200), (37, 100), (1, 4097),
                                   (3, 45, 130), (2, 1, 333), (1, 1, 1)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ssm_scan_cuda_vs_plain(shape, dt, monkeypatch):
    require_sm90()
    a = torch.sigmoid(torch.from_numpy(randn(9, shape))).to("cuda", _TDT[dt])
    b = torch.from_numpy(randn(10, shape)).to("cuda", _TDT[dt])
    want = ssm_scan_ref(a, b)
    _no_plain(monkeypatch)
    before = ssm_scan_batched.launches
    got = ssm_scan_batched(a, b)
    torch.cuda.synchronize()
    assert ssm_scan_batched.launches == before + 1
    assert got.dtype == a.dtype and got.shape == a.shape
    close(got, want, TOL[f"scan_{dt}"])


def _schedule_bitwise(arrays, pm, repeats, monkeypatch, variant=None):
    """The kernel (the plan's variant, or ``variant`` forced) equals its
    plain version on the card bit for bit."""
    feats, ints = task_tensors(arrays, torch.device("cuda"))
    params = torch.from_numpy(pm.astype("float32")).cuda()
    want = list_schedule_ref(feats, ints, params, arrays.n_units, repeats)
    ran = list_schedule_plan(len(arrays.deps), len(pm), arrays.n_units, variant).variant
    with monkeypatch.context() as m:
        _no_plain(m)
        before = list_schedule.launches, list_schedule.variant_launches[ran]
        got = list_schedule(feats, ints, params, arrays.n_units, repeats, variant=variant)
        torch.cuda.synchronize()
        assert (list_schedule.launches, list_schedule.variant_launches[ran]) == \
            (before[0] + 1, before[1] + 1)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        assert bool(torch.isfinite(g).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n,n_units,classes,cross,max_deps,dep_hi", [
    (1, 1, (0,), 0.0, 8, None),            # a single task of each class
    (1, 1, (1,), 0.0, 8, None),
    (1, 1, (2,), 0.0, 8, None),
    (1, 1, (3,), 1.0, 8, None),
    (200, 4, (0, 1, 2, 3), 0.3, 0, None),  # every dependency slot -1
    (200, 3, (3,), 0.5, 8, None),          # collectives, half cross-pod
    (500, 7, (0, 1, 2, 3), 0.3, 8, None),  # every engine class
    (300, 5, (0, 1, 2, 3), 0.3, 8, 320),   # dependencies at i or past N read 0.0
])
def test_list_schedule_cuda_vs_plain(n, n_units, classes, cross, max_deps, dep_hi,
                                     monkeypatch):
    require_sm90()
    arrays = random_task_arrays(n, n, n_units, classes=classes, cross=cross,
                                max_deps=max_deps, dep_hi=dep_hi)
    for pm in (hw_param_matrix(), hw_param_matrix()[:1],
               hw_param_matrix()[[i % 12 for i in range(192)]]):
        _schedule_bitwise(arrays, pm, 1, monkeypatch)


@pytest.mark.gpu
@pytest.mark.parametrize("repeats", [1, 6])
def test_list_schedule_cuda_vs_plain_hlo_tp2(repeats, monkeypatch):
    """The largest captured graph of the builtin campaigns, N 6,122."""
    require_sm90()
    from repro_torch.graph.compiler import CompileOptions, compile_ops
    from repro_torch.graph.workloads import resolve_workload
    from repro_torch.hw.presets import resolve_preset

    cw = compile_ops(resolve_workload("hlo/qwen2_1_5b_prefill_tp2")(),
                     resolve_preset("v5e"), CompileOptions(n_tiles=2))
    arrays = from_tasks(cw.tasks)
    assert len(cw.tasks) == 6122 and arrays.n_units == 6
    _schedule_bitwise(arrays, hw_param_matrix()[:2], repeats, monkeypatch)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n,n_units,dep_hi", [
    (300, 5, 320),     # dependency slots at i or later, and past N
    (500, 7, None),
    (2000, 1, None),   # one engine: every step forwards the free time
])
def test_list_schedule_each_variant_vs_plain(variant, n, n_units, dep_hi, monkeypatch):
    require_sm90()
    arrays = random_task_arrays(n, n, n_units, dep_hi=dep_hi)
    for pm in (hw_param_matrix()[:1], hw_param_matrix()[[i % 12 for i in range(192)]]):
        _schedule_bitwise(arrays, pm, 3, monkeypatch, variant=variant)


@pytest.mark.gpu
def test_list_schedule_c_plan_is_the_python_plan():
    require_sm90()
    for n in (1, 2, 42, 1000, 3623, 3624, 6122, 7263, 9676, 9677, 9682, 9683, 9684, 29000,
              200000):
        for k in (1, 2, 192, 1000):
            for n_units in (1, 6, 40):
                for variant in (None,) + VARIANTS:
                    want = list_schedule_plan(n, k, n_units, variant)
                    want = type(want)(want.variant, want.vectors, want.grid, want.threads,
                                      min(want.smem, SMEM_LIMIT + 1))
                    assert sched_kernel_plan(n, k, n_units, variant) == want, \
                        (n, k, n_units, variant)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [9683, 60000])
def test_list_schedule_refuses_shared_memory_above_the_limit(n):
    """The shared variant forced where even T 1 does not fit is refused at
    launch and raises; it returns nothing."""
    require_sm90()
    arrays = random_task_arrays(0, n, 6)
    feats, ints = task_tensors(arrays, torch.device("cuda"))
    params = torch.from_numpy(hw_param_matrix()[:2].astype("float32")).cuda()
    assert list_schedule_plan(n, 2, 6, "shared").smem > SMEM_LIMIT
    before = list_schedule.launches
    with pytest.raises(RuntimeError, match="repro_list_schedule"):
        list_schedule(feats, ints, params, 6, variant="shared")
    assert list_schedule.launches == before
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [9683, 60000])
def test_list_schedule_global_plan_above_the_shared_limit(n, monkeypatch):
    """A graph that does not fit in shared memory at T 1 takes the global
    variant, and the wrapper allocates its scratch."""
    require_sm90()
    arrays = random_task_arrays(1, n, 6)
    assert list_schedule_plan(n, 2, 6).variant == "global"
    _schedule_bitwise(arrays, hw_param_matrix()[:2], 1, monkeypatch)


# -- backward kernels -----------------------------------------------------------

# kernel vs the plain version's autograd on the card: f32 differs in sum
# order; bf16 rmsnorm by one rounding of each gradient
_BWD_TOL = {("rmsnorm", "f32"): 1e-4, ("rmsnorm", "bf16"): 3e-2, ("flash", "f32"): 1e-4}
# bf16 flash: max |got - want| within this share of max |want| for each of dQ,
# dK, dV, want the plain backward in f32 of the same bf16 inputs (a sound
# kernel differs by the rounding of each gradient and of the saved output
# that D reads; a gradient 10% off or a dS without D reads far above it)
_FLASH_BWD_BF16 = 2e-2
# the bf16 tensor-core backward against its twin (P and dS rounded as the
# kernels round them): sum order, the hardware exp2 and one bf16 rounding of
# each gradient are left
_TWIN_SHARE = 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4096, 1536), (2, 1024, 12, 128), (37, 100), (5, 8192),
                                   (3, 16), (600, 64)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rmsnorm_backward_cuda_vs_plain(shape, dt, monkeypatch):
    require_sm90()
    x = torch.from_numpy(randn(0, shape)).to("cuda", _TDT[dt])
    w = (1 + 0.1 * torch.from_numpy(randn(1, shape[-1:]))).to("cuda", _TDT[dt])
    g = torch.from_numpy(randn(2, shape)).to("cuda", _TDT[dt])
    want = rmsnorm_bwd_ref(x, w, g, 1e-6)
    _no_plain(monkeypatch)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    before = rmsnorm.launches, rmsnorm.bwd_launches
    out = rmsnorm(xr, wr, 1e-6)
    assert out.grad_fn is not None
    out.backward(g)
    torch.cuda.synchronize()
    assert (rmsnorm.launches, rmsnorm.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert xr.grad.dtype == x.dtype and wr.grad.dtype == w.dtype
    tol = _BWD_TOL[("rmsnorm", dt)]
    close(xr.grad, want[0], tol)
    close(wr.grad, want[1], tol)
    # dw is summed in a fixed order, without atomics: the same bits again
    first = xr.grad.clone(), wr.grad.clone()
    xr.grad = wr.grad = None
    rmsnorm(xr, wr, 1e-6).backward(g)
    assert torch.equal(xr.grad, first[0]) and torch.equal(wr.grad, first[1])


# (rows, d, dtype, element offset of x, g and dx): every backward variant
# and lane count, the qwen2 train rows, a row spanning two and eight warps
_RMS_BWD_CASES = [
    (4096, 1536, "f32", 0), (4096, 1536, "bf16", 0), (49152, 128, "f32", 0),
    (49152, 128, "bf16", 0), (300, 2000, "f32", 0), (40, 8192, "bf16", 0),
    (77, 24, "f32", 0), (600, 64, "f32", 1), (33, 100, "bf16", 0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d,dt,offset", _RMS_BWD_CASES)
def test_rmsnorm_backward_vs_tiled_emulation(rows, d, dt, offset):
    """The kernel against its emulation (``rmsnorm_bwd_tiled``: the same
    lanes, rows and orders of summation) under the C plan, which must be
    the Python plan."""
    require_sm90()
    dtype = _TDT[dt]

    def shifted(a):             # a [rows, d] view starting `offset` elements in
        flat = torch.from_numpy(a).to("cuda", dtype).flatten()
        buf = torch.empty(flat.numel() + offset, dtype=dtype, device="cuda")
        buf[offset:] = flat
        return buf[offset:].view(rows, d)

    x, g = shifted(randn(3, (rows, d))), shifted(randn(4, (rows, d)))
    w = (1 + 0.1 * torch.from_numpy(randn(5, (d,)))).to("cuda", dtype)
    dx = torch.empty(rows * d + offset, dtype=dtype, device="cuda")[offset:].view(rows, d)
    dw = torch.empty_like(w)
    blocks = bwd_blocks(rows, 0)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, g, dx, w))
    plan = bwd_kernel_plan(rows, d, dtype, aligned, blocks)
    assert plan == rmsnorm_bwd_plan(rows, d, dtype, aligned, blocks)
    assert plan.variant == (BWD_VECTOR if offset == 0 and d % (16 // x.element_size()) == 0
                            else BWD_SCALAR)
    rmsnorm_bwd_cuda(x, w, g, dx, dw, rows, d, 1e-6, 0 if dt == "f32" else 1)
    torch.cuda.synchronize()
    want = rmsnorm_bwd_tiled(x.cpu(), w.cpu(), g.cpu(), 1e-6, plan)
    tol = _BWD_TOL[("rmsnorm", dt)]
    close(dx, want[0], tol)
    close(dw, want[1], tol)
    attrs = bwd_kernel_attrs(plan, dtype)
    assert attrs["registers"] > 0 and attrs["smem_bytes"] >= plan.smem


_FLASH_BWD_CASES = [
    # B, S, H, KV, hd, causal, window, n_sink
    (4, 1024, 12, 2, 128, True, 0, 0),        # qwen2 train
    (2, 300, 12, 2, 128, True, 0, 0),         # ragged S
    (2, 300, 6, 2, 64, False, 0, 0),          # non-causal
    (1, 256, 8, 1, 64, True, 0, 0),           # MQA
    (2, 130, 4, 4, 32, True, 0, 0),           # MHA, hd 32
    (2, 40, 4, 2, 16, True, 16, 8),           # hymba reduced
    (1, 700, 25, 5, 64, True, 256, 128),      # window and sinks, skipped tiles
    (2, 300, 4, 2, 64, True, 100, 7),         # ragged window and sinks
    (1, 1152, 25, 5, 64, True, 1024, 128),    # hymba train heads
    (2, 300, 16, 16, 80, False, 0, 0),        # HuBERT's heads (hd 80), ragged
    (2, 333, 6, 2, 80, True, 0, 0),           # hd 80, causal, GQA
    (1, 300, 4, 2, 80, True, 100, 7),         # hd 80, window and sinks
]


def _flash_bwd_launched(q, k, v, do, kw):
    """Forward and backward through the wrapper; the rise of the counts
    (launches, wgmma_launches, bwd_launches, wgmma_bwd_launches) must be one
    forward and one backward, each on the tensor cores for bf16 at hd
    64/80/128 (``WGMMA_HEAD_DIMS``, ``WGMMA_BWD_HEAD_DIMS``)."""
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    names = ("launches", "wgmma_launches", "bwd_launches", "wgmma_bwd_launches")
    before = [getattr(flash_mha, n) for n in names]
    out = flash_mha(qr, kr, vr, **kw)
    assert out.grad_fn is not None
    out.backward(do)
    torch.cuda.synchronize()
    bf16, hd = q.dtype == torch.bfloat16, q.shape[-1]
    tc_fwd, tc_bwd = int(bf16 and hd in WGMMA_HEAD_DIMS), int(bf16 and hd in WGMMA_BWD_HEAD_DIMS)
    assert [getattr(flash_mha, n) - b for n, b in zip(names, before)] == [1, tc_fwd, 1, tc_bwd]
    return out, (qr.grad, kr.grad, vr.grad)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,hd,causal,window,n_sink", _FLASH_BWD_CASES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_backward_cuda_vs_plain(B, S, H, KV, hd, causal, window, n_sink, dt,
                                      monkeypatch):
    require_sm90()
    q = torch.from_numpy(randn(0, (B, S, H, hd))).to("cuda", _TDT[dt])
    k = torch.from_numpy(randn(1, (B, S, KV, hd))).to("cuda", _TDT[dt])
    v = torch.from_numpy(randn(2, (B, S, KV, hd))).to("cuda", _TDT[dt])
    do = torch.from_numpy(randn(3, (B, S, H, hd))).to("cuda", _TDT[dt])
    kw = dict(causal=causal, window=window, n_sink=n_sink)
    want = flash_mha_bwd_ref(q, k, v, do, **kw)
    want32 = flash_mha_bwd_ref(q.float(), k.float(), v.float(), do.float(), **kw)
    _no_plain(monkeypatch)
    out, grads = _flash_bwd_launched(q, k, v, do, kw)
    for got, w, w32 in zip(grads, want, want32):
        assert got.dtype == w.dtype
        if dt == "f32":
            close(got, w, _BWD_TOL[("flash", dt)])
        else:
            assert bool(torch.isfinite(got).all())
            err = float((got.float() - w32).abs().max())
            assert err <= _FLASH_BWD_BF16 * float(w32.abs().max()), err
    # the emulation of the kernels on the same inputs: f32 up to sum order;
    # bf16 with P and dS rounded as the kernels round them (tensor_cores on
    # the tensor-core path), within the bf16 limit of the f32 gradient
    tc = dt == "bf16" and hd in WGMMA_BWD_HEAD_DIMS
    twin = flash_mha_bwd_tiled(q, k, v, out.detach(), do, tensor_cores=tc, **kw)
    for got, w in zip(grads, twin):
        if dt == "f32":
            close(got, w, _BWD_TOL[("flash", dt)])
        else:
            err = float((got.float() - w.float()).abs().max())
            assert err <= _FLASH_BWD_BF16 * float(w.float().abs().max()), err
    # no atomics: a second backward on the same inputs gives the same bits
    _, again = _flash_bwd_launched(q, k, v, do, kw)
    for a, b in zip(grads, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("Sq,Sk,hd,causal", [(200, 500, 128, True), (500, 200, 128, True),
                                             (77, 300, 64, False), (333, 140, 64, True),
                                             (130, 60, 32, True), (77, 300, 80, False),
                                             (333, 140, 80, True)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_backward_sq_ne_sk_cuda_vs_plain(Sq, Sk, hd, causal, dt, monkeypatch):
    """Sq != Sk both ways (the top-left causal mask), tails of neither tile,
    keys no row sees (Sk > Sq) and a key tile shorter than a TMA box."""
    require_sm90()
    q = torch.from_numpy(randn(20, (2, Sq, 6, hd))).to("cuda", _TDT[dt])
    k = torch.from_numpy(randn(21, (2, Sk, 2, hd))).to("cuda", _TDT[dt])
    v = torch.from_numpy(randn(22, (2, Sk, 2, hd))).to("cuda", _TDT[dt])
    do = torch.from_numpy(randn(23, (2, Sq, 6, hd))).to("cuda", _TDT[dt])
    kw = dict(causal=causal)
    want = flash_mha_bwd_ref(q.float(), k.float(), v.float(), do.float(), **kw)
    _no_plain(monkeypatch)
    _, grads = _flash_bwd_launched(q, k, v, do, kw)
    for got, w in zip(grads, want):
        if dt == "f32":
            close(got, w, _BWD_TOL[("flash", dt)])
        else:
            err = float((got.float() - w).abs().max())
            assert err <= _FLASH_BWD_BF16 * float(w.abs().max()), err


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,hd,causal,window,n_sink", _FLASH_BWD_CASES[:4]
                         + _FLASH_BWD_CASES[6:])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_forward_lse_instance(B, S, H, KV, hd, causal, window, n_sink, dt):
    """The forward instance that stores L writes the serve instance's output
    bit for bit, and L equal to its own kernel's tile loop's (exp2 domain;
    the CUDA-core kernel's twin at 64 x 64 with P in f32, the tensor-core
    kernel's at 128 x 128) to 1e-4 (bf16: the scores are the same bf16
    products, summed in another order)."""
    require_sm90()
    q = torch.from_numpy(randn(6, (B, S, H, hd))).to("cuda", _TDT[dt])
    k = torch.from_numpy(randn(7, (B, S, KV, hd))).to("cuda", _TDT[dt])
    v = torch.from_numpy(randn(8, (B, S, KV, hd))).to("cuda", _TDT[dt])
    kw = dict(causal=causal, window=window, n_sink=n_sink)
    tc = dt == "bf16" and hd in WGMMA_HEAD_DIMS
    launch = flash_attention_wgmma_cuda if tc else flash_attention_cuda
    plain, with_l = torch.empty_like(q), torch.empty_like(q)
    lse = torch.full((B * H, lse_rows(S)), float("nan"), device="cuda")
    launch(q, k, v, plain, **kw)
    launch(q, k, v, with_l, lse=lse, **kw)
    torch.cuda.synchronize()
    assert torch.equal(plain, with_l)
    _, want = flash_mha_tiled(q, k, v, return_lse=True, **kw, **({} if tc else _SIMT_TWIN))
    close(lse.view(B, H, -1)[:, :, :S], want, 1e-4)


@pytest.mark.gpu
def test_flash_backward_split_plan_c_is_python():
    require_sm90()
    for Sq, Sk, H, KV in ((1024, 1024, 12, 2), (1152, 1152, 25, 5), (300, 517, 4, 1),
                          (517, 300, 8, 8), (40, 40, 4, 2), (64, 1, 2, 1)):
        for causal, window, n_sink in ((True, 0, 0), (False, 0, 0), (True, 100, 7),
                                       (True, 1024, 128), (True, 5, 0)):
            kw = dict(causal=causal, window=window, n_sink=n_sink)
            assert bwd_slots(Sq, Sk, H, KV, **kw) == len(bwd_split_plan(Sq, Sk, H // KV,
                                                                         **kw))


# shared memory per block of the CUDA-core dQ and dK/dV kernels
# (simt_smem<HD> in csrc/flash_attention_bwd.cu): staged f32 rows padded by 4
# floats, the [64][68] P / dS tiles, and L and D of the dK/dV kernel
def _simt_bwd_smem(kernel, hd):
    rows = 4 * 64 * (hd + 4)
    return 4 * (rows + (2 * 64 * 68 + 128 if kernel == "dkdv" else 64 * 68))


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 80])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_backward_kernel_attrs(hd, dt):
    """Registers, spill and shared memory of every backward instance a call
    launches, and of the forward instances that store L; the tensor-core
    ones (bf16 at hd 64/80/128) must not spill, ask for the shared memory of
    their plan (``wgmma_bwd_smem_plan``; hd 80: five 16-column boxes a
    tile, 82.6 KiB) and run two blocks an SM (the occupancy calculator); the
    CUDA-core ones ask for their plan's shared memory (f32 at hd 80: 118.5
    KiB for dK/dV, 101.0 KiB for dQ)."""
    require_sm90()
    for kernel in ("dq", "dkdv", "delta", "finalize"):
        a = flash_bwd_attrs(kernel, hd, _TDT[dt])
        assert a["registers"] > 0 and a["blocks_per_sm"] >= 1, a
        if kernel not in ("dq", "dkdv"):
            continue
        if dt == "bf16" and hd in WGMMA_BWD_HEAD_DIMS:
            assert a["spill_bytes"] == 0 and a["blocks_per_sm"] == 2, a
            assert a["smem_bytes"] == wgmma_bwd_smem_plan(hd)["smem_bytes"], a
        else:
            assert a["smem_bytes"] == _simt_bwd_smem(kernel, hd), a
    if dt == "bf16" and hd in WGMMA_HEAD_DIMS:
        for windowed in (False, True):
            assert (wgmma_kernel_attrs(hd, windowed, lse=True)["spill_bytes"]
                    == wgmma_kernel_attrs(hd, windowed)["spill_bytes"] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 80])
def test_flash_backward_raises_on_misaligned_bf16(hd):
    """The tensor-core backward takes 16-byte aligned tensors only; a
    misaligned dout raises, nothing falls back."""
    require_sm90()
    q = torch.randn(1, 64, 2, hd, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    k = torch.randn(1, 64, 1, hd, device="cuda", dtype=torch.bfloat16)
    v = torch.randn(1, 64, 1, hd, device="cuda", dtype=torch.bfloat16)
    out = flash_mha(q, k, v)
    buf = torch.randn(out.numel() + 1, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        out.backward(buf[1:].view(out.shape))


# the scan's backward vs ssm_scan_bwd_ref on the card: max |err| within this
# share of each gradient's max (f32: one FMA against a multiply and an add
# per step; bf16: one rounding of each gradient and of the saved h)
_SCAN_BWD_SHARE = {"f32": 1e-4, "bf16": 2e-2}


def _scan_bwd_inputs(shape, dt, offset=0):
    """a in (0, 1), b and dh, each at an element ``offset`` into its buffer."""
    n = 1
    for s in shape:
        n *= s
    out = []
    for seed, f in ((20, torch.sigmoid), (21, None), (22, None)):
        t = torch.from_numpy(randn(seed, (n + offset,)))
        out.append((f(t) if f else t).to("cuda", _TDT[dt])[offset:].view(shape))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 1152, 51200), (2, 257, 513), (37, 100), (1, 4097),
                                   (3, 45, 130), (2, 1, 333), (1, 1, 1), (5, 9, 7)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ssm_scan_backward_cuda_vs_plain(shape, dt, monkeypatch):
    """The backward kernel under the wrapper's autograd against the reverse
    scan's plain version; a second backward gives the same bits."""
    require_sm90()
    a, b, g = _scan_bwd_inputs(shape, dt)
    want = ssm_scan_bwd_ref(a, ssm_scan_ref(a, b), g)
    _no_plain(monkeypatch)
    ar, br = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    before = ssm_scan_batched.launches, ssm_scan_batched.bwd_launches
    out = ssm_scan_batched(ar, br)
    assert out.grad_fn is not None
    out.backward(g)
    torch.cuda.synchronize()
    assert (ssm_scan_batched.launches, ssm_scan_batched.bwd_launches) == \
        (before[0] + 1, before[1] + 1)
    for got, w in zip((ar.grad, br.grad), want):
        assert got.dtype == a.dtype and got.shape == a.shape
        assert bool(torch.isfinite(got).all())
        err = float((got.float() - w.float()).abs().max())
        assert err <= _SCAN_BWD_SHARE[dt] * max(float(w.float().abs().max()), 1e-30)
    first = ar.grad.clone(), br.grad.clone()
    ar.grad = br.grad = None
    ssm_scan_batched(ar, br).backward(g)
    assert torch.equal(ar.grad, first[0]) and torch.equal(br.grad, first[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ssm_scan_backward_reads_misaligned_inputs(dt):
    """Inputs one element into their buffers give the bits of aligned ones."""
    require_sm90()
    mis = _scan_bwd_inputs((3, 70, 129), dt, offset=1)
    assert mis[0].data_ptr() % 16
    aligned = [t.clone() for t in mis]

    def grads(a, b, g):
        ar, br = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        ssm_scan_batched(ar, br).backward(g)
        return ar.grad, br.grad

    for got, want in zip(grads(*mis), grads(*aligned)):
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ssm_scan_kernel_attrs(dt):
    require_sm90()
    for backward in (False, True):
        attrs = scan_kernel_attrs(_TDT[dt], backward)
        assert 0 < attrs["registers"] <= 255 and attrs["smem_bytes"] == 0


@pytest.mark.gpu
def test_list_schedule_raises_under_grad_on_the_card():
    require_sm90()
    arrays = random_task_arrays(0, 30, 2)
    feats, ints = task_tensors(arrays, torch.device("cuda"))
    params = torch.from_numpy(hw_param_matrix()).float().cuda().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        list_schedule(feats, ints, params, arrays.n_units)
    with torch.no_grad():
        assert list_schedule(feats, ints, params, arrays.n_units)[0].shape == (12,)
