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
from repro_torch.kernels.flash_attention.kernel import WGMMA_HEAD_DIMS
from repro_torch.kernels.flash_attention.ops import flash_mha
from repro_torch.kernels.flash_attention.ref import flash_mha_ref, flash_mha_tiled
from repro_torch.kernels.list_schedule import ops as sched_ops
from repro_torch.kernels.list_schedule.kernel import kernel_plan as sched_kernel_plan
from repro_torch.kernels.list_schedule.ops import list_schedule
from repro_torch.kernels.list_schedule.ref import (SMEM_LIMIT, VARIANTS, list_schedule_plan,
                                                   list_schedule_ref)
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.kernel import kernel_attrs, kernel_plan, rmsnorm_variant_cuda
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import (LATENCY, ROWS, SCALAR, STREAM, rmsnorm_plan,
                                             rmsnorm_ref, rmsnorm_tiled)
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.kernels.ssm_scan.ops import ssm_scan_batched
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _no_plain(monkeypatch):
    """Make the plain versions unreachable from the wrappers."""
    def boom(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(rms_ops, "rmsnorm_ref", boom)
    monkeypatch.setattr(flash_ops, "flash_mha_ref", boom)
    monkeypatch.setattr(scan_ops, "ssm_scan_ref", boom)
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
    bf16 at hd 64/128 with a key is one tensor-core launch, Sk = 0 there
    none, anything else one scalar launch."""
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
