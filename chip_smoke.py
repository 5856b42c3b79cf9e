#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

  python3 chip_smoke.py

Two main paths are driven, each at full width and full depth: the dense
decoder qwen2-1.5b and the hybrid hymba-1.5b (attention and Mamba heads,
sliding window with meta-token sinks). Phases, each of which fails the run
(non-zero exit, no result line):

  1. card   — name and power limit from nvidia-smi;
  2. build  — one nvcc per CUDA source, all started together, and one link
     build the kernels from src/;
  3. kernels — each kernel against its plain PyTorch version in f32 and
     bf16 at the main-path shapes of both models and at edge shapes; at
     the main-path shapes the kernel, the plain version and one library
     call (where one exists) are timed with CUDA events (median of 25, L2
     flushed before each launch). rmsnorm: at the main shapes the variant
     its plan chose, its registers and shared memory, the share of its
     bound, its ratios to F.rms_norm and to a device copy of x (the same
     bytes, no arithmetic); the two many-rows variants, forced, timed
     against each other at 4096 rows on either side of the plan's
     row-width limit; and the host us per call of the wrapper and of
     F.rms_norm at [4, 1536] bf16 (1000 calls back to back, wall clock,
     one synchronize). Flash: bf16 at hd 64/128 must run the
     tensor-core kernel, everything else the scalar one; at the main
     shapes the instance, its registers and shared memory, the share of
     its bound and its ratio to SDPA are printed;
  4. model  — each model in f32: prefill + 2 decode steps match forward
     logits (hymba's 1100-token prompt wraps its window ring);
  5. serve  — each model in bf16 through ServeEngine: 8 requests, one
     straggler evicted and re-queued; every kernel's launch count, zeroed
     just before the run and read just after, must equal what the path
     implies, and every flash launch must be the tensor-core kernel's;
  6. profile — wall vs device busy time of one prefill and of decode
     steps of each model, with the top kernels (torch.profiler).

The line before the last is a JSON object {"kernels": [...]}; the last line
is {"ok": true, "device": {...}}. Needs one CUDA card of compute capability
>= 9.0 and nvcc; exits 1 without them.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
F32_FLOPS = 67e12                          # f32 outside the tensor cores
BF16_FLOPS = 989e12                        # bf16 tensor cores, dense
TOL = {("rmsnorm", "float32"): 1e-5, ("rmsnorm", "bfloat16"): 2e-2,
       ("flash", "float32"): 1e-4, ("flash", "bfloat16"): 3e-2,
       ("ssm_scan", "float32"): 1e-4, ("ssm_scan", "bfloat16"): 2e-2}
DENSE, HYBRID = "qwen2-1.5b", "hymba-1.5b"
REPLACES = {"rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:36",
            "flash_attention": "src/repro/kernels/flash_attention/kernel.py:99",
            "ssm_scan": "src/repro/kernels/ssm_scan/kernel.py:53"}
# the route and source of each kernel on the main paths (bf16 flash at hd 64
# and 128 runs the tensor-core kernel). The kernels line allows only the
# routes "cuda" and "triton"; the source names which flash kernel it was.
ROUTES = {"rmsnorm": ("cuda", "src/repro_torch/kernels/csrc/rmsnorm.cu"),
          "flash_attention": ("cuda",
                              "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu"),
          "ssm_scan": ("cuda", "src/repro_torch/kernels/csrc/ssm_scan.cu")}
# per model: phase-4 batch, prompt and cache; phase-5 prompt range and cache
PATHS = {
    DENSE: dict(model_B=2, model_S=256, model_smax=512, lo=512, hi=1024, smax=2048,
                profile_S=1024),
    HYBRID: dict(model_B=2, model_S=1100, model_smax=1200, lo=512, hi=2048,
                 smax=4096, profile_S=1024),
}


def log(msg: str) -> None:
    print(msg, flush=True)


# -- timing -------------------------------------------------------------------

class Timer:
    """Median device time of one call, by CUDA events around each launch,
    with the 50 MB L2 flushed (a 128 MB memset) before every launch. A
    device-side sleep after the flush holds the stream until the host has
    queued the call, so host launch overhead stays out of the reading."""

    def __init__(self, torch, reps: int = 25):
        self.torch, self.reps = torch, reps
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            torch.cuda._sleep(1_000_000)       # ~0.5 ms of device cycles
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def rms_bound(rows: int, d: int, esize: int):
    byts = (2 * rows * d + d) * esize          # x read, y written, w read
    ops = 4 * rows * d                         # square, sum, *rsqrt, *w (f32)
    t_b, t_o = byts / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations"), byts, ops


def visible_pairs(Sq: int, Sk: int, window: int = 0, n_sink: int = 0) -> int:
    """(row, col) pairs the causal mask lets through: col <= row (top-left),
    col < Sk and, under a window, col > row - window or col < n_sink."""
    total = 0
    for r in range(Sq):
        hi = min(r, Sk - 1)                     # cols 0..hi are causal
        if hi < 0:
            continue
        if window == 0:
            total += hi + 1
            continue
        lo = max(r - window + 1, 0)             # the band is lo..hi
        total += max(hi - lo + 1, 0) + max(0, min(n_sink, lo, hi + 1))
    return total


def flash_bound(B, Sq, Sk, H, KV, hd, causal, esize, peak, window=0, n_sink=0):
    pairs = B * H * (visible_pairs(Sq, Sk, window, n_sink) if causal else Sq * Sk)
    ops = 4 * hd * pairs                       # QK^T and PV, 2 flops per MAC
    byts = (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd) * esize
    t_b, t_o = byts / HBM_BYTES_PER_S, ops / peak
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations"), byts, ops


def scan_bound(B, S, C, esize):
    byts = 3 * B * S * C * esize               # a, b read, h written
    ops = 2 * B * S * C                        # one FMA per element (f32)
    t_b, t_o = byts / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations"), byts, ops


def compare(name, got, want, tol):
    import torch

    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((g - w).abs().max()) if g.numel() else 0.0
    ok = bool(torch.allclose(g, w, rtol=tol, atol=tol))
    log(f"  {name}: max_abs_err={err:.3e} tol={tol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def host_us(torch, calls: int = 1000, rounds: int = 5) -> dict:
    """Host wall time per call (us) of the rmsnorm wrapper and of F.rms_norm
    at the decode shape [4, 1536] bf16: `calls` calls back to back, no
    flush, one synchronize at the end; the median of `rounds`, taken in
    turns."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm.ops import rmsnorm

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((4, 1536), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((1536,), generator=gen, device="cuda").to(torch.bfloat16)
    fns = {"rmsnorm": lambda: rmsnorm(x, w, 1e-6),
           "F.rms_norm": lambda: F.rms_norm(x, (1536,), w, 1e-6)}
    got = {name: [] for name in fns}
    for fn in fns.values():
        for _ in range(100):
            fn()
    torch.cuda.synchronize()
    for _ in range(rounds):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            got[name].append((time.perf_counter() - t0) / calls * 1e6)
    out = {name: statistics.median(v) for name, v in got.items()}
    log(f"[host] rmsnorm [4,1536] bf16, {calls} calls back to back, median of "
        f"{rounds}: wrapper {out['rmsnorm']:.2f} us/call, F.rms_norm "
        f"{out['F.rms_norm']:.2f} us/call "
        f"({', '.join(f'{n} ' + ' '.join(f'{t:.2f}' for t in v) for n, v in got.items())})")
    return out


def rms_variant_race(torch, timer, randn) -> None:
    """The plan sends rows narrower than STREAM_MIN_BYTES to the two-pass
    rows variant and the others to the stream variant. Time both, forced, at
    4096 rows (a B=4 S=1024 prefill) and row widths on either side of that
    limit in both dtypes, among them the d of every dense config of the
    port, beside a device copy of x; each output is checked first."""
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_variant_cuda
    from repro_torch.kernels.rmsnorm.ref import ROWS, STREAM, STREAM_MIN_BYTES, rmsnorm_ref

    log(f"[kernels] rmsnorm rows vs stream, forced (the plan streams rows of "
        f"{STREAM_MIN_BYTES} B or more)")
    ds = {torch.bfloat16: (1536, 2048, 2304, 3072, 4096, 5120, 8192),
          torch.float32: (576, 1024, 1152, 1536, 2048, 2304)}
    for dt, widths in ds.items():
        dn = str(dt).split(".")[1]
        for d in widths:
            x, w = randn((4096, d), dt), randn((d,), dt)
            y = torch.empty_like(x)
            want = rmsnorm_ref(x, w, 1e-6)
            got = {}
            for v, name in ((ROWS, "rows"), (STREAM, "stream")):
                def fn(v=v):
                    rmsnorm_variant_cuda(x, w, y, 4096, d, 1e-6, v)
                y.zero_()
                fn()
                compare(f"rmsnorm [4096,{d}] {dn} forced {name}", y, want,
                        TOL[("rmsnorm", dn)])
                got[name] = timer(fn)
            copy = timer(lambda: y.copy_(x))
            bound = rms_bound(4096, d, x.element_size())[0]
            log(f"    [4096,{d}] {dn} ({d * x.element_size()} B rows): rows "
                f"{got['rows'] * 1e3:.2f} us, stream {got['stream'] * 1e3:.2f} us, copy of x "
                f"{copy * 1e3:.2f} us, bound {bound * 1e3:.2f} us; stream/rows "
                f"{got['stream'] / got['rows']:.3f}")
            del x, w, y, want


# -- phases -------------------------------------------------------------------

def phase_card():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60, check=True)
    card = r.stdout.strip().splitlines()[0].strip()
    log(f"[card] {card}")
    return card


def phase_build():
    from repro_torch.kernels import _build

    built = not _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load(verbose=True)
    log(f"[build] {_build.library_path().name} "
        f"{'built' if built else 'found built'} in {time.perf_counter() - t0:.1f}s")


def phase_kernels(torch):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import (WGMMA_HEAD_DIMS,
                                                            wgmma_kernel_attrs)
    from repro_torch.kernels.flash_attention.ops import flash_mha
    from repro_torch.kernels.flash_attention.ref import flash_mha_ref
    from repro_torch.kernels.rmsnorm.kernel import kernel_attrs, kernel_plan
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import VARIANTS, rmsnorm_ref
    from repro_torch.kernels.ssm_scan.ops import ssm_scan_batched
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer(torch)
    rows = {}

    def randn(shape, dt):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    log("[kernels] rmsnorm vs plain")
    # qwen2: prefill B=4 S=1024, decode B=4, qk-norm-sized rows;
    # hymba: prefill B=4 S=1024+128 meta, decode B=4
    main_rms = [(4 * 1024, 1536), (4, 1536), (4 * 1024 * 12, 128),
                (4 * 1152, 1600), (4, 1600)]
    # every variant of the plan: narrow rows several to a warp, the widest
    # across warps, d that rules out 16-byte loads, x at an odd element
    # offset (the last element of a case says so)
    edge_rms = [(1, 16), (37, 100), (5, 8192), (3 * 50, 512), (2 * 20 * 4, 16),
                (300, 8192), (1000, 24), (600, 1536), (4, 1536, 1), (4096, 1536, 1)]
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[1]
        for case in main_rms + edge_rms:
            shape, offset = case[:2], (case[2] if len(case) > 2 else 0)
            x = randn((shape[0] * shape[1] + offset,), dt)[offset:].view(shape)
            w = randn(shape[-1:], dt)
            plan = kernel_plan(*shape, dt, offset == 0)
            before = rmsnorm.launches
            got = rmsnorm(x, w, 1e-6)
            if rmsnorm.launches != before + 1:
                raise AssertionError(f"rmsnorm {list(shape)}: no launch counted")
            err = compare(f"rmsnorm {list(shape)}{' offset %d' % offset if offset else ''} "
                          f"{dn} ({VARIANTS[plan.variant]})", got,
                          rmsnorm_ref(x, w, 1e-6), TOL[("rmsnorm", dn)])
            if case not in main_rms:
                continue
            ms = timer(lambda: rmsnorm(x, w, 1e-6))
            plain = timer(lambda: rmsnorm_ref(x, w, 1e-6))
            lib = timer(lambda: F.rms_norm(x, (shape[-1],), w, 1e-6))
            # a device copy of x moves the same bytes with no arithmetic: the
            # floor of this timer for a kernel bound by bytes
            y = torch.empty_like(x)
            copy = timer(lambda: y.copy_(x))
            bound, by, byts, ops = rms_bound(shape[0], shape[1], x.element_size())
            attrs = kernel_attrs(plan, dt)
            log(f"    time {ms * 1e3:.2f} us | bound {bound * 1e3:.2f} us ({by}: "
                f"{byts / 1e6:.2f} MB, {ops / 1e6:.1f} MFLOP) | plain "
                f"{plain * 1e3:.1f} us | F.rms_norm {lib * 1e3:.2f} us | copy of x "
                f"{copy * 1e3:.2f} us (kernel/copy {ms / copy:.2f}x)")
            log(f"    variant {VARIANTS[plan.variant]} (grid {plan.grid} x "
                f"{plan.threads} threads, {plan.tpr} threads per row"
                + (f", {plan.stages} stages of {plan.tile_rows} rows" if plan.stages else "")
                + f") | {attrs['registers']} registers/thread, {attrs['spill_bytes']} B "
                f"spilled, {attrs['smem_bytes'] / 1024:.1f} KiB shared/block | "
                f"kernel/F.rms_norm {ms / lib:.2f}x | {100 * bound / ms:.1f}% of its bound")
            rows[("rmsnorm", shape, dn)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=by, library_ms=lib, copy_ms=copy, variant=VARIANTS[plan.variant],
                **attrs)
    rms_variant_race(torch, timer, randn)
    host = host_us(torch)
    rows[("rmsnorm", (4, 1536), "bfloat16")].update(
        host_us=host["rmsnorm"], library_host_us=host["F.rms_norm"])

    log("[kernels] flash attention vs plain")
    # (B, Sq, Sk, H, KV, hd, causal, window, n_sink)
    main_fa = [(4, 1024, 1024, 12, 2, 128, True, 0, 0),       # qwen2 prefill
               (4, 1152, 1152, 25, 5, 64, True, 1024, 128),   # hymba, S = w + sinks
               (4, 2176, 2176, 25, 5, 64, True, 1024, 128)]   # hymba, 2048 + 128
    edge_fa = [(2, 300, 300, 12, 2, 128, True, 0, 0),     # ragged S
               (2, 300, 300, 12, 2, 128, False, 0, 0),    # non-causal
               (2, 200, 500, 12, 2, 128, True, 0, 0),     # Sq < Sk, top-left mask
               (2, 500, 200, 12, 2, 128, True, 0, 0),     # Sq > Sk
               (1, 256, 256, 8, 1, 64, True, 0, 0),       # MQA
               (2, 384, 384, 9, 3, 64, True, 0, 0),       # hd 64 (smollm heads)
               (2, 130, 130, 4, 2, 32, False, 0, 0),
               (2, 130, 130, 4, 2, 16, True, 0, 0),       # reduced-config hd
               (1, 5, 0, 2, 1, 16, True, 0, 0),           # no key: rows come out 0
               (1, 700, 700, 25, 5, 64, True, 256, 128),  # skipped key tiles
               (2, 300, 300, 4, 2, 64, True, 100, 7),     # ragged window and sinks
               (2, 40, 40, 4, 2, 16, True, 16, 8),        # hymba reduced
               (1, 130, 130, 4, 1, 32, True, 5, 0),       # window < key tile
               # tensor-core kernel in bf16: tails of neither tile, Sq != Sk
               # both ways, non-causal MQA, windows that skip tiles, no key
               (2, 333, 517, 6, 2, 128, True, 0, 0),
               (2, 517, 333, 6, 2, 64, False, 0, 0),
               (1, 77, 300, 5, 1, 64, False, 0, 0),
               (1, 600, 600, 6, 2, 128, True, 200, 64),
               (2, 427, 427, 5, 5, 64, True, 5, 0),
               (1, 900, 900, 5, 1, 64, True, 128, 300),
               (1, 5, 0, 2, 1, 128, True, 0, 0)]
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[1]
        for case in main_fa + edge_fa:
            B, Sq, Sk, H, KV, hd, causal, win, ns = case
            q = randn((B, Sq, H, hd), dt)
            k, v = randn((B, Sk, KV, hd), dt), randn((B, Sk, KV, hd), dt)
            kw = dict(causal=causal, window=win, n_sink=ns)
            name = (f"flash B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} hd={hd} "
                    f"{'causal' if causal else 'full'} window={win} sinks={ns} {dn}")
            before = flash_mha.launches, flash_mha.wgmma_launches
            got = flash_mha(q, k, v, **kw)
            ran = (flash_mha.launches - before[0], flash_mha.wgmma_launches - before[1])
            tc = dt == torch.bfloat16 and hd in WGMMA_HEAD_DIMS
            if ran != ((0, 0) if tc and Sk == 0 else (1, int(tc))):
                raise AssertionError(f"{name}: (launches, wgmma launches) rose by {ran}")
            err = compare(name, got, flash_mha_ref(q, k, v, **kw), TOL[("flash", dn)])
            if case not in main_fa:
                continue
            ms = timer(lambda: flash_mha(q, k, v, **kw))
            plain = timer(lambda: flash_mha_ref(q, k, v, **kw))
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            if win:
                r = torch.arange(Sq, device="cuda")[:, None]
                c = torch.arange(Sk, device="cuda")[None, :]
                mask = (c <= r) & ((c > r - win) | (c < ns))
                lib = timer(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True))
            else:
                lib = timer(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True))
            peak = BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS
            bound, by, byts, ops = flash_bound(B, Sq, Sk, H, KV, hd, causal,
                                               q.element_size(), peak, win, ns)
            log(f"    time {ms:.3f} ms | bound {bound * 1e3:.2f} us ({by}: "
                f"{byts / 1e6:.2f} MB, {ops / 1e9:.2f} GFLOP at {peak / 1e12:g} "
                f"TFLOP/s) | plain {plain:.3f} ms | SDPA{' (bool mask)' if win else ''} "
                f"{lib:.3f} ms")
            inst = {}
            if tc:
                inst = wgmma_kernel_attrs(hd, causal and win > 0)
            log(f"    instance {'wgmma' if tc else 'scalar'}"
                + (f" ({inst['registers']} registers/thread at launch, {inst['spill_bytes']} B "
                   f"spilled, {inst['smem_bytes'] / 1024:.1f} KiB shared/block)"
                   if tc else "")
                + f" | kernel/SDPA {ms / lib:.2f}x | {100 * bound / ms:.1f}% of its "
                f"bound ({ops / ms / 1e9:.1f} TFLOP/s)")
            rows[("flash", case, dn)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=by, library_ms=lib, **inst)
            del qt, kt, vt

    log("[kernels] ssm_scan vs plain")
    main_scan = [(4, 1152, 51200)]                 # hymba: [B, S, di * n]
    edge_scan = [(4, 2176, 51200), (37, 100), (1, 4097), (3, 45, 130),
                 (2, 1, 333), (1, 1, 1)]
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[1]
        for shape in main_scan + edge_scan:
            a = torch.sigmoid(randn(shape, torch.float32)).to(dt)
            b = randn(shape, dt)
            err = compare(f"ssm_scan {list(shape)} {dn}", ssm_scan_batched(a, b),
                          ssm_scan_ref(a, b), TOL[("ssm_scan", dn)])
            if shape not in main_scan:
                continue
            ms = timer(lambda: ssm_scan_batched(a, b))
            plain = timer(lambda: ssm_scan_ref(a, b))
            bound, by, byts, ops = scan_bound(*shape, a.element_size())
            log(f"    time {ms:.3f} ms | bound {bound:.3f} ms ({by}: "
                f"{byts / 1e9:.3f} GB, {ops / 1e9:.2f} GFLOP) | plain {plain:.3f} ms "
                f"| no single library call computes a linear recurrence")
            rows[("ssm_scan", shape, dn)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=by, library_ms=None)
            del a, b
    torch.cuda.empty_cache()
    return rows


def phase_model(torch, arch):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    import numpy as np

    cfg = get_config(arch)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, torch.float32, "cuda")
    B, S, SMAX = (PATHS[arch][k] for k in ("model_B", "model_S", "model_smax"))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S + 2))).cuda()
    tol = 2e-3  # the bound of tests/test_models_smoke.py; paths differ in f32 sum order
    with torch.inference_mode():
        got = []
        lg, cache = model.prefill(params, {"tokens": toks[:, :S]}, SMAX)
        got.append(lg)
        for n in (S, S + 1):
            lg, cache = model.decode_step(params, cache, toks[:, n:n + 1])
            got.append(lg)
        worst = 0.0
        for lg, n in zip(got, (S, S + 1, S + 2)):
            h = model.forward(params, {"tokens": toks[:, :n]})
            want = model._logits(params, h[:, -1])
            if not bool(torch.isfinite(lg).all()) or lg.shape != (B, cfg.padded_vocab):
                raise AssertionError(f"bad logits at n={n}: {tuple(lg.shape)}")
            err = float((lg - want).abs().max())
            worst = max(worst, err)
            if not bool(torch.allclose(lg, want, rtol=tol, atol=tol)):
                raise AssertionError(f"decode != forward at n={n}: {err:.3e}")
    log(f"[model] {cfg.name} f32 L={cfg.n_layers} d={cfg.d_model} B={B}: prefill {S} "
        f"(+{cfg.n_meta_tokens} meta) + 2 decode steps match forward, "
        f"max_abs_err={worst:.3e} (tol {tol:g})")
    del params, cache
    torch.cuda.empty_cache()


def phase_serve(torch, arch):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_mha
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.ssm_scan.ops import ssm_scan_batched
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    cfg = get_config(arch)
    path = PATHS[arch]
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, torch.bfloat16, "cuda")
    eng = ServeEngine(model, params, smax=path["smax"])
    rng = np.random.default_rng(0)
    lengths = rng.integers(path["lo"], path["hi"] + 1, 8)
    straggler = None
    for i, n in enumerate(lengths):
        rid = eng.submit(rng.integers(0, cfg.vocab_size, n), max_new=32,
                         deadline_steps=8 if i == 2 else None)
        straggler = rid if i == 2 else straggler

    calls = {"prefill": [], "decode": []}

    def timed(kind, fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            calls[kind].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    eng.prefill_fn = timed("prefill", eng.prefill_fn)
    eng.decode_fn = timed("decode", eng.decode_fn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rmsnorm.launches = 0
    flash_mha.launches = 0
    flash_mha.wgmma_launches = 0
    ssm_scan_batched.launches = 0
    t0 = time.perf_counter()
    out = eng.run(batch_size=4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rmsnorm": rmsnorm.launches, "flash_attention": flash_mha.launches,
                "ssm_scan": ssm_scan_batched.launches}
    wgmma = flash_mha.wgmma_launches

    n_pf, n_dc = len(calls["prefill"]), len(calls["decode"])
    tokens = sum(len(v) for v in out.values())
    completed = len(eng.completed)
    log(f"[serve] {cfg.name} bf16 prompts {sorted(int(n) for n in lengths)}: "
        f"{completed} completed, {len(eng.evicted)} evicted {eng.evicted}, "
        f"{tokens} tokens in {wall:.2f}s ({tokens / wall:.1f} tok/s)")
    log(f"[serve] prefill {n_pf} calls, median {statistics.median(calls['prefill']):.1f} ms"
        f" per batch ({', '.join('%.1f' % t for t in calls['prefill'])}); decode "
        f"{n_dc} steps, median {statistics.median(calls['decode']):.2f} ms per step")
    log(f"[serve] max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    hybrid = cfg.family == "hybrid"
    # ln1 + ln2 per layer (+ norm_attn, norm_ssm in a hybrid layer), final norm
    per_step = (4 if hybrid else 2) * cfg.n_layers + 1
    want = {"rmsnorm": per_step * (n_pf + n_dc), "flash_attention": cfg.n_layers * n_pf,
            "ssm_scan": cfg.n_layers * n_pf if hybrid else 0}
    log(f"[serve] launches: rmsnorm {launches['rmsnorm']} (want {per_step} x "
        f"{n_pf + n_dc}), flash_attention {launches['flash_attention']} (want "
        f"{cfg.n_layers} x {n_pf}; tensor-core kernel {wgmma}), ssm_scan "
        f"{launches['ssm_scan']} (want {want['ssm_scan']})")
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{name} launches do not match the path")
    if wgmma != want["flash_attention"]:
        raise AssertionError("a bf16 flash launch of the serve path missed the "
                             "tensor-core kernel")
    if completed != 7 or eng.evicted != [straggler]:
        raise AssertionError("expected 7 completed and the straggler evicted")
    if len(out[straggler]) != 16 or tokens != 7 * 32 + 16:
        raise AssertionError(f"unexpected token counts: {tokens}")
    if not all(0 <= t < cfg.vocab_size for v in out.values() for t in v):
        raise AssertionError("token outside the vocabulary")
    return launches, model, params


def _device_ms(torch, fn, steps: int):
    """Device kernel time per step (ms), kernels launched per step and the
    top kernels (and the flash attention kernels, wherever they rank), from
    torch.profiler with CUDA activity only; None if it saw no kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows, launched = [], 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3 / steps, e.key))
            launched += e.count
    if not rows:
        return None, 0, []
    rows.sort(reverse=True)
    shown = rows[:6] + [r for r in rows[6:] if "flash_attention" in r[1]]
    return sum(ms for ms, _ in rows), launched / steps, shown


def phase_profile(torch, model, params):
    """Wall time vs device busy time of one prefill (B=4, S=1024 prompt
    tokens) and of 8 decode steps after it: where the serving time goes."""
    import numpy as np

    cfg = model.cfg
    path = PATHS[cfg.name]
    S = path["profile_S"]
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, S))).cuda()
    state = {}

    def prefill():
        state["lg"], state["cache"] = model.prefill(params, {"tokens": toks},
                                                    path["smax"])

    def decode(steps=8):
        nxt = state["lg"].argmax(-1, keepdim=True)
        for _ in range(steps):
            lg, state["cache"] = model.decode_step(params, state["cache"], nxt)
            nxt = lg.argmax(-1, keepdim=True)

    with torch.inference_mode():
        for name, fn, steps in ((f"{cfg.name} prefill B=4 S={S}", prefill, 1),
                                (f"{cfg.name} decode B=4 x8 steps", decode, 8)):
            fn()                                    # warm (and refill the cache)
            if fn is decode:
                prefill()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / steps
            if fn is decode:
                prefill()
            busy, kernels, top = _device_ms(torch, fn, steps)
            if busy is None:
                log(f"[profile] {name}: wall {wall:.2f} ms/step; device time not "
                    f"measured (the profiler saw no CUDA kernel)")
                continue
            log(f"[profile] {name}: wall {wall:.2f} ms/step, device busy "
                f"{busy:.2f} ms/step ({100 * busy / wall:.1f}% busy, "
                f"{100 - 100 * busy / wall:.1f}% idle), {kernels:.0f} kernels/step")
            for ms, key in top:
                log(f"    {ms:8.3f} ms {100 * ms / busy:5.1f}%  {key[:90]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA card",
              file=sys.stderr)
        return 1
    try:
        import repro_torch.device
    except ImportError as e:
        print(f"chip_smoke: cannot import the port from {HERE}/src: {e}",
              file=sys.stderr)
        return 1
    try:
        repro_torch.device.resolve_device(None)
        log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
            f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
            f"capability {torch.cuda.get_device_capability(0)}")
        card = phase_card()
        phase_build()
        rows = phase_kernels(torch)
        launches = {}
        for arch in (DENSE, HYBRID):
            phase_model(torch, arch)
            launches[arch], model, params = phase_serve(torch, arch)
            phase_profile(torch, model, params)
            del model, params
            torch.cuda.empty_cache()
    except Exception:
        traceback.print_exc()
        return 1

    # one entry per kernel and main path; the row is timed at that path's
    # main shape, and the launches are that path's serve run
    entries = [
        (DENSE, "rmsnorm", ("rmsnorm", (4096, 1536), "bfloat16")),
        (DENSE, "flash_attention",
         ("flash", (4, 1024, 1024, 12, 2, 128, True, 0, 0), "bfloat16")),
        (HYBRID, "rmsnorm", ("rmsnorm", (4608, 1600), "bfloat16")),
        (HYBRID, "flash_attention",
         ("flash", (4, 1152, 1152, 25, 5, 64, True, 1024, 128), "bfloat16")),
        (HYBRID, "ssm_scan", ("ssm_scan", (4, 1152, 51200), "float32")),
    ]
    kernels = [
        dict(name=name, route=ROUTES[name][0], source=ROUTES[name][1],
             replaces=REPLACES[name], launches=launches[arch][name], path=arch,
             shape=list(key[1]), dtype=key[2], **rows[key])
        for arch, name, key in entries]
    log(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
