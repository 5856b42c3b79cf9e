#!/usr/bin/env python3
"""Time the flash attention kernels of one source tree at the main paths'
shapes, with no row offset, on one NVIDIA card.

  python3 flash_race.py [--src DIR/src] [--label NAME]
  python3 flash_race.py --compare RUNS.jsonl

It imports ``repro_torch`` from ``--src`` (default: this checkout's
``src``), so two trees (a parent commit unpacked under ``build/`` and this
one) can be timed on one card in turns, one process each, in the order
parent, change, change, parent. Only the public entry point is called
(``flash_mha``), which every tree of the port has:

  * the serve instance: ``flash_mha`` without grad;
  * the instance that stores L: ``flash_mha`` on inputs that require grad;
  * the backward kernels: ``torch.autograd.grad`` through that call's graph,
    built once.

Shapes: qwen2-1.5b (4, 1024, 12 over 2 heads, hd 128, causal), hymba-1.5b
(4, 1152, 25 over 5, hd 64, window 1024, 128 sinks), hubert-xlarge (4, 1500,
16 over 16, hd 80, non-causal), each in bf16 (the tensor-core kernels) and
f32 (the CUDA-core ones). Each time is the median of CUDA-event timings with
the L2 flushed before every launch (``chip_smoke.Timer``'s method). The
last line of standard output is one JSON object: the label, the card's name
and power limit (nvidia-smi), ``ms`` by "<kind> <shape> <dtype>", and
``bits``: a SHA-256 of each call's results (the serve output; the autograd
output and dQ, dK, dV), the same inputs in every tree (seed 0).

``--compare`` reads such lines (one a run, labels "parent" and "change")
and prints, for each kind and shape, the change's mean time over the
parent's, and whether every run gave the same bits. Exits 1 without a CUDA
card (when timing).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# (label, (B, S, H, KV, hd), causal, window, n_sink)
SHAPES = [("qwen2", (4, 1024, 12, 2, 128), True, 0, 0),
          ("hymba", (4, 1152, 25, 5, 64), True, 1024, 128),
          ("hubert", (4, 1500, 16, 16, 80), False, 0, 0)]
REPS = 50


def timer(torch, fn, flush) -> float:
    """Median ms of ``fn`` over REPS launches, L2 flushed before each, a
    device-side sleep holding the stream until the host has queued it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def digest(torch, tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def compare(path: str) -> int:
    """The change's mean time over the parent's, and whether the bits agree."""
    with open(path) as f:
        runs = [json.loads(line) for line in f if line.strip()]
    by = {lab: [r for r in runs if r["label"] == lab] for lab in ("parent", "change")}
    print(runs[0]["card"])
    same = True
    for key in runs[0]["ms"]:
        mean = {lab: statistics.mean(r["ms"][key] for r in rs) for lab, rs in by.items()}
        print(f"{key:40s} parent {mean['parent']:.4f} change {mean['change']:.4f} ms, "
              f"ratio {mean['change'] / mean['parent']:.4f}")
    for key in runs[0]["bits"]:
        agree = len({r["bits"][key] for r in runs}) == 1
        same &= agree
        print(f"{key:40s} bits {'equal' if agree else 'DIFFER'} in all {len(runs)} runs")
    return 0 if same else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--src", default=os.path.join(HERE, "src"))
    p.add_argument("--label", default="")
    p.add_argument("--compare", default=None, help="a file of this script's JSON lines")
    args = p.parse_args(argv)
    if args.compare:
        return compare(args.compare)
    import torch
    if not torch.cuda.is_available():
        print("flash_race: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels.flash_attention.ops import flash_mha

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ms, bits = {}, {}
    for label, (B, S, H, KV, hd), causal, window, n_sink in SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            q, do = (torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dt)
                     for _ in range(2))
            k, v = (torch.randn(B, S, KV, hd, generator=gen, device="cuda").to(dt)
                    for _ in range(2))
            mask = dict(causal=causal, window=window, n_sink=n_sink)
            key = f"{label} {str(dt).split('.')[-1]}"
            with torch.no_grad():
                ms[f"serve {key}"] = timer(torch, lambda: flash_mha(q, k, v, **mask), flush)
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            ms[f"forward_autograd {key}"] = timer(torch, lambda: flash_mha(*leaves, **mask),
                                                  flush)
            out = flash_mha(*leaves, **mask)
            ms[f"backward {key}"] = timer(
                torch, lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), flush)
            with torch.no_grad():
                bits[f"serve {key}"] = digest(torch, [flash_mha(q, k, v, **mask)])
            bits[f"autograd {key}"] = digest(
                torch, [out] + list(torch.autograd.grad(out, leaves, do)))
            print(f"{args.label} {key}: " + ", ".join(
                f"{kind} {ms[f'{kind} {key}']:.4f}" for kind in
                ("serve", "forward_autograd", "backward")) + " ms", flush=True)
            del q, k, v, do, leaves, out
    print(json.dumps({"label": args.label, "card": card(), "ms": ms, "bits": bits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
