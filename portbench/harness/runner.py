"""One run of one cell: find its configuration, traffic mix and limits by the
names in ``BENCHMARK.json``, hand them to the mix's loop, read the cell's
metrics with their readers, and print the result as the last line.

Everything a cell needs is found by name: ``configs/`` (as listed in
``BENCHMARK.json``), ``traffic/<mix>.json`` (its ``loop`` names
``loops/<loop>.py``), ``limits/<cell>.json``, ``metrics/<metric>.py``,
and the configuration's ``reference``, ``flops`` modules. A new cell is new
files and new entries; this file does not change.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional

from .common import BENCH, ROOT, Record, host_between, load_json, load_module

__all__ = ["resolve", "run_cell", "result_line", "main", "BLOCKED"]

BLOCKED = ("jax", "jaxlib", "flax", "repro")   # top-level module names, compared whole


def resolve(name: str, bench: Optional[dict] = None) -> Dict:
    """The cell ``name``: its entry, configuration, traffic mix, limits and
    the metrics that apply to it (end to end, per layer)."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(cf for cf in bench["configs"] if cf["name"] == cell["config"])

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return {"cell": cell, "cfg": load_json(ROOT / conf["file"]),
            "traffic": load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(BENCH / "limits" / f"{name}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


def blocked_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(BLOCKED))


def run_cell(spec: Dict, seed: int, seconds: float, trace: bool, t_start: float, *,
             device: str = "cuda", fault: Optional[str] = None, marks=()) -> Record:
    """Drive the cell once; the record holds what was measured, ``checks``
    ({name: (value, limit)}), ``metrics`` and ``correct``."""
    rec = Record(cell=spec["cell"], cfg=spec["cfg"], traffic=spec["traffic"], seed=int(seed),
                 seconds=float(seconds), trace=bool(trace), device=device, t_start=t_start,
                 marks=list(marks))
    loop = load_module("loops", spec["traffic"]["loop"])
    rec.checks = loop.run(rec, spec["limits"], fault=fault)
    rec.metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        v = load_module("metrics", m["name"]).read(rec)
        if v is not None:
            rec.metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    rec.correct = bool(rec.checks) and all(v <= lim for v, lim in rec.checks.values())
    return rec


def result_line(rec: Record) -> str:
    import torch

    on_card = rec.device == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(rec.memory_peak_bytes)}
    out = {"correct": rec.correct, "attempted": rec.attempted, "failed": rec.failed,
           "metrics": rec.metrics, "device": dev}
    if rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.wall_s
        out["breakdown"] = {"device_ops": rec.trace.top_ops(), "idle_gaps": rec.trace.idle_gaps()}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in rec.checks.items()}
    return json.dumps(out)


def _card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def _thirds(rec) -> str:
    """Units finished a second in each third of the window (drift within a run)."""
    if not rec.get("units"):
        return "none"
    t0 = rec.t_start + rec.setup_s
    edges = [t0 + rec.window_s * i / 3 for i in range(4)]
    n = [sum(1 for u in rec.units if edges[i] <= u["t1"] < edges[i + 1] + (i == 2) * 1e-3)
         for i in range(3)]
    return ", ".join(f"{k / (rec.window_s / 3):.4f}" for k in n)


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = resolve(args.workload)

    import torch

    need = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: the cell needs {need} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    # every build and kernel cache at a fixed path inside the checkout
    os.environ.setdefault("REPRO_TORCH_BUILD_DIR", str(ROOT / "build" / "repro_torch"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    libs = Path(os.environ["REPRO_TORCH_BUILD_DIR"])
    before = set(libs.glob("librepro_torch_*.so"))
    rec = run_cell(spec, args.seed, args.seconds, bool(args.trace), t_start,
                   marks=[("import torch", time.perf_counter())])
    line = result_line(rec)
    t, phases = t_start, []
    for name, tm in rec.get("marks", []):
        if name == "window":
            break
        phases.append(f"{name} {tm - t:.3f} s")
        t = tm
    built = "built in this run" if set(libs.glob("librepro_torch_*.so")) - before else "found"
    print(f"portbench: set-up phases: {', '.join(phases)}; kernel library {built}",
          file=sys.stderr)
    print(f"portbench: host in the window: {host_between(rec, 'warm-up', 'window')}; "
          f"units a second by thirds of the window: {_thirds(rec)}", file=sys.stderr)
    print(f"portbench: {spec['cell']['name']} seed {args.seed}: setup {rec.setup_s:.3f} s, "
          f"window {rec.window_s:.3f} s, {len(rec.units)} units, {rec.checked} outputs "
          f"checked; card {_card_line()}", file=sys.stderr)
    # once every module of the run has loaded: the readers, the result line
    blocked = blocked_modules()
    if blocked:
        print(f"portbench: modules that must not load were loaded: {', '.join(blocked)}",
              file=sys.stderr)
        return 4
    for k, (v, lim) in rec.checks.items():
        print(f"check {k}: {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0
