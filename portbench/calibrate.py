"""Readings that the correctness limits are set from, at a cell's own size.

  python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
      [--faults fp8,half_batch,...] [--fault-seeds 3] [--out readings.jsonl]

For every seed, in one process: a run of the cell with no timed window
(``run_cell`` at 0 seconds: the timed path runs for as many units as a run
compares), then the numbers compared are printed as one JSON line
("program"). On the first ``--fault-seeds`` seeds each planted fault of
``--faults`` runs the same way; ``fp8`` is the control (the reference with
float8 products in the program's place). Not a benchmark run: the
benchmark's own runs never call it.
"""
import time

T_START = time.perf_counter()

import argparse                 # noqa: E402
import json                     # noqa: E402
import sys                      # noqa: E402
from pathlib import Path        # noqa: E402

_ROOT = Path(__file__).resolve().parents[1]
for _p in (str(_ROOT / "src"), str(_ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench.harness.runner import resolve, run_cell  # noqa: E402


def readings(spec, seed, *, device="cuda", fault=None):
    """The compared numbers of one run of ``spec`` with no timed window."""
    t0 = time.perf_counter()
    rec = run_cell(spec, seed, 0.0, False, t0, device=device, fault=fault)
    return {"seed": seed, "kind": fault or "program", "correct": rec.correct,
            "readings": {k: v for k, (v, _) in rec.checks.items()},
            "seconds": time.perf_counter() - t0, "checked": rec.checked,
            "memory_peak_bytes": rec.memory_peak_bytes}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    spec = resolve(a.workload)
    seeds = [int(s) for s in a.seeds.split(",")]
    faults = [f for f in a.faults.split(",") if f]
    sink = open(a.out, "a") if a.out else None
    for i, seed in enumerate(seeds):
        for fault in [None] + (faults if i < a.fault_seeds else []):
            line = json.dumps({"cell": a.workload, **readings(spec, seed, fault=fault)})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
