"""A cell is added by new files and new BENCHMARK.json entries alone: in a
copy of the benchmark, a new traffic mix, limits file and per-layer metric
reader and the entries naming them are picked up and run, and no file that
was there changes."""
import hashlib
import json
import shutil
import subprocess
import sys

from portbench.harness.common import BENCH, ROOT

_RUN = """
import json, sys, time
sys.path[:0] = [{src!r}, {root!r}]
from portbench.harness.runner import run_cell
from portbench.tests.reduced import reduced_spec
spec = reduced_spec("hymba-short-serve", bench=json.load(open({bench!r})))
rec = run_cell(spec, 9, 0.1, True, time.perf_counter(), device="cpu")
print(json.dumps({{"correct": rec.correct, "metrics": sorted(rec.metrics)}}))
"""


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_from_new_files_only(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    before = _digests(copy)
    pb = copy / "portbench"
    (pb / "traffic" / "short_serve.json").write_text(json.dumps({
        "loop": "serve", "clients": 8, "engine_batch": 8, "prompt_len": {"median": 128, "sigma": 0.6, "min": 64, "max": 256},
        "max_new": 16, "smax": 512, "warmup_rounds": 1, "profile_rounds": 1,
        "check_rounds": 2}))
    (pb / "limits" / "hymba-short-serve.json").write_text(json.dumps({"logit_gap": 1.0}))
    (pb / "metrics" / "round_s.serve.py").write_text(
        '"""Seconds a round (test metric)."""\n\n\n'
        "def read(rec):\n"
        "    return sum(u['t1'] - u['t0'] for u in rec.units) / len(rec.units)\n")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "hymba-short-serve", "config": "hymba-1.5b",
                               "traffic": "short_serve", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "round_s.serve", "unit": "s", "better": "lower",
                               "source": "host_clock", "layer": "serve engine",
                               "moves": "output_tok_s", "workloads": ["hymba-short-serve"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("ttft_p95_ms", "output_tok_s"):
            m["workloads"].append("hymba-short-serve")
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(copy)
    changed = {k for k in before if before[k] != after[k]}
    assert changed == {"BENCHMARK.json"} and set(before) <= set(after)
    code = _RUN.format(src=str(ROOT / "src"), root=str(copy), bench=str(copy / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(copy))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] and "round_s.serve" in got["metrics"]
