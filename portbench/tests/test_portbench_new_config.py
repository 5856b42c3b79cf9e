"""A configuration is added by new files and new BENCHMARK.json entries
alone: in a copy of the benchmark, a configuration file whose reference and
FLOP count are new modules, its test size, a limits file, a per-layer
metric reader and the entries naming them are picked up and run, and no
file that was there changes."""
import json
import shutil
import subprocess
import sys

from portbench.harness.common import BENCH, ROOT
from portbench.tests.test_portbench_new_cell import _digests

_RUN = """
import json, sys, time
sys.path[:0] = [{src!r}, {root!r}]
from portbench.harness.runner import run_cell
from portbench.tests.reduced import reduced_spec
spec = reduced_spec("hymba-twin-serve", bench=json.load(open({bench!r})))
out = {{"n_layers": spec["cfg"]["n_layers"]}}
for trace in (False, True):
    rec = run_cell(spec, 2**33 + 9, 0.1, trace, time.perf_counter(), device="cpu")
    out[str(trace)] = {{"correct": rec.correct, "metrics": sorted(rec.metrics)}}
out["modules"] = sorted(m for m in sys.modules if m.endswith("hymba_twin"))
print(json.dumps(out))
"""


def test_new_configuration_from_new_files_only(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    before = _digests(copy)
    pb = copy / "portbench"
    cfg = json.loads((pb / "configs" / "hymba-1.5b.json").read_text())
    cfg.update(name="hymba-twin", reference="hymba_twin", flops="hymba_twin")
    (pb / "configs" / "hymba-twin.json").write_text(json.dumps(cfg))
    shutil.copy(pb / "reference" / "hymba.py", pb / "reference" / "hymba_twin.py")
    (pb / "flops" / "hymba_twin.py").write_text((pb / "flops" / "hymba.py").read_text().replace(
        "portbench.reference.hymba ", "portbench.reference.hymba_twin "))
    size = json.loads((pb / "tests" / "sizes" / "configs" / "hymba.json").read_text())
    (pb / "tests" / "sizes" / "configs" / "hymba_twin.json").write_text(
        json.dumps({**size, "n_layers": 3}))
    (pb / "limits" / "hymba-twin-serve.json").write_text(json.dumps({"logit_gap": 0.4}))
    (pb / "metrics" / "prefill_gflop.twin.py").write_text(
        '"""GFLOPs of a round\'s prefills by the configuration\'s count (test metric)."""\n'
        "from portbench.harness.common import load_module\n\n\n"
        "def read(rec):\n"
        "    fl, M = load_module('flops', rec.cfg['flops']), rec.cfg['n_meta_tokens']\n"
        "    return sum(fl.prefill(rec.cfg, n + M) for u in rec.units for n in u['lens'])"
        " / len(rec.units) / 1e9\n")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "hymba-twin", "source": "https://example.org/hymba-twin",
                             "file": "portbench/configs/hymba-twin.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "hymba-twin-serve", "config": "hymba-twin",
                               "traffic": "longdoc_serve", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "prefill_gflop.twin", "unit": "GFLOP", "better": "lower",
                               "source": "program_counter", "layer": "model",
                               "moves": "ttft_p95_ms", "workloads": ["hymba-twin-serve"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("ttft_p95_ms", "output_tok_s"):
            m["workloads"].append("hymba-twin-serve")
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(copy)
    changed = {k for k in before if before[k] != after[k]}
    assert changed == {"BENCHMARK.json"} and set(before) <= set(after)
    code = _RUN.format(src=str(ROOT / "src"), root=str(copy), bench=str(copy / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(copy))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["n_layers"] == 3
    assert got["False"] == {"correct": True,
                            "metrics": ["output_tok_s", "setup_s", "ttft_p95_ms"]}
    assert got["True"] == {"correct": True, "metrics": ["prefill_gflop.twin"]}
    assert got["modules"] == ["portbench.flops.hymba_twin", "portbench.reference.hymba_twin"]
