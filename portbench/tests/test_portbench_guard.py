"""What the benchmark may load: after a run no module whose top-level name
is jax, jaxlib, flax or repro is loaded, a run that loads one prints no
result, and the references import nothing of the program."""
import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness.common import BENCH, ROOT

_RUN = """
import json, sys, time
sys.path[:0] = [{src!r}, {root!r}]
from portbench.harness.runner import run_cell, blocked_modules
from portbench.tests.reduced import reduced_spec
for cell in [w["name"] for w in json.load(open({bench!r}))["workloads"]]:
    rec = run_cell(reduced_spec(cell), 3, 0.1, False, time.perf_counter(), device="cpu")
    assert rec.correct, rec.checks
print(",".join(blocked_modules()) or "none")
"""


def test_a_run_loads_no_jax_and_no_reference_package():
    code = _RUN.format(src=str(ROOT / "src"), root=str(ROOT), bench=str(ROOT / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code],
                         capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "none"


_MAIN = """
import json, sys, time
sys.path[:0] = [{stub!r}, {src!r}, {root!r}]
import torch
from portbench.harness import runner
from portbench.tests.reduced import reduced_spec
bench = json.load(open({bench!r}))
torch.cuda.is_available = lambda: True          # the run itself stays on the CPU
torch.cuda.device_count = lambda: 1
runner.resolve = lambda name: reduced_spec(name, bench=bench)
run_cell = runner.run_cell
runner.run_cell = lambda *a, **k: run_cell(*a, **{{**k, "device": "cpu"}})
sys.exit(runner.main(["--workload", "hubert-encode-30s", "--seed", "5", "--seconds", "0.1",
                      "--trace", "0"], time.perf_counter()))
"""


@pytest.mark.parametrize("reader_loads_jax", [False, True])
def test_main_prints_no_result_once_a_reader_has_loaded_jax(tmp_path, reader_loads_jax):
    """A metric reader, read after the window, imports a module named jax:
    main names it on standard error and prints nothing on standard output."""
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "stub" / "jax").mkdir(parents=True)
    (tmp_path / "stub" / "jax" / "__init__.py").write_text("")
    body = "    import jax  # noqa: F401\n" if reader_loads_jax else ""
    (copy / "portbench" / "metrics" / "probe_s.py").write_text(
        f'"""A reader for this test."""\n\n\ndef read(rec):\n{body}    return 1.0\n')
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "probe_s", "unit": "s", "better": "lower",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["hubert-encode-30s"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    code = _MAIN.format(stub=str(tmp_path / "stub"), src=str(ROOT / "src"), root=str(copy),
                        bench=str(copy / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(copy))
    if reader_loads_jax:
        assert out.returncode != 0 and out.stdout == "", out.stdout[-2000:]
        assert "jax" in out.stderr.splitlines()[-1], out.stderr[-2000:]
    else:
        assert out.returncode == 0, out.stderr[-3000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] and line["metrics"]["probe_s"]["value"] == 1.0


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_references_import_nothing_of_the_program_or_jax():
    files = sorted((BENCH / "reference").glob("*.py"))
    assert files
    for f in files:
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}, (f, tops)


def test_nothing_in_the_benchmark_imports_jax_or_the_jax_package():
    for f in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & {"repro", "jax", "jaxlib", "flax"}, (f, tops)
