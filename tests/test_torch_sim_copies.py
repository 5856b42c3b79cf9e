"""The port's copies of the JAX package's simulator modules and data.

The port imports nothing of ``repro``, so the numpy simulator that the
campaign path runs (event engine, hardware models, compiler, Power-EM,
fleet simulator, sweep and exec plumbing) lives in ``repro_torch`` as
copies at the same relative paths. Each copy must equal its source byte
for byte once ``repro_torch`` is read as ``repro``: the package name is
the only edit, besides the ones ``DOC_EDITS`` lists (the reference's
change-history tags in one docstring, left out of the copy). Mostly it
sits in docstrings; in ``exec/spool.py`` (the spawned worker: ``import
repro_torch``, ``python -m repro_torch.exec``) and in the ``prog`` of the
``exec`` and ``obs`` CLIs it is code, so the port runs its own worker.
``tests/test_torch_exec.py`` scans every module for a leftover import or
spawn of ``repro``, which this comparison cannot see.
The ported modules are not copies:
``core/vectorized.py``, ``sweep/prescreen.py``, ``sweep/runner.py``,
``configs/__init__.py`` and ``serve/__init__.py``.
"""
import os
import re

import pytest

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

COPIES = [f"{m}.py" for m in (
    "core/__init__", "core/engine", "core/resources", "core/trace", "core/fastsim",
    "core/batchsim",
    "hw/presets", "hw/memory", "hw/mxu", "hw/vecunit", "hw/dma", "hw/ici", "hw/pod",
    "hw/chip",
    "graph/tasks", "graph/workloads", "graph/compiler", "graph/hlo_parser", "graph/ingest",
    "power/__init__", "power/characterization", "power/dvfs", "power/powerem",
    "obs/__init__", "obs/metrics", "obs/progress", "obs/perfetto", "obs/__main__",
    "serve/traffic", "serve/fleet",
    "sweep/__init__", "sweep/spec", "sweep/cache", "sweep/pareto", "sweep/refine",
    "exec/__init__", "exec/backend", "exec/journal", "exec/pool", "exec/spool",
    "exec/worker", "exec/janitor", "exec/faults", "exec/__main__",
    "configs/hubert_xlarge", "configs/hymba_1_5b", "configs/llama32_vision_90b",
    "configs/minicpm_2b", "configs/phi35_moe_42b_a6_6b", "configs/qwen2_1_5b",
    "configs/qwen3_32b", "configs/qwen3_moe_30b_a3b", "configs/smollm_135m",
    "configs/xlstm_125m")]
DATA = sorted(os.path.join(d, f) for d in ("configs/sweeps", "configs/hlo")
              for f in os.listdir(os.path.join(SRC, "repro", d))
              if not f.startswith("."))
# per copied module: (pattern in the reference, replacement, count), in
# docstrings only
DOC_EDITS = {"sweep/refine.py": [(rb"Since ISSUE \d+ a ", b"A ", 3)]}
PORTED = ["core/vectorized.py", "sweep/prescreen.py", "sweep/runner.py",
          "configs/__init__.py", "serve/__init__.py"]


def _read(pkg, rel):
    with open(os.path.join(SRC, pkg, rel), "rb") as f:
        return f.read()


@pytest.mark.parametrize("rel", COPIES)
def test_module_is_a_copy_of_the_reference(rel):
    mine = _read("repro_torch", rel).replace(b"repro_torch", b"repro")
    want = _read("repro", rel)
    for pattern, repl, count in DOC_EDITS.get(rel, ()):
        want, n = re.subn(pattern, repl, want)
        assert n == count
    assert mine == want, f"src/repro_torch/{rel} drifted from src/repro/{rel}"


@pytest.mark.parametrize("rel", DATA)
def test_data_file_is_a_copy_of_the_reference(rel):
    assert _read("repro_torch", rel) == _read("repro", rel)


@pytest.mark.parametrize("rel", PORTED)
def test_ported_module_is_not_the_reference(rel):
    mine = _read("repro_torch", rel).replace(b"repro_torch", b"repro")
    assert mine != _read("repro", rel)
    assert b"import jax" not in _read("repro_torch", rel)
