"""The port's examples (``examples/torch_*.py``) at their smoke sizes on the
CPU (``--device cpu``), each a new interpreter in which ``jax``, ``jaxlib``
and ``repro`` cannot be imported (a ``sitecustomize`` guard on its path):
each exits 0, the train example resumes from its newest checkpoint with its
data cursor, and ``torch_npu_analysis.py`` prints what
``examples/npu_analysis.py`` prints, byte for byte.
"""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

_GUARD = r"""
import importlib.abc, sys

BLOCKED = ("jax", "jaxlib", "repro")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked import: {name}")
        return None

sys.meta_path.insert(0, Block())
"""


@pytest.fixture
def guarded(tmp_path):
    """Run an example under the import guard, from ``tmp_path``."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_GUARD)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(site), SRC]),
               OMP_NUM_THREADS="2")

    def run(script, *args):
        r = subprocess.run([sys.executable, os.path.join(ROOT, "examples", script), *args],
                           capture_output=True, text=True, env=env, cwd=tmp_path, timeout=240)
        assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
        assert "blocked import" not in r.stderr
        return r.stdout
    return run


def test_quickstart(guarded):
    out = guarded("torch_quickstart.py", "--device", "cpu", "--steps", "3")
    assert "train step 2: loss" in out and "greedy decode: [" in out
    assert "one list-schedule launch on cpu" in out
    assert out.rstrip().endswith("quickstart OK")


def test_serve_lm_evicts_the_straggler(guarded):
    out = guarded("torch_serve_lm.py", "--device", "cpu")
    assert "6 completed, 1 evicted after retries" in out
    assert "evicted (deadline)" in out


def test_train_lm_resumes(guarded, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    args = ("--seq", "16", "--batch", "2", "--reduced", "--device", "cpu", "--ckpt-dir", ckpt)
    first = guarded("torch_train_lm.py", "--steps", "2", *args)
    assert "steps 0->2" in first and "loss: first-1-avg" in first
    again = guarded("torch_train_lm.py", "--steps", "3", *args)
    assert "[resume] restored step 2, data cursor 2" in again
    assert "steps 2->3" in again


def test_npu_analysis_prints_the_reference_example_byte_for_byte(guarded):
    got = guarded("torch_npu_analysis.py")
    env = dict(os.environ, PYTHONPATH=SRC)
    want = subprocess.run([sys.executable, os.path.join(ROOT, "examples", "npu_analysis.py")],
                          capture_output=True, text=True, env=env, timeout=240)
    assert want.returncode == 0, want.stderr[-3000:]
    assert got == want.stdout
    with open(os.path.join(ROOT, "examples", "npu_analysis.py")) as f:
        ref = f.read()
    with open(os.path.join(ROOT, "examples", "torch_npu_analysis.py")) as f:
        assert f.read() == ref.replace("repro.", "repro_torch.")
