"""The port's campaign CLI (``python -m repro_torch.sweep``) and Stack-EM
(``repro_torch.graph.stackem``), torch only, on the CPU.

Counterparts of ``tests/test_sweep.py::test_cache_cli_stats_and_prune`` and
``::test_cli_run_subprocess`` (here on a frozen golden slice, whose records
must be byte-identical to those of the JAX package's ``python -m
repro.sweep run`` on the same spec, and equal to ``tests/golden/``), of the
first three tests of ``tests/test_stackem_multidev.py``, and of
``tests/test_replay_report.py::test_stackem_clone_isolates_barriers``; and
one ``crosscheck-hlo --device cpu``. The prescreen runs on the card unless
``--device cpu`` asks for the plain version.
"""
import json
import os
import subprocess
import sys

import _torch_golden
from repro_torch.core import Tracer
from repro_torch.graph.compiler import CompileOptions, compile_ops
from repro_torch.graph.stackem import StackContext, _clone_tasks, run_stack
from repro_torch.graph.tasks import Task
from repro_torch.graph.workloads import mobilenet_v2, tiny_yolo_v2
from repro_torch.hw.mxu import GemmSpec
from repro_torch.hw.presets import V5E, paper_skew
from repro_torch.power.powerem import PowerEM
from repro_torch.sweep.__main__ import main as sweep_main
from repro_torch.sweep.cache import ResultCache, content_key

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
SLICE = "lm_decode_kv_slice"


def _env():
    return dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))


def test_cache_cli_stats_and_prune(tmp_path, capsys):
    root = str(tmp_path / "cache")
    c = ResultCache(root)
    c.put(content_key({"a": 1}), {"x": 1})
    assert sweep_main(["cache", root, "--prune"]) == 0
    out = capsys.readouterr().out
    assert "entries,1" in out and "schema_current,1" in out
    assert "pruned,0" in out                     # nothing stale yet


def test_cli_run_golden_slice_equals_the_jax_cli(tmp_path):
    """``run <spec> --workers 0 --device cpu`` in a subprocess: the campaign
    record's records byte-identical to the JAX package's CLI on the same
    spec, and frozen equal to the fixture; then ``list``."""
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(_torch_golden.specs()[SLICE].to_dict()))
    outs = {}
    for pkg, extra in (("repro_torch", ["--device", "cpu"]), ("repro", [])):
        out = tmp_path / f"{pkg}.json"
        r = subprocess.run(
            [sys.executable, "-m", f"{pkg}.sweep", "run", str(spec_path), "--workers", "0",
             "--cache-dir", str(tmp_path / f"cache_{pkg}"), "--out", str(out), *extra],
            capture_output=True, text=True, timeout=300, env=_env(), cwd=str(tmp_path))
        assert r.returncode == 0, r.stderr
        assert "prescreen" in r.stdout and "grid_points,8" in r.stdout
        outs[pkg] = json.loads(out.read_text())
    mine, ref = outs["repro_torch"]["records"], outs["repro"]["records"]
    assert json.dumps(mine, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert _torch_golden.freeze(mine) == _torch_golden.golden(SLICE)
    r2 = subprocess.run([sys.executable, "-m", "repro_torch.sweep", "list"],
                        capture_output=True, text=True, timeout=60, env=_env())
    assert r2.returncode == 0 and "dvfs_bw" in r2.stdout


def test_cli_crosscheck_hlo_on_the_cpu(tmp_path, capsys):
    """The builtin hlo_crosscheck campaign: every captured-HLO fixture in the
    band its manifest documents."""
    rc = sweep_main(["crosscheck-hlo", "--device", "cpu", "--no-cache",
                     "--out", str(tmp_path / "x.json")])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "in_band,true" in out and out.count("fixture,") >= 3


def _ctx(name, workload, period_ns, priority, cfg, n=3):
    cw = compile_ops(workload(), cfg, CompileOptions(n_tiles=1))
    return StackContext(name=name, tasks=cw.tasks, period_ns=period_ns,
                        n_requests=n, priority=priority)


def test_stackem_two_contexts_complete():
    cfg = paper_skew()
    rep = run_stack([
        _ctx("cam", mobilenet_v2, period_ns=1e6, priority=0, cfg=cfg),
        _ctx("det", tiny_yolo_v2, period_ns=2e6, priority=1, cfg=cfg),
    ], cfg)
    assert len(rep.latencies_ns["cam"]) == 3
    assert len(rep.latencies_ns["det"]) == 3
    assert all(lat > 0 for lat in rep.latencies_ns["cam"])


def test_stackem_contention_raises_latency():
    """A co-running heavy context inflates the light context's latency."""
    cfg = paper_skew()
    solo = run_stack([_ctx("cam", mobilenet_v2, 1e6, 0, cfg)], cfg)
    shared = run_stack([
        _ctx("cam", mobilenet_v2, 1e6, 1, cfg),
        _ctx("det", tiny_yolo_v2, 5e5, 0, cfg),   # higher priority hog
    ], cfg)
    assert shared.avg_latency_ms("cam") > solo.avg_latency_ms("cam")


def test_power_gating_saves_idle_energy():
    tr = Tracer()
    cfg = V5E
    rate = cfg.macs * cfg.clock_ghz                # busy 1 PTI, then idle 8 PTIs
    tr.emit("tile0.mxu", "ops", 0, 1000, rate * 1000)
    pem = PowerEM(cfg)
    plain = pem.analyze(tr, pti_ns=1000, t_end_ns=9000)
    gated = pem.analyze(tr, pti_ns=1000, t_end_ns=9000, power_gating=True)
    assert gated.energy_j() < plain.energy_j()
    assert gated.series["tile0.mxu"][0] == plain.series["tile0.mxu"][0]


def test_stackem_clone_isolates_barriers():
    t = Task("tile0.mxu", GemmSpec(m=8, n=8, k=8), waits=((5, 1),), signals=(6,), name="x")
    c1 = _clone_tasks([t], "a")[0]
    c2 = _clone_tasks([t], "b")[0]
    assert c1.waits[0][0] != 5 and c2.waits[0][0] != 5
    assert c1.waits[0][0] != c2.waits[0][0]
    assert c1.signals[0] != c2.signals[0]
