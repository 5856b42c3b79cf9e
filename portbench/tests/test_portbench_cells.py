"""Every cell end to end on the CPU at a reduced size: the loop, the
runner's metric readers and the result line; a sound run is correct, and
each fault the cell can have makes it not correct."""
import json
import time

import pytest

from portbench.harness.common import ROOT, load_json
from portbench.harness.runner import result_line, run_cell
from portbench.tests.reduced import faults, reduced_spec

CELLS = [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]]


def _run(cell, trace=False, fault=None, seed=2**31 + 77):
    return run_cell(reduced_spec(cell), seed, 0.2, trace, time.perf_counter(), device="cpu",
                    fault=fault)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_reports_its_metrics(cell):
    rec = _run(cell)
    assert rec.correct, rec.checks
    spec = reduced_spec(cell)
    assert set(rec.metrics) == {m["name"] for m in spec["end_to_end"]}
    assert all(m["value"] > 0 for m in rec.metrics.values())
    line = json.loads(result_line(rec))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_host_metrics_and_leaves_device_ones_out(cell):
    rec = _run(cell, trace=True)
    assert rec.correct, rec.checks
    names = {m["name"] for m in reduced_spec(cell)["per_layer"]}
    assert set(rec.metrics) <= names
    # no card: nothing read from a device trace, and no share reported as 0
    assert not any(k.startswith("idle_pct") or "roofline" in k for k in rec.metrics)
    assert any(u["profiled"] for u in rec.units)


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in
                                        faults(reduced_spec(c)["traffic"]["loop"])])
def test_fault_in_the_timed_path_makes_the_run_not_correct(cell, fault):
    rec = _run(cell, fault=fault)
    assert not rec.correct, rec.checks


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_gives_the_same_readings(cell):
    a, b = _run(cell, seed=5), _run(cell, seed=5)
    assert a.checks == b.checks
