"""The control of every cell: the plain reference computed with float8
products in the program's place (the planted fault ``fp8``) makes a run
not correct under the cell's limits on one of three seeds or more, where
sound runs of the same seeds are correct (the size here is reduced; the readings at the cells' own
size are in PERF.md)."""
import pytest

from portbench.calibrate import readings
from portbench.harness.common import ROOT, load_json
from portbench.tests.reduced import reduced_spec

CELLS = [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_float8_control_fails_a_limit(cell):
    spec = reduced_spec(cell)
    assert all(readings(spec, seed, device="cpu")["correct"] for seed in (1, 2, 3))
    # at this size the control's widest gap varies from seed to seed; at the
    # cells' own size it fails on every seed read (PERF.md)
    assert not all(readings(spec, seed, device="cpu", fault="fp8")["correct"]
                   for seed in (1, 2, 3))
