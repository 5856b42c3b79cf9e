"""Every cell at a reduced size through the port's kernels on the card
(float32): correct, the traced run saw the device busy, and it reads each
``idle_pct*`` metric that BENCHMARK.json lists for the cell. Marked ``gpu``;
skips where no CUDA card is present."""
import time

import pytest

from portbench.harness.common import ROOT, load_json
from portbench.harness.runner import run_cell
from portbench.tests.reduced import reduced_spec

CELLS = [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_reduced_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = reduced_spec(cell)
    rec = run_cell(spec, 7, 1.0, True, time.perf_counter(), device="cuda")
    assert rec.correct, rec.checks
    assert rec.trace is not None and rec.trace.busy_s > 0
    idle = {m["name"] for m in spec["per_layer"] if m["name"].startswith("idle_pct")}
    assert idle <= set(rec.metrics), rec.metrics
