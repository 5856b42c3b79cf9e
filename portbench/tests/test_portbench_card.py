"""Every cell at a reduced size through the port's kernels on the card
(float32): correct, and the traced run reads its device metrics. Marked
``gpu``; skips where no CUDA card is present."""
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
    rec = run_cell(reduced_spec(cell), 7, 1.0, True, time.perf_counter(), device="cuda")
    assert rec.correct, rec.checks
    assert rec.trace is not None and rec.trace.busy_s > 0
    assert any(k.startswith("idle_pct") for k in rec.metrics), rec.metrics
