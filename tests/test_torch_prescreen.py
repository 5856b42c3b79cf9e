"""The port's ``sweep.prescreen.prescreen_cell`` against the JAX package's.

Every cell of the frozen campaign slices (``tests/golden/``) and the first
six cells of the builtin ``lm_full_pod`` campaign go through both, each
package with one part memo shared across its cells, as ``run_campaign``
does. The port runs on the CPU (the list schedule's plain version). Every
``CellPrescreen`` field but the wall time must be equal: arrays bit for
bit, since the Pareto pick and the frozen records read them.
"""
import dataclasses

import numpy as np
import pytest

from _torch_golden import specs as torch_specs
from repro.sweep.prescreen import prescreen_cell as j_prescreen
from repro.sweep.spec import RefineSpec as JRefine, SweepSpec as JSpec
from repro.sweep.spec import load_builtin_spec as j_builtin
from repro_torch.sweep.prescreen import CellPrescreen, prescreen_cell
from repro_torch.sweep.spec import RefineSpec, SweepSpec, load_builtin_spec

FULL_POD = "lm_full_pod[:6]"
GROUPS = sorted(n for n in torch_specs() if n != "serve_fleet_slice") + [FULL_POD]
ARRAYS = ("time_ns", "avg_w", "energy_j", "util")


def _cells(group):
    if group == FULL_POD:
        return j_builtin("lm_full_pod").cells()[:6], load_builtin_spec("lm_full_pod").cells()[:6]
    tspec = torch_specs()[group]
    return JSpec.from_dict(tspec.to_dict()).cells(), tspec.cells()


def _assert_same(got, want):
    assert got.cell.label == want.cell.label
    assert [p.point_id() for p in got.cell.points] == \
        [p.point_id() for p in want.cell.points]
    for f in dataclasses.fields(CellPrescreen):
        if f.name in ("cell", "wall_s"):
            continue
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name in ARRAYS:
            assert g.dtype == w.dtype and g.shape == w.shape, (got.cell.label, f.name)
            np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                          err_msg=f"{got.cell.label} {f.name}")
        else:
            assert type(g) is type(w) and g == w, (got.cell.label, f.name, g, w)


@pytest.mark.parametrize("group", GROUPS)
def test_prescreen_cell_equals_reference(group):
    jcells, tcells = _cells(group)
    assert len(jcells) == len(tcells) > 0
    jmemo, tmemo = {}, {}
    for jc, tc in zip(jcells, tcells):
        _assert_same(prescreen_cell(tc, memo=tmemo, device="cpu"),
                     j_prescreen(jc, memo=jmemo))
    assert len(tmemo) == len(jmemo)


def test_memo_shares_parts_across_layers():
    """Cells that differ only in the layers axis share one body and one
    head screen, and the makespan is linear in the layer count
    (``tests/test_sweep.py::test_model_prescreen_memo_shares_parts_across_layers``)."""
    kw = dict(name="memo_t", lm_grid={"arch": "qwen3-32b", "seq": [64], "batch": [4],
                                      "tp": [1], "layers": [1, 2, 4]},
              preset="v5e", axes={"clock_ghz": [0.6, 0.94]}, n_tiles=[2])
    spec = SweepSpec(refine=RefineSpec(mode="none"), **kw)
    memo = {}
    screens = {c.workload: prescreen_cell(c, memo=memo, device="cpu")
               for c in spec.cells()}
    assert len(memo) == 2            # one body + one head, 3 cells
    t = {int(w.split("/L")[1].split("/")[0]): s.time_ns for w, s in screens.items()}
    np.testing.assert_allclose(t[4] - t[2], 2 * (t[2] - t[1]), rtol=1e-5)
    jspec = JSpec(refine=JRefine(mode="none"), **kw)
    jmemo = {}
    for jc, tc in zip(jspec.cells(), spec.cells()):
        _assert_same(screens[tc.workload], j_prescreen(jc, memo=jmemo))
