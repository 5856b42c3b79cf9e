"""The port's ``core.vectorized`` against the JAX package's, on the CPU.

The graphs are the parts of every cell of the seven frozen campaign slices
(``tests/golden/``) and the largest captured graph of any builtin campaign,
``hlo/qwen2_1_5b_prefill_tp2`` at 2 tiles (N 6,122 tasks, 6 engine units),
each compiled by both packages' own compilers. The port runs the list
schedule's plain version (``device="cpu"``); every array must equal the
reference's bit for bit, since the frozen campaign records are built from
them.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_common import hw_param_matrix, random_task_arrays
from _torch_golden import specs as torch_specs
from repro.core import vectorized as jv
from repro.graph.compiler import CompileOptions as JOpts, compile_ops as j_compile
from repro.graph.workloads import model_parts as j_parts, resolve_workload as j_resolve
from repro.sweep.spec import RefineSpec as JRefine, SweepSpec as JSpec
from repro_torch.core import vectorized as tv
from repro_torch.graph.compiler import CompileOptions as TOpts, compile_ops as t_compile
from repro_torch.graph.workloads import model_parts as t_parts, resolve_workload as t_resolve
from repro_torch.kernels.list_schedule.ops import list_schedule
from repro_torch.sweep.spec import SweepSpec as TSpec

HLO_TP2 = "hlo_tp2"
# the serving slice has no prescreen cells: its points bypass the list schedule
GROUPS = sorted(n for n in torch_specs() if n != "serve_fleet_slice") + [HLO_TP2]


def _specs(group):
    if group == HLO_TP2:
        kw = dict(name=HLO_TP2, workloads=["hlo/qwen2_1_5b_prefill_tp2"],
                  preset="v5e", axes={"clock_ghz": [0.6, 0.94]}, n_tiles=[2])
        return JSpec(refine=JRefine(mode="none"), **kw), None
    tspec = torch_specs()[group]
    return JSpec.from_dict(tspec.to_dict()), tspec


def _part_builders(parts, resolve, workload):
    if parts is None:
        return [("whole", resolve(workload))]
    return [("body", parts.body), ("head", parts.head)]


_GRAPHS = {}


def _graphs(group):
    """[(label, jax TaskArrays, port TaskArrays, param matrix)] of every
    part of every cell of one group, each compiled by its own package."""
    if group in _GRAPHS:
        return _GRAPHS[group]
    jspec, tspec = _specs(group)
    tspec = tspec or TSpec.from_dict(jspec.to_dict())
    out = []
    for jc, tc in zip(jspec.cells(), tspec.cells()):
        assert jc.label == tc.label
        pm = np.stack([jv.params_of(p.cfg(jspec)) for p in jc.points])
        np.testing.assert_array_equal(
            pm, np.stack([tv.params_of(p.cfg(tspec)) for p in tc.points]))
        jb = _part_builders(j_parts(jc.workload), j_resolve, jc.workload)
        tb = _part_builders(t_parts(tc.workload), t_resolve, tc.workload)
        for (kind, jbuild), (_, tbuild) in zip(jb, tb):
            jw = j_compile(jbuild(), jc.base_cfg(), JOpts(n_tiles=jc.n_tiles,
                                                          **jspec.compile_opts))
            tw = t_compile(tbuild(), tc.base_cfg(), TOpts(n_tiles=tc.n_tiles,
                                                          **tspec.compile_opts))
            out.append((f"{jc.label}/{kind}", jv.from_tasks(jw.tasks),
                        tv.from_tasks(tw.tasks), pm))
    _GRAPHS[group] = out
    return out


def _bits_equal(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == np.float32 and want.dtype == np.float32, what
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32),
                                  err_msg=what)


@pytest.mark.parametrize("group", GROUPS)
def test_from_tasks_equals_reference(group):
    graphs = _graphs(group)
    assert graphs, group
    for label, ja, ta, _ in graphs:
        for f in dataclasses.fields(jv.TaskArrays):
            want, got = getattr(ja, f.name), getattr(ta, f.name)
            if f.name == "n_units":
                assert got == want, label
                continue
            assert got.dtype == want.dtype, (label, f.name)
            np.testing.assert_array_equal(got, want, err_msg=f"{label} {f.name}")
    if group == HLO_TP2:
        (_, _, ta, _), = graphs
        assert len(ta.engine_class) == 6122 and ta.n_units == 6


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("repeats", [1, 6])
def test_schedule_many_stats_bitwise(group, repeats):
    for label, ja, ta, pm in _graphs(group):
        jmk, jbusy = jv.schedule_many_stats(ja, pm, repeats=repeats)
        tmk, tbusy = tv.schedule_many_stats(ta, pm, repeats=repeats, device="cpu")
        _bits_equal(tmk, jmk, f"{label} makespan")
        _bits_equal(tbusy, jbusy, f"{label} busy")


@pytest.mark.parametrize("group", GROUPS)
def test_schedule_many_and_schedule_bitwise(group):
    # the first part of each group: every call below is one more XLA compile
    for label, ja, ta, pm in _graphs(group)[:1]:
        _bits_equal(tv.schedule_many(ta, pm, device="cpu"),
                    jv.schedule_many(ja, pm), f"{label} schedule_many")
        _bits_equal(tv.schedule(ta, pm[-1], device="cpu"),
                    jv.schedule(ja, pm[-1]), f"{label} schedule")
        mk, busy = tv.schedule_stats(ta, pm[0], repeats=3, device="cpu")
        jmk, jbusy = jv.schedule_stats(ja, pm[0], repeats=3)
        _bits_equal(mk, jmk, f"{label} schedule_stats")
        _bits_equal(busy, jbusy, f"{label} schedule_stats busy")


def test_repeats_fast_path_matches_composition():
    """``repeats`` is the closed form: r copies = r x one copy
    (``tests/test_invariants.py::test_repeats_fast_path_matches_composition``)."""
    (_, _, ta, pm), _ = _graphs("lm_full_pod_slice")[:2]
    mk1, busy1 = tv.schedule_many_stats(ta, pm, device="cpu")
    mk6, busy6 = tv.schedule_many_stats(ta, pm, repeats=6, device="cpu")
    np.testing.assert_allclose(mk6, 6 * mk1, rtol=1e-9)
    np.testing.assert_allclose(busy6, 6 * busy1, rtol=1e-9)


def _jax_arrays(ta):
    return jv.TaskArrays(**{f.name: getattr(ta, f.name) for f in dataclasses.fields(ta)})


@pytest.mark.parametrize("n,n_units,classes,cross,dep_hi", [
    (1, 1, (0, 1, 2, 3), 0.3, None),   # one task
    (7, 2, (0, 1, 2, 3), 0.3, None),
    (300, 5, (0, 1, 2, 3), 0.3, None),
    (50, 3, (3,), 0.5, None),          # collectives, half of them cross-pod
    (64, 3, (0, 1, 2, 3), 0.3, 70),    # dependencies at i or past N read 0.0
])
def test_random_graphs_bitwise(n, n_units, classes, cross, dep_hi):
    ta = random_task_arrays(n, n, n_units, classes=classes, cross=cross, dep_hi=dep_hi)
    pm = hw_param_matrix()
    for r in (1, 4):
        jmk, jbusy = jv.schedule_many_stats(_jax_arrays(ta), pm, repeats=r)
        tmk, tbusy = tv.schedule_many_stats(ta, pm, repeats=r, device="cpu")
        _bits_equal(tmk, jmk, "makespan")
        _bits_equal(tbusy, jbusy, "busy")


def test_wrapper_rejects_bad_inputs():
    feats = torch.zeros((3, 8))
    ints = torch.zeros((3, 12), dtype=torch.int32)
    params = torch.ones((2, 13))
    with pytest.raises(ValueError):
        list_schedule(feats[:0], ints[:0], params, 1)
    with pytest.raises(ValueError):
        list_schedule(feats, ints, params[:0], 1)
    with pytest.raises(ValueError):
        list_schedule(feats[:, :7], ints, params, 1)
    with pytest.raises(TypeError):
        list_schedule(feats.double(), ints, params, 1)
    a = random_task_arrays(0, 5, 2)
    a.engine_unit[3] = 2
    with pytest.raises(ValueError, match="unit"):
        tv.schedule_many(a, np.ones((1, 13)), device="cpu")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = random_task_arrays(0, 5, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tv.schedule_many_stats(a, np.ones((1, 13)))
