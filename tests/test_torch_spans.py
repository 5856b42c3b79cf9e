"""The port's program spans (``repro_torch.obs.spans``) on the CPU.

* With no profiler a hymba ``ServeEngine`` round and a HuBERT train step
  enter no ``record_function`` and leave the span buffer empty.
* Under ``torch.profiler`` the exported trace holds the spans as
  ``user_annotation`` events, the buffer nests them (serve, model, layer,
  block part, Mamba chain), and the block parts a train step recomputes
  appear again under ``train.backward``.
* Only the spans whose device time a reader uses take CUDA events.
* A program capture (``graph/capture.py``) gives the same task list with
  the profiler on as off.
* The benchmark's readers of the spans (``portbench/metrics``), on
  hand-made records: launches a decode span, records outside the profiled
  stretch left out, and no reading where there are no records.
"""
import collections
import json
import os
import sys
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import REGISTRY, SHAPES, ShapeSpec
from repro_torch.graph.capture import dumps
from repro_torch.launch import dryrun
from repro_torch.models.model import build_model
from repro_torch.obs import spans
from repro_torch.serve import ServeEngine
from repro_torch.train.data import SyntheticData
from repro_torch.train.loop import init_state, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from portbench.harness.common import Record, load_module  # noqa: E402

HYMBA = REGISTRY["hymba-1.5b"].reduced()
HUBERT = REGISTRY["hubert-xlarge"].reduced()
SERVE_SPANS = {"serve.admit", "serve.prefill", "serve.decode", "serve.sample",
               "model.prefill", "model.decode_step", "model.head", "block.hybrid",
               "hybrid.attn", "hybrid.mamba", "hybrid.ffn",
               "mamba.expand", "mamba.scan", "mamba.readout"}
TRAIN_SPANS = {"train.forward", "train.backward", "train.clip", "train.compress",
               "train.optimizer", "model.forward", "block.attn", "attn.attn", "attn.ffn"}


def _serve_round():
    model = build_model(HYMBA, remat=False)
    params = model.init(torch.Generator().manual_seed(0), torch.float32, "cpu")
    engine = ServeEngine(model, params, smax=64)
    rng = np.random.default_rng(0)
    for n in (20, 30):
        engine.submit(rng.integers(0, HYMBA.vocab_size, n), max_new=3)
    return engine.run(batch_size=2)


def _train_step():
    model = build_model(HUBERT, remat=True)
    state = init_state(model, torch.Generator().manual_seed(0), dtype=torch.float32,
                       compress=True, device="cpu")
    step = make_train_step(model, lr_schedule=lambda _: torch.tensor(1e-3), compress=True)
    batch = SyntheticData(HUBERT, SHAPES["train_4k"], seed=1, batch_override=2,
                          seq_override=16, device="cpu").batch_at(0)
    return step(state, batch)


def _ancestry(recs, r):
    by_id = {x.id: x for x in recs}
    out = []
    while r is not None:
        out.append(r.name)
        r = by_id.get(r.parent)
    return out


@pytest.fixture
def empty_buffer():
    spans.clear()
    yield
    spans.clear()


@pytest.mark.parametrize("program", [_serve_round, _train_step])
def test_no_profiler_enters_no_record_function(program, empty_buffer, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    program()
    assert spans.records() == []


def _profiled(program, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        program()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "user_annotation"}, spans.records()


def test_profiled_serve_round_nests_its_spans(empty_buffer, tmp_path):
    names, recs = _profiled(_serve_round, tmp_path)
    assert SERVE_SPANS <= names
    assert {r.name for r in recs} == SERVE_SPANS
    assert all(r.device_ms is None and r.t_end >= r.t_start for r in recs)   # no CUDA here
    scans = [r for r in recs if r.name == "mamba.scan"]
    assert len(scans) == HYMBA.n_layers                 # one prefill of a batch of 2
    for r in scans:
        assert _ancestry(recs, r) == ["mamba.scan", "hybrid.mamba", "block.hybrid",
                                      "model.prefill", "serve.prefill"]
    # decode's Mamba step takes no child spans
    in_decode = [r for r in recs if r.name == "hybrid.mamba"
                 and "serve.decode" in _ancestry(recs, r)]
    assert len(in_decode) == 2 * HYMBA.n_layers
    assert not any(r.parent in {m.id for m in in_decode} for r in recs)
    # a host-clock interval keeps the records inside it
    prefill = next(r for r in recs if r.name == "serve.prefill")
    inside = spans.records(prefill.t_start, prefill.t_end)
    assert inside[0] is prefill and "serve.decode" not in {r.name for r in inside}


def test_profiled_train_step_spans_its_parts(empty_buffer, tmp_path):
    names, recs = _profiled(_train_step, tmp_path)
    assert TRAIN_SPANS <= names
    assert {r.name for r in recs} == TRAIN_SPANS
    roots = [r.name for r in recs if r.parent is None]
    assert roots == ["train.forward", "train.backward", "train.clip", "train.compress",
                     "train.optimizer"]
    # remat recomputes each layer's block parts inside the backward (on the
    # CPU the autograd engine runs it on the calling thread)
    for part in ("attn.attn", "attn.ffn"):
        again = [r for r in recs if r.name == part and "train.backward" in _ancestry(recs, r)]
        assert len(again) == HUBERT.n_layers


class _FakeEvent:
    """A stand-in for ``torch.cuda.Event``: 1 ms between any two."""

    def __init__(self, enable_timing=False):
        assert enable_timing

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1.0


@pytest.mark.parametrize("program", [_serve_round, _train_step])
def test_only_timed_spans_take_device_events(program, empty_buffer, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _, recs = _profiled(program, tmp_path)
    timed = {r.name for r in recs if r.device_ms is not None}
    assert timed == ({"serve.prefill", "hybrid.mamba"} if program is _serve_round
                     else {"train.clip", "train.optimizer"})
    assert all(r.device_ms == 1.0 for r in recs if r.name in timed)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_capture_is_the_same_with_the_profiler_on_and_off(kind, empty_buffer):
    shape = ShapeSpec(f"spans_{kind}", 32, 2, kind)
    off = dryrun.capture_fake(HYMBA, shape, (1, 1))
    assert spans.records() == []
    with profile(activities=[ProfilerActivity.CPU]):
        on = dryrun.capture_fake(HYMBA, shape, (1, 1))
    assert spans.records()                              # the spans were entered
    assert len(off) > 0 and dumps(on) == dumps(off)


# -- the benchmark's readers ---------------------------------------------------

T0, SETUP, PROFILED_END = 100.0, 5.0, 110.0             # profiled stretch [105, 110]


def _rec(trace=True, **kw):
    return Record(t_start=T0, setup_s=SETUP, unprofiled_t0=PROFILED_END,
                  trace=types.SimpleNamespace(host=kw.pop("host", [])) if trace else None,
                  **kw)


def _buffer(monkeypatch, rows):
    """Span records from (id, name, parent, t_start, device_ms) rows, each
    closed 0.1 s after it starts."""
    monkeypatch.setattr(spans, "_BUFFER", collections.deque(
        spans.SpanRecord(i, name, parent, 1, t, t + 0.1, ms) for i, name, parent, t, ms in rows))


def _reader(name):
    return load_module("metrics", name).read


def test_mamba_ms_reads_the_prefills_of_the_profiled_stretch(monkeypatch):
    _buffer(monkeypatch, [
        (0, "serve.prefill", None, 101.0, 900.0),       # before the stretch: left out
        (1, "hybrid.mamba", 0, 101.0, 500.0),
        (2, "serve.prefill", None, 105.5, 300.0),
        (3, "block.hybrid", 2, 105.5, 200.0),
        (4, "hybrid.mamba", 3, 105.5, 10.0),
        (5, "hybrid.mamba", 3, 105.5, 20.0),
        (6, "serve.decode", None, 106.0, 50.0),
        (7, "hybrid.mamba", 6, 106.0, 5.0),             # decode's: left out
        (8, "serve.prefill", None, 107.0, 300.0),
        (9, "hybrid.mamba", 8, 107.0, 30.0),
        (10, "hybrid.mamba", 8, 107.0, 40.0),
        (11, "serve.prefill", None, 109.95, 300.0),     # ends after the stretch
    ])
    assert _reader("mamba_ms.prefill")(_rec()) == pytest.approx(50.0)


def test_optimizer_ms_reads_clip_and_adamw_a_step(monkeypatch):
    _buffer(monkeypatch, [
        (0, "train.clip", None, 104.0, 99.0),           # before the stretch
        (1, "train.optimizer", None, 104.5, 99.0),
        (2, "train.forward", None, 105.0, 300.0),
        (3, "train.clip", None, 106.0, 2.0),
        (4, "train.optimizer", None, 106.2, 8.0),
        (5, "train.clip", None, 108.0, 3.0),
        (6, "train.optimizer", None, 108.2, 7.0),
    ])
    assert _reader("optimizer_ms.train")(_rec()) == pytest.approx(10.0)


@pytest.mark.parametrize("name", ["mamba_ms.prefill", "optimizer_ms.train"])
def test_span_readers_read_nothing_without_records_or_device(name, monkeypatch):
    _buffer(monkeypatch, [])
    assert _reader(name)(_rec()) is None
    first = "serve.prefill" if name.startswith("mamba") else "train.clip"
    second = "hybrid.mamba" if name.startswith("mamba") else "train.optimizer"
    _buffer(monkeypatch, [(0, first, None, 106.0, None), (1, second, 0, 106.0, None)])
    assert _reader(name)(_rec()) is None                # a CPU run: no device time
    _buffer(monkeypatch, [(0, first, None, 106.0, 1.0), (1, second, 0, 106.0, 1.0)])
    assert _reader(name)(_rec()) == pytest.approx(2.0 if name.startswith("opt") else 1.0)
    assert _reader(name)(_rec(trace=False)) is None     # an untraced run


def _event(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid}


def test_decode_launches_counts_launches_inside_decode_spans():
    host = [_event("user_annotation", "serve.prefill", 0, 100),
            _event("cuda_runtime", "cudaLaunchKernel", 10, 1),       # prefill's
            _event("user_annotation", "serve.decode", 200, 100),
            _event("cuda_runtime", "cudaLaunchKernel", 210, 1),
            _event("cuda_runtime", "cudaLaunchKernelExC", 220, 1),
            _event("cuda_runtime", "cudaEventRecord", 230, 1),        # not a launch
            _event("cuda_runtime", "cudaLaunchKernel", 240, 1, tid=2),  # another thread
            _event("cpu_op", "aten::mm", 250, 5),
            _event("user_annotation", "serve.decode", 400, 100),
            _event("cuda_runtime", "cudaGraphLaunch", 410, 1),
            _event("cuda_runtime", "cudaLaunchKernel", 499, 5)]      # ends after the span
    read = _reader("decode_launches")
    assert read(_rec(host=host)) == pytest.approx(1.5)
    assert read(_rec(host=[e for e in host if e["name"] != "serve.decode"])) is None
    assert read(_rec(host=[e for e in host if e["cat"] != "cuda_runtime"])) is None
    assert read(_rec(trace=False)) is None
