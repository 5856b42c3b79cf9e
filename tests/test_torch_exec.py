"""The port's campaign execution backends: inline, pool and spool.

* No module of ``repro_torch`` imports or spawns ``repro``: the byte-copy
  test reads ``repro_torch`` as ``repro`` before it compares, so it would
  also pass a copy of ``exec/spool.py`` that still spawns the reference's
  worker. A source scan closes that gap.
* Inline, pool (2 forked workers) and spool (one spawned worker) give
  byte-identical records on golden slices, equal to the frozen fixtures
  (the port's counterpart of ``tests/test_golden.py``'s backend identity).
* The spawned spool worker runs ``repro_torch`` with ``repro``, ``jax`` and
  ``jaxlib`` blocked from import.
* Two of ``tests/test_faults.py``'s spool cases against the port's spool.

The pre-screen runs on the CPU (``device="cpu"``); refinement is numpy.
"""
import json
import os
import re
import textwrap
import threading
import time

import pytest

from _torch_golden import freeze, golden, specs
from repro_torch.exec import CampaignJournal, Spool, SpoolBackend, run_worker
from repro_torch.exec.backend import get_backend, is_failure_record
from repro_torch.exec.faults import FaultPlan, plan_scope
from repro_torch.sweep.runner import run_campaign

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

# an import of repro, a module path "repro.<...>" in a string (a spawn's
# "-m" target, import_module), or "-m repro" on a command line
_NAMES_REPRO = re.compile(
    r"^\s*(?:import|from)\s+repro\b|[\"']repro[\"'.]|-m\s+repro\b", re.MULTILINE)


def _repro_mentions(path):
    with open(path) as f:
        text = f.read()
    return [m.group(0).strip() for m in _NAMES_REPRO.finditer(text)]


def _port_modules():
    root = os.path.join(SRC, "repro_torch")
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(root)
                  for f in fs if f.endswith(".py"))


def test_no_port_module_imports_or_spawns_repro():
    hits = {os.path.relpath(p, SRC): m for p in _port_modules()
            if (m := _repro_mentions(p))}
    assert not hits, hits
    # the scan sees what a naive copy would keep: the reference's spool
    # imports repro and spawns "python -m repro.exec worker"
    ref = _repro_mentions(os.path.join(SRC, "repro", "exec", "spool.py"))
    assert "import repro" in ref and '"repro.' in ref


SLICES = ["lm_decode_kv_slice", "serve_fleet_slice", "lm_batch_slice"]


def _blob(res):
    return json.dumps(res.records, sort_keys=True)


@pytest.mark.parametrize("name", SLICES)
def test_inline_pool_spool_records_are_identical(name, tmp_path):
    spec = specs()[name]
    inline = run_campaign(spec, backend="inline", use_cache=False, device="cpu")
    pool = run_campaign(spec, workers=2, use_cache=False, device="cpu")
    assert pool.summary["backend"] == "pool"
    spool = run_campaign(spec, backend=SpoolBackend(str(tmp_path / "spool"), workers=1,
                                                    poll_s=0.05, timeout_s=120),
                         use_cache=False, device="cpu")
    assert spool.summary["backend"] == "spool"
    assert _blob(inline) == _blob(pool) == _blob(spool)
    assert freeze(inline.records) == golden(name)


_GUARD = textwrap.dedent("""
    import importlib.abc, os, sys

    BLOCKED = ("jax", "jaxlib", "repro")
    LOG = os.environ["TORCH_EXEC_GUARD_LOG"]

    def _mark(kind, text=""):
        with open(os.path.join(LOG, f"{kind}-{os.getpid()}"), "a") as f:
            f.write(text)

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                _mark("blocked", name + "\\n")
                raise ImportError(f"blocked import: {name}")
            if name == "repro_torch.sweep.refine":
                _mark("refine")
            return None

    sys.meta_path.insert(0, Block())
    _mark("guard")
""")


def test_spawned_spool_worker_runs_the_port_with_repro_and_jax_blocked(
        tmp_path, monkeypatch):
    """The spool's worker is a new interpreter: ``sitecustomize`` on its
    PYTHONPATH puts the guard in front of every import before the worker
    starts. A worker of the reference could not import at all, and the
    run would stall; the port's refines every point."""
    site, log = tmp_path / "site", tmp_path / "log"
    site.mkdir()
    log.mkdir()
    (site / "sitecustomize.py").write_text(_GUARD)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(site)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    monkeypatch.setenv("TORCH_EXEC_GUARD_LOG", str(log))
    name = "lm_decode_kv_slice"
    root = str(tmp_path / "spool")
    res = run_campaign(specs()[name], backend=SpoolBackend(root, workers=1, poll_s=0.05,
                                                           timeout_s=120, stall_s=20),
                       use_cache=False, device="cpu")
    assert freeze(res.records) == golden(name)
    marks = os.listdir(log)
    assert not [m for m in marks if m.startswith("blocked-")], \
        {m: (log / m).read_text() for m in marks}
    guarded = {m.split("-", 1)[1] for m in marks if m.startswith("guard-")}
    refined = {m.split("-", 1)[1] for m in marks if m.startswith("refine-")}
    assert refined and refined <= guarded
    spool = Spool(root)
    workers = {spool.result(k)["worker"] for k in spool.done_keys()}
    assert workers and all(w.rsplit("-", 1)[1] in refined for w in workers)


# -- the port's spool under faults (tests/test_faults.py) -------------------

def _backdate_active(spool, age_s=1e4):
    d = os.path.join(spool.root, "active")
    old = time.time() - age_s
    for f in os.listdir(d):
        try:
            os.utime(os.path.join(d, f), (old, old))
        except FileNotFoundError:
            pass


def test_spool_reclaim_backoff(tmp_path):
    spool = Spool(str(tmp_path / "sp"), lease_s=60.0, backoff_base_s=5.0)
    spool.submit("k", {"i": 1})
    spool.claim("dead")
    _backdate_active(spool)
    assert spool.reclaim() == 1
    with open(os.path.join(spool.root, "jobs", "k.json")) as f:
        entry = json.load(f)
    assert entry["attempts"] == 1
    assert entry["not_before"] > time.time() + 3.0
    assert spool.claim("w1") is None                 # backed off
    assert spool.counts()["jobs"] == 1               # still queued
    eta = spool.next_retry_eta()
    assert eta is not None and 3.0 < eta <= 6.5
    st_ = spool.status()
    assert st_["backed_off"] == 1 and st_["quarantined"] == 0
    assert st_["next_retry_eta_s"] == pytest.approx(eta, abs=1.0)
    # a clock-skew fault moves past the backoff window
    with plan_scope(FaultPlan(0, {("skew", "clock"): 100.0})):
        job = spool.claim("w1")
        assert job is not None and job.attempts == 1
        spool.complete(job, {"ok": 1}, wall_s=0.0)
    assert spool.result("k")["record"] == {"ok": 1}


def test_spool_backend_allow_partial_degrades_failures(tmp_path):
    root = str(tmp_path / "sp")

    def fn(p):
        if p["i"] == 1:
            raise ValueError("bad cell")
        return {"out": p["i"]}

    stop = threading.Event()

    def loop():
        while not stop.is_set():
            if run_worker(root, worker="tw", hb_s=0.2, refine_fn=fn) == 0:
                time.sleep(0.02)

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    jpath = str(tmp_path / "j.jsonl")
    j = CampaignJournal(jpath)
    try:
        bk = get_backend("spool", workers=0, spool_dir=root, poll_s=0.05)
        recs = bk.refine([{"i": 0}, {"i": 1}, {"i": 2}], keys=["a", "b", "c"],
                         journal=j, allow_partial=True)
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    j.end({"refined": 3})
    assert [r.get("out") for r in recs] == [0, None, 2]
    assert is_failure_record(recs[1]) and "bad cell" in recs[1]["error"]
    view = CampaignJournal.load(jpath)
    assert view.counts() == {"done": 2, "failed": 1, "cached": 0, "other": 0, "total": 3}
    # exactly one journal event per point: no duplicates from polling
    assert len([e for e in view.events if e.get("ev") == "point"]) == 3
    assert not view.all_done()
    assert view.all_done(allow_failed=True)
