"""The frozen campaign slices through the port's ``run_campaign``.

Each slice of ``tests/golden/`` runs through the port's inline runner with
the prescreen on the CPU (the list schedule's plain version). Its records
must equal the JAX package's inline run of the same spec byte for byte
(as JSON), and their frozen form the fixture under ``tests/golden/``.
"""
import json

import pytest

from _torch_golden import freeze, golden, specs
from repro.sweep.runner import run_campaign as j_run_campaign
from repro.sweep.spec import SweepSpec as JSpec
from repro_torch.sweep.runner import run_campaign
from test_golden import _freeze, _specs


def test_helper_specs_are_the_golden_specs():
    mine, ref = specs(), _specs()
    assert sorted(mine) == sorted(ref)
    for name in ref:
        assert mine[name].to_dict() == ref[name].to_dict(), name


@pytest.mark.parametrize("name", sorted(_specs()))
def test_golden_slice_through_the_port(name):
    res = run_campaign(specs()[name], backend="inline", use_cache=False, device="cpu")
    ref = j_run_campaign(JSpec.from_dict(specs()[name].to_dict()), backend="inline",
                         use_cache=False)
    assert json.dumps(res.records, sort_keys=True) == json.dumps(ref.records, sort_keys=True)
    assert freeze(res.records) == _freeze(res.records)
    assert freeze(res.records) == golden(name)
    assert res.summary["prescreen_calls"] == ref.summary["prescreen_calls"]
    assert res.summary["backend"] == "inline"


@pytest.mark.parametrize("backend", ["pool", "spool"])
def test_get_backend_builds_the_ports_pool_and_spool(backend):
    """The pool and spool backends are ported now: ``get_backend`` builds
    them from the port's own modules (their records are held to inline's
    in ``tests/test_torch_exec.py``)."""
    from repro_torch.exec.backend import get_backend

    bk = get_backend(backend, workers=1, spool_dir="unused")
    assert bk.name == backend
    assert type(bk).__module__ == f"repro_torch.exec.{backend}"


def test_journal_and_cache_through_the_port(tmp_path):
    """The journal (``obs.progress``'s summary) and the result cache work in
    the port: a rerun serves every refined point from the cache, with the
    same records."""
    spec = specs()["lm_decode_kv_slice"]
    kw = dict(backend="inline", cache_dir=str(tmp_path / "cache"), device="cpu")
    first = run_campaign(spec, journal_path=str(tmp_path / "j.jsonl"), **kw)
    assert first.summary["cache_hits"] == 0 and first.summary["refined"] > 0
    assert first.summary["progress"]["campaign"] == spec.name
    again = run_campaign(spec, **kw)
    assert again.summary["cache_hits"] == first.summary["refined"]
    strip = [{k: v for k, v in r.items() if k != "cached"} for r in again.records]
    assert strip == [{k: v for k, v in r.items() if k != "cached"} for r in first.records]
