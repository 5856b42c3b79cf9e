"""BENCHMARK.json against the benchmark's rules, and every name in it
found on disk: configurations, traffic mixes, limits, metric readers."""
import re

import pytest

from portbench.harness.common import BENCH, ROOT, load_json, load_module

B = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = B["end_to_end"] + B["per_layer"]


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "portbench/run.py"] and B["paths"] == ["portbench"]
    assert 1 <= B["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_and_units_use_the_allowed_characters():
    names = ([c["name"] for c in B["configs"]] + [w["name"] for w in B["workloads"]]
             + [m["name"] for m in METRICS] + [w["traffic"] for w in B["workloads"]]
             + [k for c in B["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    for n in ([c["name"] for c in B["configs"]], [w["name"] for w in B["workloads"]],
              [m["name"] for m in METRICS]):
        assert len(n) == len(set(n))
    for text in ([w["why"] for w in B["workloads"]] + [c["why"] for c in B["configs"]]
                 + [m["layer"] for m in B["per_layer"]] + [c["source"] for c in B["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entry_keys():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in B["end_to_end"])


def _reported(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    e2e = [m["name"] for m in B["end_to_end"] if _reported(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(_reported(m, cell) for m in B["per_layer"])


def test_every_per_layer_metric_moves_a_metric_each_of_its_cells_reports():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    for m in B["per_layer"]:
        for cell in m["workloads"]:
            assert _reported(e2e[m["moves"]], cell), (m["name"], cell)


def test_every_name_is_found_on_disk():
    for c in B["configs"]:
        f = ROOT / c["file"]
        assert f.is_file() and f.parts[len(ROOT.parts)] == "portbench"
        cfg = load_json(f)
        load_module("reference", cfg["reference"])
        load_module("flops", cfg["flops"])
    for w in B["workloads"]:
        t = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
        load_module("loops", t["loop"])
        assert load_json(BENCH / "limits" / f"{w['name']}.json")
    for m in METRICS:
        assert callable(load_module("metrics", m["name"]).read)
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
