"""The frozen campaign slices of ``tests/golden/``, built with the port's
``SweepSpec``, and the canonical frozen form of their records.

Torch only (no JAX), so ``chip_smoke.py`` reads it on the machine with the
card. ``tests/test_torch_campaign.py`` holds ``specs()`` equal to
``tests/test_golden.py::_specs()`` and ``freeze`` to its ``_freeze``.
"""
from __future__ import annotations

import json
import os
from typing import Dict

from repro_torch.sweep.spec import RefineSpec, SweepSpec

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

_PARETO_1 = dict(mode="pareto", max_points=1, pti_ns=50_000.0)


def specs() -> Dict[str, SweepSpec]:
    """The seven frozen slices, as ``tests/test_golden.py::_specs``."""
    return {
        "lm_decode_kv_slice": SweepSpec(
            name="lm_decode_kv_slice",
            lm_grid={"arch": "qwen3-32b", "phase": ["prefill", "decode"],
                     "seq": [64], "kv_len": [64], "batch": [2],
                     "tp": [1, 2]},
            preset="v5e", axes={"clock_ghz": [0.6, 0.94]}, n_tiles=[2],
            refine=RefineSpec(**_PARETO_1)),
        "moe_ep_grid_slice": SweepSpec(
            name="moe_ep_grid_slice",
            lm_grid={"arch": "qwen3-moe-30b-a3b", "seq": [64],
                     "batch": [1], "tp": [1], "ep": [1, 4]},
            preset="v5e", axes={"hbm_gbps": [409.0, 819.0]}, n_tiles=[2],
            refine=RefineSpec(**_PARETO_1)),
        "lm_full_pod_slice": SweepSpec(
            name="lm_full_pod_slice",
            lm_grid={"arch": "qwen3-32b", "phase": ["prefill", "decode"],
                     "seq": [64], "kv_len": [64], "batch": [4], "tp": [2],
                     "dp": [2], "layers": [2], "pod": [2]},
            preset="v5e", axes={"clock_ghz": [0.6, 0.94]}, n_tiles=[2],
            refine=RefineSpec(**_PARETO_1)),
        "serve_fleet_slice": SweepSpec(
            name="serve_fleet_slice",
            serve_grid={"arch": "qwen3-32b", "layers": 2, "prompt": 64,
                        "max_new": 8, "kv_capacity": 128, "tp": [2],
                        "dp": [1, 2], "pod": 0, "slots": 4,
                        "policy": ["static", "continuous"],
                        "traffic": ["poisson", "bursty"],
                        "rate_rps": [50.0], "n_requests": 60, "seed": 7,
                        "slo": {"ttft_ms": 500.0, "tpot_ms": 50.0}},
            preset="v5e", n_tiles=[2],
            refine=RefineSpec(mode="all")),
        "lm_batch_slice": SweepSpec(
            name="lm_batch_slice",
            lm_grid={"arch": "qwen3-32b", "seq": [64], "batch": [2],
                     "tp": [2], "layers": [8, 16], "pod": [2]},
            preset="v5e", axes={"dcn_gbps": [50.0, 100.0]}, n_tiles=[2],
            refine=RefineSpec(mode="all", pti_ns=50_000.0, engine="fast",
                              batch=8)),
        "hlo_crosscheck_slice": SweepSpec(
            name="hlo_crosscheck_slice",
            workloads=["hlo/qwen2_1_5b_prefill",
                       "lm/qwen2-1.5b/L28/s128b1tp1",
                       "hlo/qwen2_1_5b_prefill@L4",
                       "lm/qwen2-1.5b/L4/s128b1tp1"],
            preset="v5e", axes={"clock_ghz": [0.6, 0.94]}, n_tiles=[2],
            refine=RefineSpec(engine="fast", **_PARETO_1)),
        "lm_fast_engine_slice": SweepSpec(
            name="lm_fast_engine_slice",
            lm_grid={"arch": "qwen3-32b", "phase": ["prefill", "decode"],
                     "seq": [64], "kv_len": [64], "batch": [4], "tp": [2],
                     "dp": [2], "layers": [16], "pod": [2]},
            preset="v5e", axes={"clock_ghz": [0.6, 0.94]}, n_tiles=[2],
            refine=RefineSpec(engine="fast", **_PARETO_1)),
    }


def freeze(records):
    """Canonical golden form: ``analytic_*`` and ``deviation`` (the f32
    prescreen and what divides by it) to 6 significant digits, every other
    float to 10."""
    def rnd(o, coarse=False):
        if isinstance(o, float):
            return float(f"{o:.6g}" if coarse else f"{o:.10g}")
        if isinstance(o, dict):
            return {k: rnd(v, coarse or k.startswith("analytic")
                           or k == "deviation")
                    for k, v in sorted(o.items())}
        if isinstance(o, list):
            return [rnd(v, coarse) for v in o]
        return o

    return rnd(json.loads(json.dumps(records, default=float)))


def golden(name: str):
    """The frozen records of one slice."""
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
        return json.load(f)
