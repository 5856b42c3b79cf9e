"""Captured torch programs -> the hand-built ``Op`` contract.

The counterpart of ``graph/ingest.py``'s HLO fixtures for the port's own
programs. ``tools/gen_torch_fixtures.py`` runs
``launch.programs.build_program(arch, shape, mesh)`` once under the
recorder of ``graph/capture.py`` and writes its task list as gzipped JSON
(``<fixture>.tasks.json.gz``) under ``src/repro_torch/configs/torch_graphs/``
with a ``manifest.json`` in the HLO manifest's fields (file, sha256 of the
decompressed JSON, arch, shape, mesh, layers, phase, twin, band). This
module reads a fixture back into ``TaskSpec``s and lowers it with
``ingest.lower_tasks``, unchanged: the ``layers[i].`` tasks become the
``L<i>.`` blocks.

Workload names (``graph.workloads.resolve_workload``):

    torch/<fixture>           the captured program, all layers
    torch/<fixture>@L<k>      its first k layer blocks (the reduced twin)

No torch on the import path: refinement workers resolve workload names in
spawned processes.
"""
from __future__ import annotations

import gzip
import json
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import ingest
from .hlo_parser import Collective, TaskSpec
from .ingest import IngestReport, lower_tasks
from .workloads import Op

__all__ = ["FIXTURE_DIR", "CAPTURES", "parse_torch_name", "tasks_from_rows", "load_tasks",
           "ingest_torch_fixture", "resolve_torch"]

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "configs", "torch_graphs")

# the programs the generator captures: the JAX package's HLO captures
# (tools/gen_hlo_fixtures.py), one for one: (fixture, arch, seq/kv, batch,
# kind, mesh, hand-built twin); each fixture's HLO counterpart has its name
CAPTURES = [
    ("qwen2_1_5b_prefill", "qwen2-1.5b", 128, 1, "prefill", (1, 1),
     "lm/qwen2-1.5b/L28/s128b1tp1"),
    ("qwen2_1_5b_decode", "qwen2-1.5b", 256, 4, "decode", (1, 1),
     "lm/qwen2-1.5b/L28/decode/kv256b4tp1"),
    ("qwen2_1_5b_prefill_tp2", "qwen2-1.5b", 128, 1, "prefill", (1, 2),
     "lm/qwen2-1.5b/L28/s128b1tp2"),
]

_NAME_RE = re.compile(r"^torch/(?P<fixture>[A-Za-z0-9_.\-]+)(?:@L(?P<layers>\d+))?$")

_ops_cache: Dict[Tuple[str, Optional[int]], Tuple[List[Op], IngestReport]] = {}


def tasks_from_rows(rows: Sequence[dict]) -> List[TaskSpec]:
    """``TaskSpec``s from a fixture's JSON rows."""
    out = []
    for r in rows:
        c = r.get("collective")
        coll = None if c is None else Collective(
            op=c["op"], payload_bytes=int(c["payload_bytes"]), group_size=int(c["group_size"]),
            n_groups=int(c["n_groups"]), count=1.0, crosses_pod=False, name=c["op"])
        out.append(TaskSpec(r["name"], r["engine"], flops=float(r["flops"]),
                            elems=float(r["elems"]), bytes_in=float(r["bytes_in"]),
                            bytes_out=float(r["bytes_out"]), collective=coll,
                            deps=tuple(r["deps"]),
                            gemm=tuple(r["gemm"]) if "gemm" in r else None))
    return out


def load_tasks(fixture: str, fixture_dir: str = FIXTURE_DIR) -> List[TaskSpec]:
    """The task list of one fixture."""
    path = os.path.join(fixture_dir, ingest.fixture_meta(fixture, fixture_dir)["file"])
    with gzip.open(path, "rb") as f:
        return tasks_from_rows(json.loads(f.read())["tasks"])


def parse_torch_name(name: str) -> Optional[Dict[str, Any]]:
    """``torch/<fixture>[@L<k>]`` -> {"fixture", "layers_keep"}, or None."""
    m = _NAME_RE.match(name)
    if not m:
        return None
    return {"fixture": m.group("fixture"),
            "layers_keep": int(m.group("layers")) if m.group("layers") else None}


def ingest_torch_fixture(fixture: str, *, layers_keep: Optional[int] = None,
                         fixture_dir: str = FIXTURE_DIR) -> Tuple[List[Op], IngestReport]:
    """Read and lower one fixture (memoized)."""
    key = (os.path.join(fixture_dir, fixture), layers_keep)
    hit = _ops_cache.get(key)
    if hit is None:
        hit = lower_tasks(load_tasks(fixture, fixture_dir), layers_keep=layers_keep)
        _ops_cache[key] = hit
    return hit


def resolve_torch(name: str):
    """``resolve_workload`` hook: the op-list factory of a ``torch/...``
    name; KeyError on a bad name or fixture."""
    p = parse_torch_name(name)
    if p is None:
        raise KeyError(f"bad torch workload name {name!r}; grammar: "
                       f"'torch/<fixture>[@L<k>]' with fixtures {ingest.fixture_names(FIXTURE_DIR)}")
    fixture, keep = p["fixture"], p["layers_keep"]
    if fixture not in ingest.fixture_names(FIXTURE_DIR):
        raise KeyError(f"unknown torch fixture {fixture!r}; have "
                       f"{ingest.fixture_names(FIXTURE_DIR)} (regenerate with "
                       f"tools/gen_torch_fixtures.py)")
    if keep is not None:
        ingest_torch_fixture(fixture, layers_keep=keep)

    def build() -> List[Op]:
        return list(ingest_torch_fixture(fixture, layers_keep=keep)[0])

    return build
