"""Real-graph ingestion: scheduled HLO -> the hand-built ``Op`` contract.

The paper's pitch is "interfacing directly with AI frameworks ... linking
various in-house NPU graph compilers"; ``graph/hlo_parser.py`` already
parses ``jax.jit(...).lower(...).compile().as_text()`` into an
engine-mapped task list, and this module closes the loop by lowering
that list into the exact ``Op`` contract ``graph/workloads.py`` factories
produce — so every downstream consumer (``graph/compiler.py``,
the event engine, ``core/fastsim``/``core/batchsim``, the sweep
pre-screen, Power-EM) runs real compiler output unchanged.

Mapping rules (see docs/ARCHITECTURE.md for the worked tour):

* ``mxu`` tasks -> ``Op(kind="matmul")``. GEMM geometry comes from the
  parser's dominant-contraction view (``TaskSpec.gemm``: k = contracting
  dims, n = trailing output dim); ``m`` is rescaled so ``2*m*n*k``
  reproduces the task's total FLOPs (a fusion may contain several dots).
  A fused vector epilogue (``TaskSpec.elems``) becomes a companion
  VMEM-resident eltwise op so vector work is conserved.
* ``vector`` tasks -> ``Op(kind="eltwise", vec_kind="generic")`` (the
  kernel table kind is *estimated* — HLO fusion names don't identify the
  dominant kernel); ``dma`` tasks (copies/slices/layout ops) ->
  ``Op(kind="eltwise", vec_kind="copy", elems=1)`` — pure data movement,
  costed by their byte footprint.
* ``ici`` tasks -> collective op kinds (``allreduce``/``allgather``/
  ``reducescatter``/``alltoall``/``permute``) carrying the parser's
  payload bytes, decoded replica-group size, and cross-pod flag;
  trivial one-member groups are dropped.
* every non-collective op carries ``stream=True`` with the parser's
  fusion-level read/write byte estimates (and ``w_bytes=0`` — XLA
  already scheduled the weight movement as explicit tasks), so the
  compiled ``hbm_bytes`` equals the parser's HBM-traffic estimate
  exactly, at ``dtype_bytes=1`` (ingested byte counts are real bytes).

**Layer blocks**: the dominant while loop (a ``jax.lax.scan`` over
layers) is emitted as ``L<i>.<instr>`` blocks *first*, with every
outside-the-loop op (embedding/rope prologue, final norm + LM head)
moved after them — ``core.fastsim`` requires ``L0`` at task index 0 and
a contiguous tail to verify layer periodicity and extrapolate. The op
list is barrier-serialized by ``graph/compiler.py`` regardless of
order, so the move is latency-neutral; it is recorded as a modeling
choice in docs/ARCHITECTURE.md.

**Workload names** (registered in ``graph.workloads.resolve_workload``):

    hlo/<fixture>           the captured graph, all layers
    hlo/<fixture>@L<k>      first k layer blocks only (reduced twin —
                            what ``sweep.refine`` replays to extrapolate)

Fixtures are gzipped ``.hlo.txt.gz`` captures under
``src/repro_torch/configs/hlo/`` with a ``manifest.json`` recording the
generation parameters, the hand-built twin workload name, the SHA-256 of
the decompressed text (staleness-checked by ``tools/check_fixtures.py``),
and the documented hand-built-vs-ingested analytic deviation band that
``python -m repro_torch.sweep crosscheck-hlo`` and ``tests/test_ingest.py``
enforce. Regenerate with ``tools/gen_hlo_fixtures.py``.

No jax anywhere on the import path: refinement workers resolve
``hlo/...`` names in spawn-context subprocesses (see ``sweep/refine.py``).
"""
from __future__ import annotations

import gzip
import hashlib
import json
import os
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from .hlo_parser import TaskSpec, extract_tasks
from .workloads import Op

__all__ = ["FIXTURE_DIR", "IngestReport", "lower_tasks", "structural_hash",
           "parse_hlo_name", "fixture_names", "fixture_meta", "load_fixture",
           "hlo_workload_name", "ingest_fixture", "load_manifest",
           "twin_name"]

FIXTURE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "hlo")

_HLO_NAME_RE = re.compile(
    r"^hlo/(?P<fixture>[A-Za-z0-9_.\-]+)(?:@L(?P<layers>\d+))?$")

# parser collective op -> Op.kind (graph.compiler maps these onto
# hw.ici.CollectiveSpec op strings)
_COLLECTIVE_KINDS = {
    "all-reduce": "allreduce",
    "all-gather": "allgather",
    "reduce-scatter": "reducescatter",
    "all-to-all": "alltoall",
    "collective-permute": "permute",
}

_LOOP_RE = re.compile(r"^(?P<loop>[\w.\-]+)\[(?P<it>\d+)\]\.(?P<rest>.+)$")


@dataclass(frozen=True)
class IngestReport:
    """Conservation totals of one lowering (the differential harness in
    ``tests/test_ingest.py`` checks them against ``hlo_parser.summarize``
    and against the compiled workload)."""

    n_tasks: int                   # parser tasks consumed
    n_ops: int                     # ops emitted
    n_layers: int                  # dominant-loop trip count (0: no loop)
    layer_ops: int                 # ops per layer block
    mxu_flops: float               # sum of 2*m*n*k over matmul ops
    vector_elems: float            # sum of eltwise elems
    hbm_bytes: float               # sum of in+out bytes on streamed ops
    collective_bytes: float        # sum of collective payload bytes
    dropped_collectives: int       # group_size <= 1 collectives skipped
    structural_hash: str = ""


def structural_hash(ops: List[Op]) -> str:
    """Deterministic identity of a lowered op list: SHA-256 over every
    field of every op, in order. Same HLO text -> same hash (the
    determinism property in tests/test_ingest.py)."""
    h = hashlib.sha256()
    for op in ops:
        h.update(repr(op).encode())
        h.update(b"\0")
    return h.hexdigest()


def _dominant_loop(tasks: List[TaskSpec]) -> Tuple[Optional[str], int]:
    """(loop instruction name, trip count) of the while loop carrying the
    most tasks — the scanned layer stack — or (None, 0) without loops."""
    counts: Dict[str, int] = {}
    trips: Dict[str, int] = {}
    for t in tasks:
        m = _LOOP_RE.match(t.name)
        if m:
            loop = m.group("loop")
            counts[loop] = counts.get(loop, 0) + 1
            trips[loop] = max(trips.get(loop, 0), int(m.group("it")) + 1)
    if not counts:
        return None, 0
    loop = max(counts, key=lambda n: (counts[n], n))
    return loop, trips[loop]


def _gemm_dims(t: TaskSpec) -> Tuple[int, int, int]:
    """(m, n, k) for one mxu task, FLOP-preserving: n/k come from the
    parser's dominant contraction, m is rescaled so 2*m*n*k == flops
    (fusions can contain several dots; ``m`` absorbs them)."""
    if t.gemm:
        _, n, k = t.gemm
    else:
        # no recoverable contraction: spread the FLOPs over a cube-ish
        # GEMM so the MXU model sees a realistic blocking, not a GEMV
        s = max(int(round((t.flops / 2.0) ** (1.0 / 3.0))), 1)
        n = k = s
    m = max(int(round(t.flops / (2.0 * n * k))), 1)
    return m, int(n), int(k)


def _lower_one(t: TaskSpec, name: str, out: List[Op]) -> Dict[str, float]:
    """Append the Op(s) for one parser task; returns its totals."""
    tot = {"mxu_flops": 0.0, "vector_elems": 0.0, "hbm_bytes": 0.0,
           "collective_bytes": 0.0, "dropped": 0.0}
    if t.engine == "ici":
        coll = t.collective
        kind = _COLLECTIVE_KINDS.get(coll.op if coll else "", None)
        if kind is None or coll is None or coll.group_size <= 1:
            tot["dropped"] = 1.0
            return tot
        out.append(Op(name=name, kind=kind, in_bytes=coll.payload_bytes,
                      out_bytes=t.bytes_out, group=coll.group_size,
                      cross_pod=coll.crosses_pod))
        tot["collective_bytes"] = float(coll.payload_bytes)
        return tot
    # the event engine's Dma never completes a zero-byte descriptor, and
    # fusions rooted at iota/constant legitimately read nothing — clamp
    # streamed footprints to one byte (noise next to the 5% byte band)
    b_in, b_out = max(t.bytes_in, 1.0), max(t.bytes_out, 1.0)
    if t.engine == "mxu":
        m, n, k = _gemm_dims(t)
        out.append(Op(name=name, kind="matmul", m=m, n=n, k=k,
                      in_bytes=b_in, out_bytes=b_out,
                      stream=True))
        tot["mxu_flops"] = 2.0 * m * n * k
        tot["hbm_bytes"] = b_in + b_out
        if t.elems > 0:
            # fused vector epilogue: VMEM-resident companion (no byte
            # footprint — the mxu op already carries the HBM traffic)
            out.append(Op(name=f"{name}.post", kind="eltwise",
                          elems=t.elems, vec_kind="generic"))
            tot["vector_elems"] = float(t.elems)
        return tot
    vec_kind = "copy" if t.engine == "dma" else "generic"
    elems = 1.0 if t.engine == "dma" else max(t.elems, 1.0)
    out.append(Op(name=name, kind="eltwise", elems=elems,
                  vec_kind=vec_kind, in_bytes=b_in,
                  out_bytes=b_out, stream=True))
    tot["vector_elems"] = elems
    tot["hbm_bytes"] = b_in + b_out
    return tot


def lower_tasks(tasks: List[TaskSpec], *,
                layers_keep: Optional[int] = None
                ) -> Tuple[List[Op], IngestReport]:
    """Lower a parser task list into the hand-built ``Op`` contract.

    The dominant while loop's iterations become ``L<i>.*`` layer blocks
    emitted first; everything outside the loop follows in scheduled
    order (see module docstring for why). ``layers_keep`` truncates to
    the first k layer blocks (the ``@L<k>`` reduced-twin form) while
    keeping the out-of-loop prologue/epilogue intact, so full and
    reduced lowerings share block structure and tail — exactly what
    ``core.fastsim.match_blocks`` requires.
    """
    loop, trip = _dominant_loop(tasks)
    if layers_keep is not None:
        if loop is None:
            raise KeyError("@L<k> reduction needs a scanned layer loop; "
                           "this graph has none")
        if not 1 <= layers_keep <= trip:
            raise KeyError(f"@L{layers_keep} out of range: graph has "
                           f"{trip} layers")
    layer_ops: List[Op] = []
    rest_ops: List[Op] = []
    tot = {"mxu_flops": 0.0, "vector_elems": 0.0, "hbm_bytes": 0.0,
           "collective_bytes": 0.0, "dropped": 0.0}
    layer0_ops = 0
    for t in tasks:
        m = _LOOP_RE.match(t.name)
        if m and m.group("loop") == loop:
            it = int(m.group("it"))
            if layers_keep is not None and it >= layers_keep:
                continue
            dst, name = layer_ops, f"L{it}.{m.group('rest')}"
        else:
            dst, name = rest_ops, t.name.replace("[", "_").replace("]", "_")
        before = len(dst)
        sub = _lower_one(t, name, dst)
        if m and m.group("loop") == loop and int(m.group("it")) == 0:
            layer0_ops += len(dst) - before
        for key in tot:
            tot[key] += sub[key]
    ops = layer_ops + rest_ops
    rep = IngestReport(
        n_tasks=len(tasks), n_ops=len(ops),
        n_layers=(layers_keep if layers_keep is not None else trip),
        layer_ops=layer0_ops,
        mxu_flops=tot["mxu_flops"], vector_elems=tot["vector_elems"],
        hbm_bytes=tot["hbm_bytes"],
        collective_bytes=tot["collective_bytes"],
        dropped_collectives=int(tot["dropped"]),
        structural_hash=structural_hash(ops))
    return ops, rep


# ---------------------------------------------------------------------------
# fixture registry (``hlo/<fixture>[@L<k>]`` workload names)
# ---------------------------------------------------------------------------

_manifest_cache: Dict[str, Any] = {}
_ops_cache: Dict[Tuple[str, Optional[int]], Tuple[List[Op], IngestReport]] = {}


def load_manifest(fixture_dir: str = FIXTURE_DIR) -> Dict[str, Any]:
    """The fixture manifest (cached per directory)."""
    hit = _manifest_cache.get(fixture_dir)
    if hit is not None:
        return hit
    path = os.path.join(fixture_dir, "manifest.json")
    if not os.path.exists(path):
        man: Dict[str, Any] = {"fixtures": {}}
    else:
        with open(path) as f:
            man = json.load(f)
    _manifest_cache[fixture_dir] = man
    return man


def fixture_names(fixture_dir: str = FIXTURE_DIR) -> List[str]:
    return sorted(load_manifest(fixture_dir)["fixtures"])


def fixture_meta(fixture: str, fixture_dir: str = FIXTURE_DIR
                 ) -> Dict[str, Any]:
    fixtures = load_manifest(fixture_dir)["fixtures"]
    if fixture not in fixtures:
        raise KeyError(f"unknown HLO fixture {fixture!r}; have "
                       f"{sorted(fixtures)} (regenerate with "
                       f"tools/gen_hlo_fixtures.py)")
    return fixtures[fixture]


def load_fixture(fixture: str, fixture_dir: str = FIXTURE_DIR) -> str:
    """Decompressed HLO text of one fixture."""
    meta = fixture_meta(fixture, fixture_dir)
    path = os.path.join(fixture_dir, meta["file"])
    with gzip.open(path, "rt") as f:
        return f.read()


def parse_hlo_name(name: str) -> Optional[Dict[str, Any]]:
    """``hlo/<fixture>[@L<k>]`` -> {"fixture", "layers_keep"}, or None
    when the name is not HLO-shaped."""
    m = _HLO_NAME_RE.match(name)
    if not m:
        return None
    return {"fixture": m.group("fixture"),
            "layers_keep": int(m.group("layers")) if m.group("layers")
            else None}


def hlo_workload_name(fixture: str, *, layers: Optional[int] = None) -> str:
    return f"hlo/{fixture}" + (f"@L{layers}" if layers else "")


def ingest_fixture(fixture: str, *, layers_keep: Optional[int] = None,
                   fixture_dir: str = FIXTURE_DIR
                   ) -> Tuple[List[Op], IngestReport]:
    """Parse + lower one fixture (memoized: campaigns resolve the same
    ``hlo/...`` name once per cell and twin replays re-resolve it)."""
    key = (os.path.join(fixture_dir, fixture), layers_keep)
    hit = _ops_cache.get(key)
    if hit is not None:
        return hit
    meta = fixture_meta(fixture, fixture_dir)
    tasks = extract_tasks(load_fixture(fixture, fixture_dir),
                          pod_size=int(meta.get("pod_size", 0)))
    ops, rep = lower_tasks(tasks, layers_keep=layers_keep)
    _ops_cache[key] = (ops, rep)
    return ops, rep


def twin_name(fixture: str, *, layers: Optional[int] = None,
              fixture_dir: str = FIXTURE_DIR) -> str:
    """The hand-built ``lm/...`` twin of a fixture (from the manifest),
    with its ``L<layers>`` segment rewritten for ``@L<k>`` reductions."""
    meta = fixture_meta(fixture, fixture_dir)
    twin = meta["twin"]
    if layers:
        twin = re.sub(r"/L\d+/", f"/L{layers}/", twin, count=1)
    return twin


def resolve_hlo(name: str):
    """``resolve_workload`` hook: op-list factory for an ``hlo/...``
    name; raises KeyError (with the available fixtures) on bad names."""
    p = parse_hlo_name(name)
    if p is None:
        raise KeyError(
            f"bad HLO workload name {name!r}; grammar: "
            f"'hlo/<fixture>[@L<k>]' with fixtures "
            f"{fixture_names()}")
    fixture, keep = p["fixture"], p["layers_keep"]
    fixture_meta(fixture)             # raise early on unknown fixture
    if keep is not None:              # validate the reduction eagerly
        ingest_fixture(fixture, layers_keep=keep)

    def build() -> List[Op]:
        return list(ingest_fixture(fixture, layers_keep=keep)[0])

    return build
