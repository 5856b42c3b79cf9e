"""The port's own programs as simulator workloads, on the CPU.

``graph/capture.py`` records a program of the port as the task list one
device runs; ``tools/gen_torch_fixtures.py`` writes the three captures of
``graph/torch_ingest.CAPTURES`` (the programs the JAX package captures as
HLO) under ``configs/torch_graphs/``; ``torch/<fixture>[@L<k>]`` names
resolve through ``graph/torch_ingest.py`` and ``ingest.lower_tasks``.

* Each fixture against the JAX package's HLO capture of the same program
  (numpy-parsed: no JAX run): 28 layer blocks in both; product FLOPs within
  2%, and the gap by hand (prefill: XLA multiplies the whole masked S x S
  square, the flash task the visible pairs; decode: equal; 1x2: besides,
  XLA splits the K and V products and the LM head over the two ranks,
  which the port runs whole on each); the collectives of a 1x2 layer, two
  all-reduces in both, at half XLA's payload (XLA's CPU backend reduces
  f32 partials of the bf16 products), and XLA's two all-to-alls of K and
  V, which the port does not issue (ROADMAP §3); the HBM-byte ratio.
* The same against a live JAX compile of reduced qwen2 on its Auto 1x1
  mesh.
* The generator's capture is the checked-in fixture, byte for byte, twice;
  the manifest's SHA-256 is the decompressed file's.
* ``torch/`` names resolve with torch, jax and ``repro`` blocked from
  import (spawned refinement workers); ``@L4`` twins extrapolate through
  ``core.fastsim`` to the event engine's makespan; the crosscheck campaign
  puts each fixture inside its manifest band against its ``lm/`` twin.
* The recorder leaves out DTensor's sharding propagation (global shapes on
  fake tensors), and would show it if it did not.
* Under a recorder each kernel wrapper's plain version is one task with
  the kernel's FLOPs (flash: ``chip_smoke.py::visible_pairs`` x 4·hd per
  head) and bytes; the dry-run writes a forward cell's capture beside its
  JSON, and a train cell's none.
"""
import gzip
import hashlib
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JAX_REGISTRY, ShapeSpec as JaxShapeSpec
from repro.graph import ingest as jax_ingest
from repro.graph.hlo_parser import extract_tasks
from repro.launch.programs import build_program as jax_build_program
from repro_torch.configs import REGISTRY, ShapeSpec, get_config
from repro_torch.core import fastsim
from repro_torch.graph import ingest, torch_ingest
from repro_torch.graph.capture import TaskRecorder, dumps
from repro_torch.graph.compiler import CompileOptions, compile_ops
from repro_torch.graph.workloads import resolve_workload
from repro_torch.hw.presets import resolve_preset
from repro_torch.kernels.flash_attention.ops import flash_mha
from repro_torch.kernels.flash_attention.ref import visible
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.ssm_scan.ops import ssm_scan_batched
from repro_torch.launch import dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (stdlib only at import)

FIXTURES = ingest.fixture_names(torch_ingest.FIXTURE_DIR)
CAPTURES = {c[0]: c for c in torch_ingest.CAPTURES}
QWEN = REGISTRY["qwen2-1.5b"]


def _capture(fixture):
    _, arch, seq, batch, kind, mesh, _ = CAPTURES[fixture]
    return dryrun.capture_fake(get_config(arch), ShapeSpec(f"fx_{fixture}", seq, batch, kind),
                               mesh)


def _meta(fixture):
    return ingest.fixture_meta(fixture, torch_ingest.FIXTURE_DIR)


def _masked_square_gap(B, S, H, hd, L):
    """XLA's attention products over the whole S x S square against the
    flash task's visible pairs (4·hd a pair of each head)."""
    return L * 4 * hd * B * H * (S * S - S * (S + 1) // 2)


def test_three_fixtures_with_manifest_fields():
    assert FIXTURES == sorted(CAPTURES) == jax_ingest.fixture_names()
    for fx in FIXTURES:
        meta = _meta(fx)
        _, arch, seq, batch, kind, mesh, twin = CAPTURES[fx]
        assert meta["file"] == f"{fx}.tasks.json.gz"
        assert (meta["arch"], meta["phase"], meta["twin"], meta["hlo"]) == (arch, kind, twin, fx)
        assert meta["shape"] == {"seq_len": seq, "global_batch": batch, "kind": kind}
        assert tuple(meta["mesh"]) == mesh and meta["layers"] == 28
        assert meta["twin"] == jax_ingest.fixture_meta(fx)["twin"]
        lo, hi = meta["band"]
        assert 0 < lo < hi


@pytest.mark.parametrize("fixture", FIXTURES)
def test_manifest_hash_is_the_decompressed_file(fixture):
    meta = _meta(fixture)
    with gzip.open(os.path.join(torch_ingest.FIXTURE_DIR, meta["file"]), "rb") as f:
        text = f.read()
    assert hashlib.sha256(text).hexdigest() == meta["sha256"]


@pytest.mark.parametrize("fixture", FIXTURES)
def test_generator_capture_is_the_fixture(fixture):
    with gzip.open(os.path.join(torch_ingest.FIXTURE_DIR, f"{fixture}.tasks.json.gz"),
                   "rb") as f:
        want = f.read()
    assert dumps(_capture(fixture)) == want


def test_capture_is_deterministic():
    a, b = (dumps(_capture("qwen2_1_5b_prefill")) for _ in range(2))
    assert a == b


# -- against the JAX package's HLO captures ---------------------------------

@pytest.mark.parametrize("fixture", FIXTURES)
def test_capture_against_the_hlo_capture(fixture):
    _, got = torch_ingest.ingest_torch_fixture(fixture)
    _, want = jax_ingest.ingest_fixture(fixture)
    assert got.n_layers == want.n_layers == QWEN.n_layers == 28
    S, H, hd, L = 128, QWEN.n_heads, QWEN.hd, QWEN.n_layers
    d, KV = QWEN.d_model, QWEN.n_kv_heads
    ratio = got.mxu_flops / want.mxu_flops
    assert abs(ratio - 1.0) <= 0.02, ratio
    if fixture == "qwen2_1_5b_prefill":            # 0.99587
        assert got.mxu_flops == want.mxu_flops - _masked_square_gap(1, S, H, hd, L)
    elif fixture == "qwen2_1_5b_decode":           # equal: both score every cache slot
        assert got.mxu_flops == want.mxu_flops
    else:                                          # 1.01389 on 1x2
        # heads split: half the square's gap; XLA splits the K and V products
        # over the tokens of the two ranks (and all-to-alls them) and the
        # vocabulary of the tied head, which the port computes whole on each
        kv = L * 2 * (2 * S * d * KV * hd) // 2
        head = 2 * d * QWEN.padded_vocab // 2
        assert got.mxu_flops == \
            want.mxu_flops - _masked_square_gap(1, S, H // 2, hd, L) + kv + head
    # eager torch does not fuse, but XLA's CPU capture keeps its bf16
    # products' operands and results in f32: 0.236 / 0.263 / 0.307 of the
    # HLO's bytes (decode / prefill / 1x2)
    assert 0.2 <= got.hbm_bytes / want.hbm_bytes <= 0.35


def _layer_collectives(tasks, prefix):
    return sorted((t.collective.op, t.collective.payload_bytes, t.collective.group_size)
                  for t in tasks if t.engine == "ici" and t.name.startswith(prefix))


def test_tp2_collectives_per_layer():
    """Per layer of the 1x2 capture: two all-reduces of the bf16 residual
    partials [128, 1536] (after the out projection and the FFN). XLA's
    capture all-reduces the same two sums in f32 (twice the payload) and
    all-to-alls the K and V products it splits over the tokens; outside its
    layer loop it gathers four [128, 64] tables. The kinds and payloads
    differ so: a divergence (ROADMAP §3)."""
    tasks = torch_ingest.load_tasks("qwen2_1_5b_prefill_tp2")
    want_layer = [("all-reduce", 128 * 1536 * 2, 2)] * 2
    for i in range(QWEN.n_layers):
        assert _layer_collectives(tasks, f"layers[{i}].") == want_layer
    assert _layer_collectives([t for t in tasks if not t.name.startswith("layers[")], "") == []
    hlo = extract_tasks(jax_ingest.load_fixture("qwen2_1_5b_prefill_tp2"))
    assert _layer_collectives(hlo, "while.2[0].") == \
        [("all-reduce", 128 * 1536 * 4, 2)] * 2 + [("all-to-all", 65536, 2)] * 2
    assert _layer_collectives([t for t in hlo if "[" not in t.name], "") == \
        [("all-gather", 32768, 2)] * 4


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_capture_against_a_live_jax_program(kind):
    """Reduced qwen2 (4 layers, d 64), B 2 against a cache of 64, through
    the JAX package's build_program on its Auto 1x1 mesh, compiled and
    parsed, against the port's capture of the same program."""
    S, B = 64, 2
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    text = jax_build_program(JAX_REGISTRY["qwen2-1.5b"].reduced(), JaxShapeSpec("p", S, B, kind),
                             mesh).lower().compile().as_text()
    _, want = jax_ingest.lower_tasks(extract_tasks(text))
    cfg = QWEN.reduced()
    _, got = ingest.lower_tasks(dryrun.capture_fake(cfg, ShapeSpec("p", S, B, kind), (1, 1)))
    assert got.n_layers == want.n_layers == cfg.n_layers
    gap = _masked_square_gap(B, S, cfg.n_heads, cfg.hd, cfg.n_layers) if kind == "prefill" else 0
    assert got.mxu_flops == want.mxu_flops - gap          # 0.911 / 1.000 of XLA's
    assert 0.1 <= got.hbm_bytes / want.hbm_bytes <= 0.5    # 0.375 / 0.164


# -- workload names, twins, the crosscheck -------------------------------------

_NO_TORCH = r"""
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in ("torch", "jax", "repro")):
            raise ImportError(f"blocked import: {name}")
        return None

sys.meta_path.insert(0, Block())
from repro_torch.graph.workloads import resolve_workload
for fx in sys.argv[1:]:
    for name in (f"torch/{fx}", f"torch/{fx}@L4"):
        print(name, len(resolve_workload(name)()))
assert not any(m == "torch" or m.startswith("torch.") for m in sys.modules)
"""


def test_torch_names_resolve_without_torch():
    r = subprocess.run([sys.executable, "-c", _NO_TORCH, *FIXTURES], capture_output=True,
                       text=True, env=dict(os.environ, PYTHONPATH=SRC), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    counts = dict(line.rsplit(" ", 1) for line in r.stdout.split("\n") if line)
    for fx in FIXTURES:
        ops, rep = torch_ingest.ingest_torch_fixture(fx)
        assert int(counts[f"torch/{fx}"]) == len(ops)
        assert int(counts[f"torch/{fx}@L4"]) == len(ops) - 24 * rep.layer_ops


def test_bad_torch_names_raise():
    for name in ("torch/nope", "torch/qwen2_1_5b_prefill@L29", "torch/"):
        with pytest.raises(KeyError):
            resolve_workload(name)()


@pytest.mark.parametrize("fixture", FIXTURES)
def test_reduced_twin_extrapolates(fixture):
    """The full capture and its @L<k> twin (k of the phase's replay depth)
    match block for block; the fast engine splices the 28 layers from the
    twin's replay and lands on the event engine's makespan."""
    cfg = resolve_preset("v5e")
    opts = CompileOptions(n_tiles=2)
    full = compile_ops(resolve_workload(f"torch/{fixture}")(), cfg, opts)
    k = fastsim.FAST_REPLAY_LAYERS_BY_PHASE[_meta(fixture)["phase"]]
    twin = compile_ops(resolve_workload(f"torch/{fixture}@L{k}")(), cfg, opts)
    match, reason = fastsim.match_blocks(full, twin)
    assert match is not None, reason
    assert match.layers == 28 and match.reduced_layers == k
    run = fastsim.simulate_fast(full, cfg, n_tiles=2, reduced=[twin])
    assert run.extrapolated, run.detail
    _, end, samples = fastsim.replay_intervals(full.tasks, cfg, n_tiles=2)
    assert abs(run.makespan_ns - samples.makespan()) < 1e-3
    assert np.abs(run.end - end).max() < 1e-3


_CAMPAIGN = []


def _crosscheck():
    if not _CAMPAIGN:
        from repro_torch.sweep.runner import run_campaign
        from repro_torch.sweep.spec import load_spec

        spec = load_spec(os.path.join(torch_ingest.FIXTURE_DIR, "crosscheck.json"))
        _CAMPAIGN.append(run_campaign(spec, workers=0, use_cache=False, backend="inline",
                                      device="cpu"))
    return _CAMPAIGN[0]


@pytest.mark.parametrize("fixture", FIXTURES)
def test_crosscheck_lands_in_the_manifest_band(fixture):
    res = _crosscheck()
    s = res.summary["torch_crosscheck"][fixture]
    assert s["band"] == _meta(fixture)["band"]
    assert s["twin"] == _meta(fixture)["twin"]
    assert s["cells"] == 2 and s["in_band"] == 2, s
    lo, hi = s["band"]
    assert lo <= s["analytic_ratio_min"] <= s["analytic_ratio_max"] <= hi
    # the eager program's many small vector tasks sit between the hand-built
    # twin and XLA's unfused CPU capture
    assert s["hlo_analytic_ratio_max"] < 1.0
    assert res.summary["hlo_crosscheck"][fixture]["in_band"] == 2
    for r in res.records:
        if r["workload"] == f"torch/{fixture}":
            dev = r["torch_deviation"]
            assert r["torch_twin"] == s["twin"] and dev["in_band"]
            # the compiled workloads' FLOPs count vector elements besides the
            # products: XLA's decode capture holds more of them (decode /
            # prefill / 1x2: 0.900 / 0.990 / 1.006 of the HLO capture's)
            assert 0.85 <= dev["hlo"]["flops_ratio"] <= 1.05


# -- DTensor's sharding propagation ------------------------------------------

def _dtensor_mul_tasks(rows):
    """``x * 2`` on a DTensor of [rows, 10] split by rows over the 'model'
    axis of a (1, 2) fake mesh (a shape no earlier test met, so DTensor
    propagates it afresh), under a recorder: the mul tasks' elements."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.mesh import make_mesh

    started = dryrun._fake_world(2)
    try:
        mesh = make_mesh((1, 2), ("data", "model"), "cpu")
        x = DTensor.from_local(torch.randn(rows // 2, 10), mesh, [Replicate(), Shard(0)],
                               run_check=False)
        rec = TaskRecorder()
        with rec:
            x * 2
        return [t.elems for t in rec.tasks if t.name.startswith("mul.")]
    finally:
        if started:
            torch.distributed.destroy_process_group()


def test_recorder_skips_sharding_propagation(monkeypatch):
    """DTensor runs a fresh op once on fake tensors of the global shapes to
    learn its output's: the recorder keeps only the local op. With the
    propagation not told apart, the global op shows (so the check sees it)."""
    from repro_torch.graph import capture

    assert _dtensor_mul_tasks(34) == [17 * 10]
    monkeypatch.setattr(capture, "_in_sharding_propagation", lambda: False)
    assert sorted(_dtensor_mul_tasks(38)) == [19 * 10, 38 * 10]


# -- the kernel wrappers under a recorder -----------------------------------------

def _one_task(fn, *args, **kw):
    rec = TaskRecorder()
    with rec:
        out = fn(*args, **kw)
    assert len(rec.tasks) == 1, [t.name for t in rec.tasks]
    return rec.tasks[0], out


@pytest.mark.parametrize("mask", [(True, 0, 0), (True, 40, 5), (False, 0, 0)])
def test_flash_wrapper_is_one_task_of_the_visible_pairs(mask):
    causal, window, n_sink = mask
    B, S, H, KV, hd = 2, 100, 4, 2, 16
    q, k, v = (torch.randn(B, S, h, hd) for h in (H, KV, KV))
    t, out = _one_task(flash_mha, q, k, v, causal=causal, window=window, n_sink=n_sink)
    pairs = chip_smoke.visible_pairs(S, S, window, n_sink) if causal else S * S
    assert t.name == "flash_attention.0" and t.engine == "mxu"
    assert t.flops == 4 * hd * B * H * pairs
    assert t.bytes_in == 4 * (q.numel() + k.numel() + v.numel())
    assert t.bytes_out == 4 * out.numel()


def test_flash_task_counts_the_visible_pairs_of_a_row_shard():
    B, S, H, hd, r0, m = 1, 96, 2, 16, 40, 24
    q, k, v = (torch.randn(B, n, H, hd) for n in (m, S, S))
    t, _ = _one_task(flash_mha, q, k, v, causal=True, window=30, n_sink=3, q_off=r0)
    seen = visible(torch.arange(m)[:, None], torch.arange(S)[None, :], S, causal=True,
                   window=30, n_sink=3, q_off=r0)
    assert t.flops == 4 * hd * B * H * int(seen.sum())


def test_rmsnorm_and_scan_wrappers_are_one_vector_task():
    x, w = torch.randn(6, 32), torch.randn(32)
    t, y = _one_task(rmsnorm, x, w)
    assert (t.name, t.engine, t.elems) == ("rmsnorm.0", "vector", x.numel())
    assert (t.bytes_in, t.bytes_out) == (4 * (x.numel() + 32), 4 * y.numel())
    a, b = torch.rand(2, 9, 12), torch.randn(2, 9, 12)
    t, h = _one_task(ssm_scan_batched, a, b)
    assert (t.name, t.engine, t.elems) == ("ssm_scan.0", "vector", a.numel())
    assert (t.bytes_in, t.bytes_out) == (8 * a.numel(), 4 * h.numel())


def test_dryrun_train_cell_writes_no_capture(tmp_path):
    """A train step's backward runs after its forward, through autograd (on
    the card the kernels' backward through ctypes): its capture would not
    be the program the card runs, so the cell writes none."""
    cfg = REGISTRY["smollm-135m"].reduced()
    cell = dryrun.run_cell(cfg, ShapeSpec("train_tiny", 32, 16, "train"), False,
                           str(tmp_path), verbose=False)
    assert cell["status"] == "ok", cell.get("traceback")
    assert "capture" not in cell
    assert [p.suffix for p in tmp_path.iterdir()] == [".json"]


def test_dryrun_writes_the_cells_capture(tmp_path):
    cell = dryrun.run_cell("smollm-135m", "decode_32k", False, str(tmp_path), verbose=False)
    assert cell["status"] == "ok", cell.get("traceback")
    path = tmp_path / cell["capture"]
    assert cell["capture"] == "smollm-135m__decode_32k__pod16x16.tasks.json.gz"
    rows = json.loads(gzip.decompress(path.read_bytes()))["tasks"]
    _, rep = ingest.lower_tasks(torch_ingest.tasks_from_rows(rows))
    assert rep.n_layers == REGISTRY["smollm-135m"].n_layers
    assert rep.collective_bytes > 0             # the 16x16 mesh's collectives
