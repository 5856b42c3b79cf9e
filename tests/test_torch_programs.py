"""The port's programs (``launch/programs.py``) on the CPU.

* Prefill and decode through ``build_program`` on a 1x1 mesh (gloo, one
  rank) against the JAX package's ``build_program`` on its one-device mesh,
  for reduced qwen2 and qwen3-moe (whose MoE runs ``moe_ep`` in both
  packages, capacity drops included): logits and cache within 1e-4 in f32.
* One train step through the program on a (2, 2) mesh of four gloo
  processes against the one-process step, for reduced qwen2 and qwen3-moe
  (8 experts: expert parallelism over 2 ranks, so ``all_to_all`` runs
  forward and backward; capacity factor E/k, so no pair drops and the
  one-process dense oracle is the same function); prefill and decode on the
  same mesh (a cache split over the sequence, one-hot MoE at decode).
* One dry-run cell of a reduced dense arch on a 1x1 mesh: argument bytes
  equal the state's and batch's bytes, and the product FLOPs a hand count.

Every process group rendezvous through a ``FileStore`` under a temporary
directory, never a fixed port (the suite runs under ``pytest-xdist``).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_common import close, to_np
from repro.configs import REGISTRY as JAX_REGISTRY, ShapeSpec as JaxShapeSpec
from repro.launch.programs import build_program as jax_build_program
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import REGISTRY, ShapeSpec
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import single_device_mesh
from repro_torch.launch.programs import build_program
from repro_torch.models import build_model
from repro_torch.models.layers import map_templates
from repro_torch.train.loop import init_state, make_train_step
from repro_torch.train.optim import tree_leaves

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
ARCHS = ["qwen2-1.5b", "qwen3-moe-30b-a3b"]


def _numpy_params(model, seed: int):
    rng = np.random.default_rng(seed)

    def draw(t):
        z = rng.standard_normal(t.shape)
        if t.init == "ones":
            return (1.0 + 0.1 * z).astype(np.float32)
        if t.init == "zeros":
            return (0.1 * z).astype(np.float32)
        fan = t.fan_in or (t.shape[-2] if len(t.shape) >= 2 else t.shape[-1])
        return (z * (0.1 if t.init == "small" else 1.0) / max(fan, 1) ** 0.5).astype(np.float32)

    return map_templates(draw, model.template())


def jax_single_device_mesh():
    """The JAX package's one-device mesh (``repro.launch.mesh``), with its
    axes of type Auto: ``jax.make_mesh`` makes them Explicit by default in
    this JAX, under which the reference's GSPMD program does not trace (its
    own multi-device guard fails the same way)."""
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo group and its 1x1 mesh."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield single_device_mesh("cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_program_prefill_decode_match_jax_program(world1, arch):
    cfg = REGISTRY[arch].reduced()
    B, S, smax = 2, 8, 16
    tree = _numpy_params(build_model(cfg), 0)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)

    jcfg = JAX_REGISTRY[arch].reduced()
    jmesh = jax_single_device_mesh()
    jp = jax_build_program(jcfg, JaxShapeSpec("p", smax, B, "prefill"), jmesh)
    jd = jax_build_program(jcfg, JaxShapeSpec("d", smax, B, "decode"), jmesh)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jlogits, jcache = jp.jitted()(jparams, {"tokens": jnp.asarray(toks[:, :S])})
    jlogits2, jcache = jd.jitted()(jparams, jcache, jnp.asarray(toks[:, S:]))

    pp = build_program(cfg, ShapeSpec("p", smax, B, "prefill"), world1)
    pd = build_program(cfg, ShapeSpec("d", smax, B, "decode"), world1)
    assert pp.rules.moe_impl == ("ep" if cfg.is_moe else "dense")
    params, batch = pp.place(params_from_numpy(pp.model, tree, device="cpu"),
                             {"tokens": torch.from_numpy(toks[:, :S])})
    logits, cache = pp.fn(params, batch)
    close(logits.full_tensor(), jlogits, 1e-4)
    logits2, cache = pd.fn(params, cache, torch.from_numpy(toks[:, S:]))
    close(logits2.full_tensor(), jlogits2, 1e-4)
    assert cache["pos"] == int(jcache["pos"]) == S + 1
    got = tree_leaves(cache["segments"])
    want = jax.tree_util.tree_leaves(jcache["segments"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g.full_tensor(), w, 1e-4)


# -- four processes on a (2, 2) mesh ------------------------------------------

# each case: (name, arch, mesh shape, config changes). qwen3-moe at capacity
# factor E/k drops no pair, so the one-process dense oracle is the same
# function; "qwen2-sp" has 6 heads, which do not divide a 'model' axis of 4:
# the sequence-parallel regime (act_seq -> model), where the activations'
# products run on local shards and attention gathers the sequence
CASES = {"qwen2-1.5b": ("qwen2-1.5b", (2, 2), {}),
         "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", (2, 2), {"capacity_factor": 4.0}),
         "qwen2-sp": ("qwen2-1.5b", (1, 4), {"n_heads": 6, "head_dim": 16})}

_WORKER = r"""
import dataclasses, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from repro_torch.configs import REGISTRY, ShapeSpec
from repro_torch.kernels.flash_attention.ops import flash_mha
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.programs import build_program
from repro_torch.models import moe
from repro_torch.train.loop import init_state
from repro_torch.train.optim import tree_leaves

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
CASES = eval(sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world)
meshes = {shape: make_mesh(shape, ("data", "model"), "cpu") for shape in ((2, 2), (1, 4))}
res = {}

def full(x):
    return (x.full_tensor() if isinstance(x, DTensor) else x).detach().numpy()

for name, (arch, shape, changes) in CASES.items():
    mesh = meshes[shape]
    cfg = dataclasses.replace(REGISTRY[arch].reduced(), **changes)
    B, S = 4, 16
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + 1)))
    prog = build_program(cfg, ShapeSpec("t", S, B, "train"), mesh)
    res[name + "/rules"] = np.array([prog.rules.moe_impl, str(prog.rules.ep_axis),
                                     str(prog.rules.table["act_seq"])])
    state = init_state(prog.model, torch.Generator().manual_seed(0), dtype=torch.float32,
                       device="cpu")
    st, bt = prog.place(state, {"tokens": toks[:, :S], "labels": toks[:, 1:]})
    moe.DROP_STATS = []
    st, m = prog.fn(st, bt)
    tally = torch.tensor([len(moe.DROP_STATS), sum(p for p, _ in moe.DROP_STATS),
                          sum(int(k) for _, k in moe.DROP_STATS)])
    dist.all_reduce(tally)                  # pairs routed and computed, over every rank
    res[name + "/ep_calls"] = tally[0].numpy()
    res[name + "/ep_dropped"] = (tally[1] - tally[2]).numpy()
    moe.DROP_STATS = None
    res[name + "/loss"], res[name + "/gnorm"] = full(m["loss"]), full(m["grad_norm"])
    for part in ("m", "v"):
        for i, x in enumerate(tree_leaves(st["opt"][part])):
            res[f"{name}/{part}{i}"] = full(x)
    pp = build_program(cfg, ShapeSpec("p", 2 * S, B, "prefill"), mesh)
    pd = build_program(cfg, ShapeSpec("d", 2 * S, B, "decode"), mesh)
    params = init_state(prog.model, torch.Generator().manual_seed(0), dtype=torch.float32,
                        device="cpu")["params"]
    dp, db = pp.place(params, {"tokens": toks[:, :S]})
    logits, cache = pp.fn(dp, db)
    res[name + "/prefill"] = full(logits)
    res[name + "/cache_split"] = np.array(str(cache["segments"][0]["k"].placements))
    logits, cache = pd.fn(dp, cache, toks[:, S:])
    res[name + "/decode"] = full(logits)
    for i, x in enumerate(tree_leaves(cache["segments"])):
        res[f"{name}/cache{i}"] = full(x)

# flash with its heads split over more ranks than there are K/V heads (4 q
# heads over 1 kv head, 'model' of 2): K and V repeat to one head a q head
g = torch.Generator().manual_seed(5)
q, k, v = (torch.randn(s, generator=g) for s in ((2, 8, 4, 16), (2, 8, 1, 16), (2, 8, 1, 16)))
mesh = meshes[(2, 2)]
dq = distribute_tensor(q, mesh, [Shard(0), Shard(2)])
dk, dv = (distribute_tensor(t, mesh, [Shard(0), Replicate()]) for t in (k, v))
o = flash_mha(dq, dk, dv)
res["flash_gqa/placements"] = np.array(str(o.placements))
res["flash_gqa/got"], res["flash_gqa/want"] = full(o), flash_mha(q, k, v).numpy()
if rank == 0:
    np.savez(out, **res)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def mesh2x2(tmp_path_factory):
    """Run the four ranks once; rank 0's results."""
    d = tmp_path_factory.mktemp("mesh2x2")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), "4", str(d / "store"),
                               str(d / "out.npz"), repr(CASES)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
    return dict(np.load(d / "out.npz"))


def _one_process(name):
    arch, _, changes = CASES[name]
    cfg = dataclasses.replace(REGISTRY[arch].reduced(), **changes)
    model = build_model(cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 17)))

    def fresh():
        return init_state(model, torch.Generator().manual_seed(0), dtype=torch.float32,
                          device="cpu")
    return cfg, model, toks, fresh


@pytest.mark.parametrize("arch", list(CASES))
def test_train_step_on_2x2_mesh_matches_one_process(mesh2x2, arch):
    cfg, model, toks, fresh = _one_process(arch)
    state, m = make_train_step(model)(fresh(), {"tokens": toks[:, :16], "labels": toks[:, 1:]})
    assert abs(float(mesh2x2[arch + "/loss"]) - float(m["loss"])) <= 1e-5 * abs(float(m["loss"]))
    for part in ("m", "v"):
        for i, want in enumerate(tree_leaves(state["opt"][part])):
            want = want.numpy()
            err = np.abs(mesh2x2[f"{arch}/{part}{i}"] - want).max()
            assert err <= 1e-5 * np.abs(want).max(), (part, i, err)
    if cfg.is_moe:   # expert parallelism over the two 'model' ranks, nothing dropped
        assert list(mesh2x2[arch + "/rules"]) == ["ep", "model", "None"]
        assert int(mesh2x2[arch + "/ep_calls"]) > 0
        assert int(mesh2x2[arch + "/ep_dropped"]) == 0


@pytest.mark.parametrize("arch", list(CASES))
def test_serve_on_2x2_mesh_matches_one_process(mesh2x2, arch):
    cfg, model, toks, fresh = _one_process(arch)
    params = fresh()["params"]
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": toks[:, :16]}, 32)
        close(mesh2x2[arch + "/prefill"], logits, 1e-4)
        logits, cache = model.decode_step(params, cache, toks[:, 16:])
    close(mesh2x2[arch + "/decode"], logits, 1e-4)
    # the stacked full-attention cache [L, B, W, KV, hd]: batch over data
    # (where it has more than one rank), sequence over model (kv_seq)
    want_split = "Replicate(), Shard(dim=2)" if CASES[arch][1][0] == 1 else \
        "Shard(dim=1), Shard(dim=2)"
    assert str(mesh2x2[arch + "/cache_split"]) == f"({want_split})"
    for i, want in enumerate(tree_leaves(cache["segments"])):
        close(mesh2x2[f"{arch}/cache{i}"], want, 1e-4)


def test_sequence_parallel_case_runs_in_that_regime(mesh2x2):
    assert list(mesh2x2["qwen2-sp/rules"]) == ["dense", "None", "model"]


def test_flash_repeats_kv_heads_split_below_one_a_rank(mesh2x2):
    assert str(mesh2x2["flash_gqa/placements"]) == "(Shard(dim=0), Shard(dim=2))"
    close(mesh2x2["flash_gqa/got"], mesh2x2["flash_gqa/want"], 1e-5)


# -- the dry-run ----------------------------------------------------------------

def test_dryrun_cell_counts_bytes_and_product_flops(tmp_path):
    """Reduced smollm, train, 1x1 mesh. Argument bytes are the state's and
    the batch's; the product FLOPs are the hand count: per layer the
    forward, twice it in the backward and a recomputation (remat) that stops
    at the last tensor the backward needs (``torch.utils.checkpoint``'s
    early stop: the FFN's out-projection is not run again), the attention's
    score product once more (the plain attention checkpoints each query
    chunk, as the reference's ``remat_chunk`` does; its recomputation stops
    at the probabilities, before the product with V), and the chunked
    cross entropy's logits product four times (forward, recomputed, two in
    the backward). XLA's ``cost_analysis`` of the JAX program counts a
    scanned loop's body once (layers and cross-entropy chunks), so the port's
    count is several times XLA's (3.41 at these shapes)."""
    cfg = REGISTRY["smollm-135m"].reduced()
    B, S = 4, 32
    shape = ShapeSpec("train_tiny", S, B, "train")
    cell = run_cell(cfg, shape, False, out_dir=str(tmp_path), verbose=False,
                    mesh_shape=((1, 1), ("data", "model")))
    assert cell["status"] == "ok", cell.get("traceback")
    assert json.loads((tmp_path / f"{cfg.name}__train_tiny__1x1.json").read_text())["status"] == "ok"

    n_params = sum(np.prod(t.shape) for t in _templates(build_model(cfg).template()))
    state_bytes = n_params * (2 + 4 + 4) + 4          # bf16 params, f32 m and v, int32 step
    batch_bytes = 2 * B * S * 4                       # int32 tokens and labels
    assert cell["memory_analysis"]["argument_size_in_bytes"] == state_bytes + batch_bytes

    d, H, KV, hd, f, L, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
                             cfg.n_layers, cfg.padded_vocab)
    T = B * S
    fwd_layer = (2 * T * d * (H + 2 * KV) * hd + 2 * T * H * hd * d + 3 * 2 * T * d * f
                 + 2 * 2 * B * H * S * S * hd)
    hand = L * (4 * fwd_layer - 2 * T * f * d + 2 * B * H * S * S * hd) + 4 * 2 * T * d * V
    assert cell["cost_analysis"]["flops"] == hand

    jprog = jax_build_program(JAX_REGISTRY["smollm-135m"].reduced(),
                              JaxShapeSpec("t", S, B, "train"), jax_single_device_mesh())
    cost = jprog.lower().compile().cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    ratio = hand / float(cost["flops"])
    print(f"port product FLOPs / XLA cost_analysis flops = {ratio:.3f}")
    assert ratio > 1.0


def _templates(tree):
    out = []
    map_templates(out.append, tree)
    return out


def test_program_fn_takes_plain_tensors_under_rules(world1):
    """The program's function takes a batch it was not given placed (the
    reference's GSPMD guard does the same with ``batch_override``): a plain
    tensor enters the mesh replicated."""
    cfg = REGISTRY["qwen2-1.5b"].reduced()
    prog = build_program(cfg, ShapeSpec("t", 8, 2, "train"), world1)
    state = init_state(prog.model, torch.Generator().manual_seed(0), dtype=torch.float32,
                       device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 9)))
    (st,) = prog.place(state)
    st, m = prog.fn(st, {"tokens": toks[:, :8], "labels": toks[:, 1:]})
    ref_state, ref = make_train_step(prog.model)(
        init_state(prog.model, torch.Generator().manual_seed(0), dtype=torch.float32,
                   device="cpu"), {"tokens": toks[:, :8], "labels": toks[:, 1:]})
    assert abs(float(to_np(m["loss"].full_tensor())) - float(ref["loss"])) <= 1e-6
