"""Sequence-parallel attention and the plain attention's query chunks, on
the CPU.

* ``flash_mha_ref`` takes its query rows in the reference's chunks (512
  rows aimed at, ``q_chunks``) and checkpoints each under autograd: held to
  its unchunked form (1e-6) and to the JAX package's ``attention`` (1e-5 in
  f32, the gradient to ``jax.vjp`` of it at 1e-5), causal, windowed with
  sinks and non-causal, at S 1536 (3 chunks) and a prime S (1 chunk).
* The row offset ``q_off`` in the kernels' twins: each shard of the rows
  run with its first row as ``q_off`` against the whole K and V gives the
  unsplit call's rows (the same bits where the shard's edges fall on the
  twin's query tiles), dK and dV summed over the shards give the unsplit
  call's; ``bwd_split_plan`` covers every visible (row, key) pair once.
* A reduced qwen2, hymba (6 heads, which a 'model' axis of 4 does not
  divide: the sequence-parallel regime) and xlstm (2 heads) on a (1, 4)
  mesh of four gloo processes: prefill logits and one train step's loss
  and moments against one process, with the query reaching ``flash_mha``
  split (each rank's rows S / 4, its ``q_off`` the shard's first row).
* The dry-run takes the reference's command line (``--no-hlo``) and
  ``run_cell(..., save_hlo=False)``; qwen2-1.5b x prefill_32k on 16x16
  (fake tensors, nothing allocated) peaks under 10 GiB a device at the
  hand count of its FLOPs.
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

from _torch_common import close, randn
from repro.models import attention as jax_attn
from repro_torch.configs import REGISTRY, ShapeSpec
from repro_torch.kernels.flash_attention.kernel import SIMT_TILE, WGMMA_BLOCK_Q
from repro_torch.kernels.flash_attention.ref import (bwd_split_plan, flash_mha_bwd_tiled,
                                                     flash_mha_ref, flash_mha_tiled,
                                                     flash_mha_unchunked, q_chunks, visible)
from repro_torch.launch import dryrun
from repro_torch.models import build_model
from repro_torch.train.loop import init_state, make_train_step
from repro_torch.train.optim import tree_leaves

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

# (causal, window, n_sink) by name; the windowed cases keep window + 512 >= S,
# where the reference's attention is not banded (its banded form drops the
# sinks outside the band: ROADMAP §3, a divergence the port does not copy)
MASKS = {"causal": (True, 0, 0), "window_sinks": (True, 1100, 7), "non_causal": (False, 0, 0)}


def test_chunks_follow_the_reference_rule():
    assert [q_chunks(S) for S in (1, 100, 512, 1031, 1536, 2056, 4096, 32768)] == \
        [1, 1, 1, 1, 3, 4, 8, 64]


@pytest.mark.parametrize("S", [1536, 1031])
@pytest.mark.parametrize("mask", list(MASKS))
def test_chunked_plain_attention_matches_unchunked_and_jax(S, mask):
    causal, window, n_sink = MASKS[mask]
    if S == 1031 and window:
        window = 300
    B, H, KV, hd = 1, 4, 2, 16
    q, k, v, do = (randn(i, (B, S, h, hd)) for i, h in enumerate((H, KV, KV, H)))
    kw = dict(causal=causal, window=window, n_sink=n_sink)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    got = flash_mha_ref(tq, tk, tv, **kw)
    close(got, flash_mha_unchunked(tq, tk, tv, **kw), 1e-6)

    def jfn(a, b, c):
        return jax_attn.attention(a, b, c, **kw)
    jout, vjp = jax.vjp(jax.jit(jfn), *(jnp.asarray(x) for x in (q, k, v)))
    close(got, jout, 1e-5)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    grads = torch.autograd.grad(flash_mha_ref(*leaves, **kw), leaves, tdo)
    for g, w in zip(grads, vjp(jnp.asarray(do))):
        close(g, w, 1e-5)


def _shards(S, n):
    """The first rows of n shards of S rows (even)."""
    return [i * (S // n) for i in range(n)]


@pytest.mark.parametrize("mask", ["causal", "window_sinks", "non_causal"])
@pytest.mark.parametrize("block,n,tc", [(SIMT_TILE, 4, False), (WGMMA_BLOCK_Q, 2, True),
                                        (SIMT_TILE, 3, False)])
def test_forward_twin_shards_are_the_unsplit_rows(mask, block, n, tc):
    causal, window, n_sink = MASKS[mask]
    window = min(window, 100)
    S = 256 if n != 3 else 255
    q, k, v = (torch.from_numpy(randn(10 + i, (2, S, h, 16))) for i, h in enumerate((4, 2, 2)))
    kw = dict(causal=causal, window=window, n_sink=n_sink, block_q=block, block_k=block,
              tensor_cores=tc)
    want, want_l = flash_mha_tiled(q, k, v, return_lse=True, **kw)
    m = S // n
    for r0 in _shards(S, n):
        got, got_l = flash_mha_tiled(q[:, r0:r0 + m], k, v, q_off=r0, return_lse=True, **kw)
        if m % block == 0:
            assert torch.equal(got, want[:, r0:r0 + m])
            assert torch.equal(got_l, want_l[:, :, r0:r0 + m])
        else:
            close(got, want[:, r0:r0 + m], 1e-6)
        close(got, flash_mha_ref(q[:, r0:r0 + m], k, v, q_off=r0, causal=causal,
                                 window=window, n_sink=n_sink), 1e-5)


@pytest.mark.parametrize("mask", ["causal", "window_sinks", "non_causal"])
@pytest.mark.parametrize("n", [4, 3])
def test_backward_twin_shards_sum_to_the_unsplit_call(mask, n):
    causal, window, n_sink = MASKS[mask]
    window = min(window, 100)
    S = 256 if n == 4 else 255
    q, k, v, do = (torch.from_numpy(randn(20 + i, (2, S, h, 16)))
                   for i, h in enumerate((4, 2, 2, 4)))
    kw = dict(causal=causal, window=window, n_sink=n_sink)
    o = flash_mha_ref(q, k, v, **kw)
    dq, dk, dv = flash_mha_bwd_tiled(q, k, v, o, do, **kw)
    m = S // n
    sk, sv = torch.zeros_like(dk), torch.zeros_like(dv)
    for r0 in _shards(S, n):
        rows = slice(r0, r0 + m)
        gq, gk, gv = flash_mha_bwd_tiled(q[:, rows], k, v, o[:, rows], do[:, rows], q_off=r0,
                                         **kw)
        if m % SIMT_TILE == 0:
            assert torch.equal(gq, dq[:, rows])
        else:
            close(gq, dq[:, rows], 1e-5)
        sk, sv = sk + gk, sv + gv
    close(sk, dk, 1e-5)
    close(sv, dv, 1e-5)


@pytest.mark.parametrize("Sq,Sk,q_off", [(64, 256, 192), (100, 300, 37), (96, 512, 200),
                                         (256, 256, 0), (50, 130, 80), (130, 1024, 64)])
@pytest.mark.parametrize("mask", [(True, 0, 0), (True, 40, 5), (True, 200, 64),
                                  (False, 0, 0)])
def test_split_plan_with_row_offset_covers_each_visible_pair_once(Sq, Sk, q_off, mask):
    causal, window, n_sink = mask
    G, t = 3, SIMT_TILE
    kw = dict(causal=causal, window=window, n_sink=n_sink, q_off=q_off)
    count = np.zeros((G, Sq, Sk), np.int64)
    for it in bwd_split_plan(Sq, Sk, G, **kw):
        assert it.q_lo % t == 0
        for u in range(it.u0, it.u1):
            g, q0 = u // it.n_qt, it.q_lo + (u % it.n_qt) * t
            count[g, q0:q0 + t, it.j * t:(it.j + 1) * t] += 1
    rows = torch.arange(Sq)[:, None]
    cols = torch.arange(Sk)[None, :]
    seen = np.broadcast_to(visible(rows, cols, Sk, **kw).numpy(), (Sq, Sk))
    for g in range(G):
        assert (count[g][seen] == 1).all()
    assert count.max() <= 1


# -- a (1, 4) gloo mesh, the sequence split -------------------------------------

# name -> (arch, config changes, S): 6 heads (xlstm: 2) over a 'model' axis
# of 4 put the sequence on it (hymba: 16 tokens + 8 meta tokens, 6 rows a
# rank); xlstm's mLSTM and sLSTM scans run on local batch rows and heads,
# the sequence whole
SP_CASES = {"qwen2": ("qwen2-1.5b", {"n_heads": 6, "head_dim": 16}, 16),
            "hymba": ("hymba-1.5b", {"n_heads": 6}, 16),
            "xlstm": ("xlstm-125m", {"n_heads": 2, "head_dim": 32}, 16)}
ATTENTION_CASES = ["qwen2", "hymba"]

_WORKER = r"""
import dataclasses, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor import DTensor
from repro_torch.configs import REGISTRY, ShapeSpec
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.programs import build_program
from repro_torch.train.loop import init_state
from repro_torch.train.optim import tree_leaves

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
CASES = eval(sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world)
mesh = make_mesh((1, 4), ("data", "model"), "cpu")
calls = []
plain = flash_ops.flash_mha_ref

def spy(q, k, v, **kw):
    calls.append((q.shape[1], k.shape[1], kw.get("q_off", 0)))
    return plain(q, k, v, **kw)

flash_ops.flash_mha_ref = spy
res = {}

def full(x):
    return (x.full_tensor() if isinstance(x, DTensor) else x).detach().numpy()

for name, (arch, changes, S) in CASES.items():
    cfg = dataclasses.replace(REGISTRY[arch].reduced(), **changes)
    B = 4
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + 1)))
    prog = build_program(cfg, ShapeSpec("t", S, B, "train"), mesh)
    res[name + "/act_seq"] = np.array(str(prog.rules.table["act_seq"]))
    state = init_state(prog.model, torch.Generator().manual_seed(0), dtype=torch.float32,
                       device="cpu")
    st, bt = prog.place(state, {"tokens": toks[:, :S], "labels": toks[:, 1:]})
    calls.clear()
    st, m = prog.fn(st, bt)
    res[name + "/train_calls"] = np.array(calls)
    res[name + "/loss"], res[name + "/gnorm"] = full(m["loss"]), full(m["grad_norm"])
    for part in ("m", "v"):
        for i, x in enumerate(tree_leaves(st["opt"][part])):
            res[f"{name}/{part}{i}"] = full(x)
    pp = build_program(cfg, ShapeSpec("p", 2 * S, B, "prefill"), mesh)
    params = init_state(prog.model, torch.Generator().manual_seed(0), dtype=torch.float32,
                        device="cpu")["params"]
    dp, db = pp.place(params, {"tokens": toks[:, :S]})
    calls.clear()
    with torch.no_grad():
        logits, cache = pp.fn(dp, db)
    res[name + "/prefill_calls"] = np.array(calls)
    res[name + "/prefill"] = full(logits)
np.savez(out + f".{rank}.npz", **res)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def mesh1x4(tmp_path_factory):
    """Run the four ranks once; every rank's results."""
    d = tmp_path_factory.mktemp("mesh1x4")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), "4", str(d / "store"),
                               str(d / "out"), repr(SP_CASES)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
    return [dict(np.load(d / f"out.{r}.npz")) for r in range(4)]


def _one_process(name):
    arch, changes, S = SP_CASES[name]
    cfg = dataclasses.replace(REGISTRY[arch].reduced(), **changes)
    model = build_model(cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (4, S + 1)))

    def fresh():
        return init_state(model, torch.Generator().manual_seed(0), dtype=torch.float32,
                          device="cpu")
    return cfg, model, toks, S, fresh


@pytest.mark.parametrize("name", ATTENTION_CASES)
def test_sequence_split_query_reaches_flash_split(mesh1x4, name):
    cfg, _, _, S, _ = _one_process(name)
    rows = S + cfg.n_meta_tokens
    for rank, res in enumerate(mesh1x4):
        assert str(res[name + "/act_seq"]) == "model"
        for kind in ("train", "prefill"):
            calls = res[f"{name}/{kind}_calls"]
            assert len(calls) > 0
            # each rank holds rows / 4 query rows, from its shard's first row,
            # against the whole sequence's keys
            assert (calls[:, 0] == rows // 4).all(), calls
            assert (calls[:, 1] == rows).all(), calls
            assert (calls[:, 2] == rank * (rows // 4)).all(), calls


@pytest.mark.parametrize("name", list(SP_CASES))
def test_sequence_split_train_and_prefill_match_one_process(mesh1x4, name):
    cfg, model, toks, S, fresh = _one_process(name)
    state, m = make_train_step(model)(fresh(), {"tokens": toks[:, :S], "labels": toks[:, 1:]})
    res = mesh1x4[0]
    assert abs(float(res[name + "/loss"]) - float(m["loss"])) <= 1e-5 * abs(float(m["loss"]))
    assert abs(float(res[name + "/gnorm"]) - float(m["grad_norm"])) <= \
        1e-4 * abs(float(m["grad_norm"]))
    for part in ("m", "v"):
        for i, want in enumerate(tree_leaves(state["opt"][part])):
            want = want.numpy()
            err = np.abs(res[f"{name}/{part}{i}"] - want).max()
            assert err <= 1e-5 * np.abs(want).max(), (part, i, err)
    with torch.no_grad():
        logits, _ = model.prefill(fresh()["params"], {"tokens": toks[:, :S]}, 2 * S)
    close(res[name + "/prefill"], logits, 1e-4)


# -- the dry-run ----------------------------------------------------------------

def test_dryrun_takes_the_reference_command_line(tmp_path):
    """The reference's options, ``--no-hlo`` among them, on one cell."""
    argv = ["--arch", "smollm-135m", "--shape", "decode_32k", "--mesh", "single",
            "--out", str(tmp_path), "--no-hlo", "--skip-existing", "--remat-policy", "full",
            "--microbatches", "1"]
    assert dryrun.main(argv) == 0
    cell = json.loads((tmp_path / "smollm-135m__decode_32k__pod16x16.json").read_text())
    assert cell["status"] == "ok"


def test_dryrun_run_cell_takes_save_hlo():
    cell = dryrun.run_cell("smollm-135m", "decode_32k", False, None, save_hlo=False,
                           verbose=False)
    assert cell["status"] == "ok", cell.get("traceback")


def test_dryrun_prefill_32k_sequence_parallel_cell_by_hand():
    """qwen2-1.5b x prefill_32k on 16x16: its 12 heads do not divide the
    'model' axis of 16, so the sequence is split over it (2 batch rows and
    2,048 query rows a device, against all 32,768 keys). By hand, per
    device and layer: the q, k, v and out products and the FFN's gate and
    up on the device's 4,096 tokens, its down product on the 65,536 tokens
    of its batch rows (DTensor gathers the ff-split hidden: each rank runs
    it whole), the two attention products over every key; the LM head on
    the last position. The peak is the arguments and the larger of two
    moments: in an attention chunk, two f32 score tensors (512 rows x
    32,768 keys x 12 heads x 2 rows; each let go as the next is made) and
    its boolean mask, the f32 copies of the gathered K and V and the two
    caches; in the FFN, the hidden of the batch rows' 65,536 tokens three
    times (DTensor's gather: its buffer, its result, their concatenation)
    and the local gate and up products."""
    cell = dryrun.run_cell("qwen2-1.5b", "prefill_32k", False, verbose=False)
    assert cell["status"] == "ok", cell.get("traceback")
    cfg = REGISTRY["qwen2-1.5b"]
    d, H, KV, hd, f, L, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
                             cfg.n_layers, cfg.padded_vocab)
    S, B = 32768, 2
    Sl, T = S // 16, B * S // 16
    layer = (2 * 2 * T * d * H * hd + 2 * 2 * T * d * KV * hd + 2 * 2 * T * d * f
             + 2 * B * S * f * d + 2 * 2 * B * Sl * S * H * hd)
    flops = L * layer + 2 * B * d * V
    got = cell["cost_analysis"]["flops"]
    assert abs(got - flops) <= 0.05 * flops, (got, flops)
    assert got <= 8.5e13
    mem = cell["memory_analysis"]
    chunk = B * H * 512 * S * 4
    attn = 2 * chunk + chunk // 4 + 2 * B * S * KV * hd * 4 + 2 * L * B * Sl * KV * hd * 2
    ffn = 3 * B * S * f * 2 + 2 * T * f * 2
    peak = mem["argument_size_in_bytes"] + max(attn, ffn)
    assert mem["peak_memory_in_bytes"] < 10 * 2**30
    assert abs(mem["peak_memory_in_bytes"] - peak) <= 0.25 * peak, (mem, peak)
