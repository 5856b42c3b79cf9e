"""Parity of the port's training stack with the JAX package on the CPU.

One ``make_train_step`` step of each package from the same f32 parameters
(drawn with numpy along the port's template, bridged into both) on the same
batch (``SyntheticData`` of either package: the same numpy draws), for four
reduced dense configs: smollm-135m, qwen2-1.5b (QKV bias, tied head),
qwen3-32b (qk-norm) and minicpm-2b (WSD, ``dim_model_base`` logit scale);
microbatches and EF compression on qwen2; the hybrid hymba-1.5b (the
ssm_scan backward, meta tokens, window and sinks), also under "save-attn";
qwen3-moe-30b-a3b (the MoE backward through the router's gates); xlstm-125m
(mLSTM and sLSTM cells); llama-3.2-vision-90b with its cross-attention
gates opened (the nested groups, remat of each self layer and of each
group); and hubert-xlarge (frames, non-causal attention, the untied head),
also at its own head dim 80.
Then the optimizer, schedules,
int8 quantization, data and checkpoints, each against the JAX package, and
the training CLI.

Tolerances: f32 parity differs only in the order of sums. Loss rel 1e-5,
grad norm rel 1e-4, AdamW moments 1e-5 of each leaf's max. One Adam step
moves an element by about +-lr * sign(g), so an element whose gradient sits
at rounding level may flip: new parameters at atol 2 lr, and their mean
absolute difference at most 1e-3 lr.
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

from repro.configs import REGISTRY as JAX_REGISTRY, SHAPES as JAX_SHAPES
from repro.models import build_model as jax_build_model
from repro.train import checkpoint as jax_ckpt
from repro.train import compress as jax_compress
from repro.train import optim as jax_optim
from repro.train.data import SyntheticData as JaxData
from repro.train.loop import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import REGISTRY, SHAPES
from repro_torch.models import build_model
from repro_torch.models.layers import map_templates
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compress, optim
from repro_torch.train.data import SyntheticData
from repro_torch.train.loop import init_state, make_train_step, schedule_for

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
B, S = 4, 16
PEAK_LR = 3e-4


def _numpy_params(model, seed: int):
    """f32 parameters drawn with numpy along the template: normal /
    sqrt(fan_in) for matrices, 1 + 0.1 normal for norms, 0.1 normal for
    biases, so every gradient path is exercised."""
    rng = np.random.default_rng(seed)

    def draw(t):
        z = rng.standard_normal(t.shape)
        if t.init == "ones":
            return (1.0 + 0.1 * z).astype(np.float32)
        if t.init == "zeros":
            return (0.1 * z).astype(np.float32)
        fan = t.fan_in or (t.shape[-2] if len(t.shape) >= 2 else t.shape[-1])
        scale = (0.1 if t.init == "small" else 1.0) / max(fan, 1) ** 0.5
        return (z * scale).astype(np.float32)

    return map_templates(draw, model.template())


def _state_from(model, tree, compress_on: bool):
    params = params_from_numpy(model, tree, device="cpu")
    state = {"params": params, "opt": optim.adamw_init(params)}
    if compress_on:
        state["ef"] = compress.ef_init(params)
    return state


def _jax_state(tree, compress_on: bool):
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = {"params": params, "opt": jax_optim.adamw_init(params)}
    if compress_on:
        state["ef"] = jax_compress.ef_init(params)
    return state


def _leaves(tree):
    return [np.asarray(x, np.float32) if not isinstance(x, torch.Tensor)
            else x.detach().float().numpy() for x in jax.tree_util.tree_leaves(
                params_to_numpy(tree) if _is_torch(tree) else tree)]


def _is_torch(tree):
    return isinstance(optim.tree_leaves(tree)[0], torch.Tensor)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


CASES = [("smollm-135m", 1, False), ("qwen2-1.5b", 1, False), ("qwen3-32b", 1, False),
         ("minicpm-2b", 1, False), ("qwen2-1.5b", 2, False), ("qwen2-1.5b", 1, True),
         ("qwen2-1.5b", 2, True), ("hymba-1.5b", 1, False), ("qwen3-moe-30b-a3b", 1, False),
         ("xlstm-125m", 1, False), ("llama-3.2-vision-90b", 1, False),
         ("hubert-xlarge", 1, False)]


@pytest.mark.parametrize("arch,microbatches,compress_on", CASES)
def test_train_step_matches_jax(arch, microbatches, compress_on):
    _step_matches_jax(arch, microbatches, compress_on)


def test_save_attn_hybrid_step_matches_jax():
    """hymba under "save-attn": the reference's policy saves the named
    attention output, which its hybrid block does not name, so both
    packages recompute the whole layer."""
    _step_matches_jax("hymba-1.5b", 1, False, remat_policy="save-attn")


def test_hubert_hd80_step_matches_jax():
    """hubert-xlarge narrowed to 4 heads of its own head dim 80 (d 320): the
    flash backward at hd 80 (the wrapper's plain path here; the kernel's
    algorithm is held in test_torch_kernels_bwd.py)."""
    assert dataclasses.replace(REGISTRY["hubert-xlarge"].reduced(), d_model=320).hd == 80
    _step_matches_jax("hubert-xlarge", 1, False, d_model=320)


def _step_matches_jax(arch, microbatches, compress_on, remat_policy="full", **changes):
    cfg = dataclasses.replace(REGISTRY[arch].reduced(), **changes)
    jcfg = dataclasses.replace(JAX_REGISTRY[arch].reduced(), **changes)
    assert cfg.hd == jcfg.hd
    model = build_model(cfg, remat_policy=remat_policy)
    jmodel = jax_build_model(jcfg, remat_policy=remat_policy)
    tree = _numpy_params(model, 0)
    if cfg.family == "vlm":
        # the gates start at 0 and tanh(0) would hide the image path
        for seg in tree["segments"]:
            for g in ("gate_attn", "gate_ffn"):
                seg["cross"][g] = np.ones_like(seg["cross"][g])
    kw = dict(microbatches=microbatches, compress=compress_on)
    # warmup 0: the first step runs at the peak rate, not at lr 0
    jstep = jax.jit(jax_make_train_step(
        jmodel, None, lr_schedule=jax_optim.cosine_schedule(PEAK_LR, 0, 100)
        if not arch.startswith("minicpm") else jax_optim.wsd_schedule(PEAK_LR, 0, 100), **kw))
    step = make_train_step(model, lr_schedule=schedule_for(cfg, PEAK_LR, 0, 100), **kw)
    jbatch = JaxData(jcfg, JAX_SHAPES["train_4k"], seed=5, batch_override=B,
                     seq_override=S).batch_at(3)
    batch = SyntheticData(cfg, SHAPES["train_4k"], seed=5, batch_override=B,
                          seq_override=S, device="cpu").batch_at(3)

    jstate, jm = jstep(_jax_state(tree, compress_on), jbatch)
    state, m = step(_state_from(model, tree, compress_on), batch)

    assert _rel(m["loss"], jm["loss"]) <= 1e-5
    assert _rel(m["grad_norm"], jm["grad_norm"]) <= 1e-4
    assert _rel(m["lr"], jm["lr"]) <= 1e-7 and float(m["lr"]) == pytest.approx(PEAK_LR)
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 1
    n_elems = flips = 0
    ef_pairs = (zip(_leaves(state["ef"]), _leaves(jstate["ef"])) if compress_on
                else [(None, None)] * len(_leaves(state["params"])))
    for got_m, want_m, got_v, want_v, (ge, we) in zip(
            _leaves(state["opt"]["m"]), _leaves(jstate["opt"]["m"]),
            _leaves(state["opt"]["v"]), _leaves(jstate["opt"]["v"]), ef_pairs):
        n_elems += got_m.size
        tied = np.zeros(got_m.shape, bool)
        if compress_on:
            # a compressed gradient that sits on a rounding tie may take the
            # next int8 code in one package: its EF residual then differs by
            # that quantum, and m by (1 - b1) times it, the other way.
            # Elsewhere the residuals differ by rounding (~1e-5 of a quantum)
            d_ef = ge - we
            tied = np.abs(d_ef) > 1e-3 * max(np.abs(we).max(), 1e-30)
            flips += int(tied.sum())
            np.testing.assert_allclose((got_m - want_m)[tied], -0.1 * d_ef[tied],
                                       rtol=1e-3, atol=1e-5 * np.abs(want_m).max())
        for got, want in ((got_m, want_m), (got_v, want_v)):
            bad = np.abs(got - want) > 1e-5 * max(np.abs(want).max(), 1e-30)
            assert not (bad & ~tied).any(), f"moments differ at {int(bad.sum())} elements"
    assert flips <= 1e-4 * n_elems
    lr = PEAK_LR
    diffs = [np.abs(a - b) for a, b in zip(_leaves(state["params"]),
                                           _leaves(jstate["params"]))]
    assert max(d.max() for d in diffs) <= 2 * lr
    assert np.concatenate([d.ravel() for d in diffs]).mean() <= 1e-3 * lr


@pytest.mark.parametrize("policy", [None, "save-attn"])
def test_remat_policies_give_the_same_loss_and_grads(policy):
    """remat off, "full" and "save-attn": the same function, differentiated
    with and without recomputation (qwen3: qk-norm inside the cut)."""
    cfg = REGISTRY["qwen3-32b"].reduced()
    tree = _numpy_params(build_model(cfg), 1)
    batch = SyntheticData(cfg, SHAPES["train_4k"], seed=2, batch_override=2,
                          seq_override=S, device="cpu").batch_at(0)

    def loss_and_grads(model):
        params = params_from_numpy(model, tree, device="cpu")
        leaves = optim.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = model.loss(params, batch)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    want_loss, want = loss_and_grads(build_model(cfg, remat=False))
    got_loss, got = loss_and_grads(build_model(cfg, remat=True, remat_policy=policy or "full"))
    assert got_loss == pytest.approx(want_loss, rel=1e-6, abs=1e-6)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_save_attn_on_a_block_without_a_cut_is_full_remat():
    """The hybrid block has no cut at its attention: "save-attn" runs it as
    "full", the same loss and gradients to 1e-6."""
    cfg = REGISTRY["hymba-1.5b"].reduced()
    tree = _numpy_params(build_model(cfg), 1)
    batch = SyntheticData(cfg, SHAPES["train_4k"], seed=2, batch_override=2,
                          seq_override=S, device="cpu").batch_at(0)

    def loss_and_grads(policy):
        model = build_model(cfg, remat=True, remat_policy=policy)
        params = params_from_numpy(model, tree, device="cpu")
        leaves = optim.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = model.loss(params, batch)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    want_loss, want = loss_and_grads("full")
    got_loss, got = loss_and_grads("save-attn")
    assert got_loss == pytest.approx(want_loss, rel=1e-6, abs=1e-6)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_adamw_converges_quadratic_parity():
    """The reference's quadratic, run by both packages from the same target:
    both converge, and the iterates agree."""
    target = np.random.default_rng(0).standard_normal((16, 16)).astype(np.float32)
    jp, jopt = {"w": jnp.zeros((16, 16))}, None
    jopt = jax_optim.adamw_init(jp)
    p = {"w": torch.zeros(16, 16)}
    opt = optim.adamw_init(p)
    tt = torch.from_numpy(target)
    jloss = lambda q: jnp.sum((q["w"] - target) ** 2)
    l0 = float(jloss(jp))
    for _ in range(200):
        jp, jopt = jax_optim.adamw_update(jp, jax.grad(jloss)(jp), jopt, jnp.asarray(0.05),
                                          weight_decay=0.0)
        optim.adamw_update(p, {"w": 2 * (p["w"] - tt)}, opt, torch.tensor(0.05),
                           weight_decay=0.0)
    final = float(((p["w"] - tt) ** 2).sum())
    assert final < 0.01 * l0 and float(jloss(jp)) < 0.01 * l0
    np.testing.assert_allclose(p["w"].numpy(), np.asarray(jp["w"]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["cosine", "wsd"])
def test_schedules_match_jax(kind):
    warmup, total = 100, 1000
    mine = getattr(optim, f"{kind}_schedule")(1e-3, warmup, total)
    ref = getattr(jax_optim, f"{kind}_schedule")(1e-3, warmup, total)
    for s in (0, 1, warmup, (warmup + total) // 2, total - 50, total):
        got = float(mine(torch.tensor(s, dtype=torch.int32)))
        want = float(ref(jnp.asarray(s, jnp.int32)))
        assert got == pytest.approx(want, rel=1e-7, abs=0.0), (kind, s)


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((7, 5)).astype(np.float32),
            "b": [rng.standard_normal(11).astype(np.float32) * 30]}
    ttree = {"a": torch.from_numpy(tree["a"]), "b": [torch.from_numpy(tree["b"][0])]}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    got, gn = optim.clip_by_global_norm(ttree, 1.0)
    want, wn = jax_optim.clip_by_global_norm(jtree, 1.0)
    assert float(gn) == pytest.approx(float(wn), rel=1e-6)
    np.testing.assert_allclose(got["b"][0].numpy(), np.asarray(want["b"][0]), rtol=1e-6)


def test_quantize_int8_matches_jax():
    rng = np.random.default_rng(6)
    x = np.concatenate([rng.standard_normal(1000) * 3,
                        np.arange(-127, 128, 0.5)]).astype(np.float32)  # ties: k + 0.5
    q, s = compress.quantize_int8(torch.from_numpy(x))
    jq, js = jax_compress.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert np.abs(q.numpy().astype(int) - np.asarray(jq).astype(int)).max() <= 1
    deq = compress.dequantize_int8(q, s, x.shape, torch.float32)
    jdeq = jax_compress.dequantize_int8(jq, js, x.shape, jnp.float32)
    np.testing.assert_allclose(deq.numpy(), np.asarray(jdeq), atol=float(s.max()))
    assert compress.compression_ratio(torch.bfloat16) == pytest.approx(
        jax_compress.compression_ratio(jnp.bfloat16))


def test_error_feedback_convergence():
    """EF-compressed SGD matches uncompressed convergence on a quadratic
    (the reference's test, on the port)."""
    target = torch.from_numpy(np.random.default_rng(1).standard_normal((64, 64))
                              .astype(np.float32))

    def run(compressed):
        p = {"w": torch.zeros(64, 64)}
        ef = compress.ef_init(p)
        for _ in range(60):
            g = {"w": p["w"] - target}
            if compressed:
                g, ef = compress.ef_compress_grads(g, ef)
            p = {"w": p["w"] - 0.1 * g["w"]}
        return float(0.5 * ((p["w"] - target) ** 2).sum())

    assert run(True) < 1.05 * run(False) + 1e-3


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "hymba-1.5b"])
def test_synthetic_data_is_bitwise_the_reference(arch):
    cfg, jcfg = REGISTRY[arch].reduced(), JAX_REGISTRY[arch].reduced()
    mine = SyntheticData(cfg, SHAPES["train_4k"], seed=7, batch_override=2,
                         seq_override=16, device="cpu")
    ref = JaxData(jcfg, JAX_SHAPES["train_4k"], seed=7, batch_override=2, seq_override=16)
    for step in (0, 41):
        got, want = mine.batch_at(step), ref.batch_at(step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for key in got:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert not torch.equal(mine.batch_at(41)["tokens"], mine.batch_at(42)["tokens"])


def _bf16_state(model, seed):
    """A bf16 state with non-zero moments and step, built from numpy."""
    tree = _numpy_params(model, seed)
    params = params_from_numpy(model, jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)).view(np.uint16), tree),
        device="cpu")
    opt = optim.adamw_init(params)
    opt["m"] = optim.tree_map(lambda p: p.float() * 0.5, params)
    opt["step"] = torch.tensor(7, dtype=torch.int32)
    return {"params": params, "opt": opt}


def test_checkpoints_restore_across_packages(tmp_path):
    """A JAX checkpoint restores into the port and the port's into JAX,
    every leaf bitwise equal, bf16 included."""
    cfg, jcfg = REGISTRY["qwen2-1.5b"].reduced(), JAX_REGISTRY["qwen2-1.5b"].reduced()
    model = build_model(cfg)
    state = _bf16_state(model, 3)
    jstate = jax.tree_util.tree_map(
        lambda t: jnp.asarray(np.asarray(t.view(torch.int16).numpy().view(np.uint16))
                              .view(jnp.bfloat16)) if t.dtype == torch.bfloat16
        else jnp.asarray(t.numpy()), state)

    ckpt.save_checkpoint(str(tmp_path / "port"), 12, state, data_cursor=12,
                         meta={"arch": cfg.name})
    restored, cursor, meta = jax_ckpt.restore_checkpoint(str(tmp_path / "port"), 12, jstate)
    assert cursor == 12 and meta == {"arch": cfg.name}
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), 9, jstate, data_cursor=9)
    back, cursor2, _ = ckpt.restore_checkpoint(str(tmp_path / "jax"), 9, state)
    assert cursor2 == 9
    for a, b, c in zip(jax.tree_util.tree_leaves(jstate), jax.tree_util.tree_leaves(restored),
                       optim.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        want = np.atleast_1d(np.asarray(a))
        np.testing.assert_array_equal(np.atleast_1d(np.asarray(b)).view(np.uint8),
                                      want.view(np.uint8))
        got = c.view(torch.int16).numpy() if c.dtype == torch.bfloat16 else c.numpy()
        assert got.shape == np.shape(a)
        np.testing.assert_array_equal(np.atleast_1d(got).view(np.uint8), want.view(np.uint8))
    with open(tmp_path / "port" / "step_00000012" / "index.json") as f:
        index = json.load(f)
    assert index["leaves"]["params/segments/0/wq"]["dtype"] == "bfloat16"
    assert index["leaves"]["opt/step"]["dtype"] == "int32"


def test_checkpoint_manager_gc(tmp_path):
    model = build_model(REGISTRY["smollm-135m"].reduced())
    state = _bf16_state(model, 0)
    d = str(tmp_path / "ckpt")
    mgr = ckpt.CheckpointManager(d, save_every=10, keep=2)
    assert not mgr.maybe_save(15, state)
    for s in (30, 40, 50):
        assert mgr.maybe_save(s, state, data_cursor=s)
    mgr.wait()
    assert sorted(n for n in os.listdir(d)) == ["step_00000040", "step_00000050"]
    assert ckpt.latest_step(d) == 50
    restored, cursor, _ = ckpt.restore_checkpoint(d, 50, state)
    assert cursor == 50
    for a, b in zip(optim.tree_leaves(state), optim.tree_leaves(restored)):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_restart_resumes_bit_identical(tmp_path):
    """Kill after step 3, restore from the checkpoint, continue: the same
    losses and final parameters bit for bit as the run that never stopped."""
    cfg = REGISTRY["smollm-135m"].reduced()
    model = build_model(cfg)
    data = SyntheticData(cfg, SHAPES["train_4k"], seed=3, batch_override=2, seq_override=16,
                         device="cpu")
    step_fn = make_train_step(model)

    def fresh():
        return init_state(model, torch.Generator().manual_seed(0), dtype=torch.float32,
                          device="cpu")

    def run(state, start, stop):
        losses = []
        for s in range(start, stop):
            state, m = step_fn(state, data.batch_at(s))
            losses.append(float(m["loss"]))
        return state, losses

    straight, all_losses = run(fresh(), 0, 6)
    state3, part1 = run(fresh(), 0, 3)
    ckpt.save_checkpoint(str(tmp_path), 3, state3, data_cursor=3)
    resumed, cursor, _ = ckpt.restore_checkpoint(str(tmp_path), 3, fresh())
    final, part2 = run(resumed, cursor, 6)
    assert all_losses == part1 + part2
    for a, b in zip(optim.tree_leaves(straight), optim.tree_leaves(final)):
        assert torch.equal(a, b)


def test_train_cli_runs_and_resumes(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--reduced", "--device", "cpu",
           "--arch", "smollm-135m", "--batch", "2", "--seq", "16",
           "--ckpt-dir", str(tmp_path), "--save-every", "2"]
    r = subprocess.run(cmd + ["--steps", "3"], capture_output=True, text=True, env=env,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert "steps 0->3" in r.stdout and "step     2" in r.stdout
    assert sorted(os.listdir(tmp_path)) == ["step_00000002"]
    r = subprocess.run(cmd + ["--steps", "5"], capture_output=True, text=True, env=env,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert "[resume] restored step 2, data cursor 2" in r.stdout
    assert "steps 2->5" in r.stdout and "step     4" in r.stdout
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000004"]


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-moe-30b-a3b"])
def test_train_layers_cuts_the_depth(arch):
    """``train(..., layers=N)`` trains the arch at its width with N layers:
    every stacked layer leaf has N rows and the same shape otherwise."""
    from repro_torch.launch.train import train

    full, _ = train(arch, steps=1, batch=2, seq=16, reduced=True, device="cpu", log_every=1)
    cut, history = train(arch, steps=1, batch=2, seq=16, reduced=True, layers=2,
                         device="cpu", log_every=1)
    assert np.isfinite(history[0]["loss"])
    for seg_full, seg_cut in zip(full["params"]["segments"], cut["params"]["segments"]):
        assert sorted(seg_full) == sorted(seg_cut)
        for name in seg_full:
            assert seg_full[name].shape[0] == 4, name
            assert seg_cut[name].shape == (2,) + seg_full[name].shape[1:], name
    assert cut["params"]["embed"].shape == full["params"]["embed"].shape


def _ef_step_state(grads, quantize=compress.quantize_int8):
    """The moments and EF residuals one AdamW step from zero leaves after
    EF int8 compression of ``grads`` (``quantize``: the per-block coder)."""
    ef = compress.ef_init(grads)
    deq = optim.tree_map(lambda g: compress.dequantize_int8(*quantize(g), g.shape,
                                                            torch.float32), grads)
    params = optim.tree_map(torch.zeros_like, grads)
    opt = optim.adamw_init(params)
    optim.adamw_update(params, deq, opt, torch.tensor(1e-3))
    return {"opt": opt, "ef": optim.tree_map(lambda g, d, e: g + e - d, grads, deq, ef)}


def _coarse_int8(x):
    """A wrong coder: the block's scale from 0.8 of its max, codes clipped."""
    q, scale = compress.quantize_int8(x)
    blocks = q.float() * scale[:, None]
    scale = scale * 0.8
    return torch.clamp(torch.round(blocks / scale[:, None]), -127, 127).to(torch.int8), scale


@pytest.mark.parametrize("case", ["rounding", "wrong_gradient", "wrong_scale"])
def test_ef_code_check_of_the_card_step(case):
    """chip_smoke.py's check of the EF int8 codes in its kernels-vs-plain
    step: a gradient moved by rounding alone keeps every code within one of
    the plain step's and few of them different; a gradient 10% off on half
    its columns moves codes by more than one; a coder with a wrong block
    scale leaves residuals beyond half a code step."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    gen = torch.Generator().manual_seed(0)
    grads = {"w": torch.randn(300, 17, generator=gen) * torch.rand(300, 1, generator=gen) ** 4,
             "b": [torch.randn(1000, generator=gen) * 1e-3, torch.zeros(600)]}
    plain = _ef_step_state(grads)
    moved = {"rounding": lambda g: g * (1 + 1e-6 * torch.randn(g.shape, generator=gen)),
             "wrong_gradient": lambda g: g * (1 + 0.1 * (torch.arange(17) % 2)),
             "wrong_scale": lambda g: g}[case]
    got = _ef_step_state({"w": moved(grads["w"]), "b": grads["b"]},
                         _coarse_int8 if case == "wrong_scale" else compress.quantize_int8)
    cd = chip_smoke.ef_code_diffs(torch, plain, got)
    assert cd["held"] == 300 * 17 + 1000, cd
    assert cd["off"] <= chip_smoke.EF_CODE_OFF, cd
    if case == "rounding":
        assert cd["most"] <= 1 and cd["flips"] <= chip_smoke.EF_FLIP_SHARE * cd["held"], cd
        assert cd["resid"] <= 1 + chip_smoke.EF_CODE_OFF, cd
    elif case == "wrong_gradient":
        assert cd["most"] > 1, cd
    else:
        assert cd["resid"] > 1 + chip_smoke.EF_CODE_OFF, cd
