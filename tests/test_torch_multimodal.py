"""Parity of the port's VLM (llama-3.2-vision-90b) and audio (hubert-xlarge)
families with the JAX package on the CPU.

The reduced VLM, with its cross-attention gates opened (they start at 0,
and tanh(0) hides the image path), and the reduced HuBERT encoder against
the reference's ``forward``, ``prefill`` (and, for the VLM, ``decode_step``)
on one numpy tree, in f32 (1e-4) and through the bf16 ``uint16`` bridge
(each tensor within 2e-2 in relative 2-norm); the VLM's decode against
its forward (2e-3); the reference's behaviour checks (images change the
VLM's output, a late frame changes HuBERT's early outputs); the templates
and segments against the reference's; the doubly stacked VLM tree through
the bridge; audio's refused decode step; and the CUDA-core flash kernel's
twin at HuBERT's head dim 80 against ``attention_ref`` and the Pallas
kernel in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import TOL, close, close_rel_l2, randn
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.kernels.flash_attention.ops import flash_mha as jax_flash_mha
from repro.kernels.flash_attention.ref import attention_ref
from repro.models import build_model as jax_build_model
from repro.models.attention import cross_attention as jax_cross_attention
from repro.models.layers import PT as JPT
from repro.models.model import plan_segments as jax_plan_segments
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import REGISTRY
from repro_torch.kernels.flash_attention.kernel import SIMT_TILE
from repro_torch.kernels.flash_attention.ref import flash_mha_ref, flash_mha_tiled
from repro_torch.models import attention as t_attn
from repro_torch.models import build_model
from repro_torch.models.layers import map_templates
from repro_torch.models.model import plan_segments
from test_torch_xlstm import bridged

VLM, AUDIO = "llama-3.2-vision-90b", "hubert-xlarge"
BF16_TOL = 2e-2
B, S, SMAX = 2, 20, 40


def open_gates(tree):
    """gate_attn = gate_ffn = 1 in every cross layer of a numpy tree."""
    for seg in tree["segments"]:
        for g in ("gate_attn", "gate_ffn"):
            seg["cross"][g] = np.ones_like(seg["cross"][g])


def _check(dtype):
    if dtype == "f32":
        return lambda a, b: close(a, b, TOL["model_f32"])
    return lambda a, b: close_rel_l2(a, b, BF16_TOL)


def _inputs(arch, seed=1):
    cfg = REGISTRY[arch].reduced()
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frames": rng.standard_normal((B, S, cfg.d_model), np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S + 2), dtype=np.int32),
            "images": rng.standard_normal((B, cfg.n_image_tokens, cfg.d_model), np.float32)}


def _torch_batch(batch, S_=None):
    out = {}
    for k, a in batch.items():
        t = torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)
        out[k] = t[:, :S_] if k == "tokens" and S_ else t
    return out


def _jax_batch(batch, S_=None):
    return {k: jnp.asarray(a[:, :S_] if k == "tokens" and S_ else a) for k, a in batch.items()}


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_segments_and_template_follow_the_reference(arch):
    for cfg, jcfg in ((REGISTRY[arch], JAX_REGISTRY[arch]),
                      (REGISTRY[arch].reduced(), JAX_REGISTRY[arch].reduced())):
        segs = plan_segments(cfg)
        assert [(s.kind, s.n, s.scanned, s.causal, s.inner) for s in segs] == \
            [(s.kind, s.n, s.scanned, s.causal, s.inner) for s in jax_plan_segments(jcfg)]
        model, jmodel = build_model(cfg), jax_build_model(jcfg)
        for mine, ref in ((model.template(), jmodel.template()),
                          (model.cache_template(2, 8), jmodel.cache_template(2, 8))):
            flat = []
            map_templates(lambda t: flat.append((t.shape, t.init, t.fan_in, t.dtype)),
                          mine["segments"] if "pos" in ref else mine)
            want = [(t.shape, t.init, t.fan_in, t.dtype) for t in jax.tree_util.tree_leaves(
                ref["segments"] if "pos" in ref else ref,
                is_leaf=lambda t: isinstance(t, JPT))]
            assert flat == want
    grp = build_model(REGISTRY[VLM]).template()["segments"][0]
    assert grp["self"]["wq"].shape == (20, 4, 8192, 64, 128)
    assert grp["cross"]["gate_attn"].shape == (20,)
    assert "in_norm" in build_model(REGISTRY[AUDIO]).template()


# -- the reduced models against JAX --------------------------------------------------

@pytest.fixture(scope="module")
def vlm():
    return bridged(VLM, edit=open_gates)


@pytest.fixture(scope="module")
def hubert():
    return bridged(AUDIO)


def _compare_caches(cache, jcache, check):
    assert cache["pos"] == int(jcache["pos"])
    got = jax.tree_util.tree_leaves(cache["segments"])
    want = jax.tree_util.tree_leaves(jcache["segments"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        check(g, w)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_vlm_forward_prefill_decode_match_jax(vlm, dtype):
    jcfg, jmodel, jparams, model, params = (vlm if dtype == "f32"
                                            else bridged(VLM, dtype="bf16", edit=open_gates))
    check = _check(dtype)
    batch = _inputs(VLM)
    toks = batch["tokens"]
    jprefill = jax.jit(lambda p, b: jmodel.prefill(p, b, SMAX))
    jdecode = jax.jit(jmodel.decode_step)
    with torch.inference_mode():
        h = model.forward(params, _torch_batch(batch, S))
        check(h, jax.jit(lambda p, b: jmodel.forward(p, b, for_train=False))(
            jparams, _jax_batch(batch, S)))
        lg, cache = model.prefill(params, _torch_batch(batch, S), SMAX)
        jlg, jcache = jprefill(jparams, _jax_batch(batch, S))
        check(lg, jlg)
        _compare_caches(cache, jcache, check)
        grp = cache["segments"][0]
        assert grp["self"]["k"].shape == (2, 4, B, SMAX, 2, 16)
        assert grp["cross"]["k"].shape == (2, B, 16, 2, 16)
        for n in (S, S + 1):
            lg, cache = model.decode_step(params, cache, torch.from_numpy(
                toks[:, n:n + 1].astype(np.int64)))
            jlg, jcache = jdecode(jparams, jcache, jnp.asarray(toks[:, n:n + 1]))
            check(lg, jlg)
        _compare_caches(cache, jcache, check)


def test_vlm_port_decode_matches_forward(vlm):
    """Prefill + 2 decode steps == the port's own forward logits (the check
    of tests/test_models_smoke.py::test_decode_matches_forward)."""
    _, _, _, model, params = vlm
    batch = _torch_batch(_inputs(VLM, 3))
    toks = batch["tokens"]
    with torch.inference_mode():
        lg, cache = model.prefill(params, {"tokens": toks[:, :S], "images": batch["images"]},
                                  SMAX)
        got = [lg]
        for n in (S, S + 1):
            lg, cache = model.decode_step(params, cache, toks[:, n:n + 1])
            got.append(lg)
        for lg, n in zip(got, (S, S + 1, S + 2)):
            h = model.forward(params, {"tokens": toks[:, :n], "images": batch["images"]})
            close(lg, model._logits(params, h[:, -1]), TOL["decode_vs_forward"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_hubert_forward_prefill_match_jax(hubert, dtype):
    jcfg, jmodel, jparams, model, params = hubert if dtype == "f32" else bridged(AUDIO,
                                                                                 dtype="bf16")
    check = _check(dtype)
    batch = _inputs(AUDIO)
    with torch.inference_mode():
        h = model.forward(params, _torch_batch(batch))
        assert h.shape == (B, S, jcfg.d_model)
        check(h, jax.jit(lambda p, b: jmodel.forward(p, b, for_train=False))(
            jparams, _jax_batch(batch)))
        lg, cache = model.prefill(params, _torch_batch(batch), SMAX)
        jlg, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, SMAX))(jparams,
                                                                       _jax_batch(batch))
        assert lg.shape == (B, jcfg.padded_vocab)
        check(lg, jlg)
        _compare_caches(cache, jcache, check)


def test_hubert_decode_step_is_refused(hubert):
    _, _, _, model, params = hubert
    with torch.inference_mode():
        _, cache = model.prefill(params, _torch_batch(_inputs(AUDIO)), SMAX)
        with pytest.raises(ValueError, match="encoder"):
            model.decode_step(params, cache, torch.zeros((B, 1), dtype=torch.int64))


# -- the reference's behaviour checks --------------------------------------------------

def test_vlm_needs_images(vlm):
    """tests/test_models_smoke.py::test_vlm_needs_images on the port: with
    the gates open, images + 1.0 change the output; with them shut (their
    init), the image path adds exactly 0."""
    _, _, _, model, params = vlm
    batch = _torch_batch(_inputs(VLM, 4), S)
    moved = dict(batch, images=batch["images"] + 1.0)
    with torch.inference_mode():
        delta = (model.forward(params, batch) - model.forward(params, moved)).abs().max()
        assert float(delta) > 1e-3
        shut = {k: v for k, v in params.items()}
        shut["segments"] = [dict(g, cross=dict(g["cross"],
                                               gate_attn=torch.zeros_like(g["cross"]["gate_attn"]),
                                               gate_ffn=torch.zeros_like(g["cross"]["gate_ffn"])))
                            for g in params["segments"]]
        assert torch.equal(model.forward(shut, batch), model.forward(shut, moved))


def test_encoder_bidirectional(hubert):
    """tests/test_models_smoke.py::test_encoder_bidirectional on the port:
    a late frame changes the first outputs."""
    _, _, _, model, params = hubert
    batch = _torch_batch(_inputs(AUDIO, 5))
    frames = batch["frames"].clone()
    frames[:, -1] += 10.0
    with torch.inference_mode():
        h1 = model.forward(params, batch)
        h2 = model.forward(params, {"frames": frames})
    assert float((h1 - h2)[:, :4].abs().max()) > 1e-4


# -- the bridge ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_doubly_stacked_vlm_tree_round_trips_through_the_bridge(dtype):
    model = build_model(REGISTRY[VLM].reduced())
    rng = np.random.default_rng(8)
    tree = map_templates(lambda t: rng.standard_normal(t.shape).astype(np.float32),
                         model.template())
    if dtype == "bf16":
        tree = jax.tree_util.tree_map(
            lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)).view(np.uint16), tree)
    params = params_from_numpy(model, tree)
    grp = params["segments"][0]
    assert grp["self"]["wq"].shape == (2, 4, 64, 4, 16)
    assert grp["cross"]["wk"].shape == (2, 64, 2, 16)
    assert grp["self"]["wq"].dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    back = params_to_numpy(params)
    want = jax.tree_util.tree_leaves(tree)
    got = jax.tree_util.tree_leaves(back)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# -- cross attention and the head-dim-80 flash twin --------------------------------------

@pytest.mark.parametrize("Sq", [1, 37])
def test_cross_attention_matches_jax(Sq):
    q, k, v = randn(90, (2, Sq, 8, 16)), randn(91, (2, 40, 2, 16)), randn(92, (2, 40, 2, 16))
    got = t_attn.cross_attention(*map(torch.from_numpy, (q, k, v)))
    close(got, jax_cross_attention(*map(jnp.asarray, (q, k, v))), TOL["flash_f32"])


_SIMT = dict(block_q=SIMT_TILE, block_k=SIMT_TILE, tensor_cores=False)


@pytest.mark.parametrize("B,Sq,Sk,H,KV", [
    (1, 150, 150, 4, 4),     # HuBERT's MHA, ragged q and k tails
    (2, 77, 300, 4, 2),      # Sq != Sk, GQA
    (1, 300, 77, 2, 1),      # Sq > Sk, MQA
    (1, 1, 65, 4, 4),        # one row, one key past a tile
])
def test_simt_twin_at_hd80_vs_attention_ref(B, Sq, Sk, H, KV):
    q, k, v = randn(95, (B, Sq, H, 80)), randn(96, (B, Sk, KV, 80)), randn(97, (B, Sk, KV, 80))
    got = flash_mha_tiled(*map(torch.from_numpy, (q, k, v)), causal=False, **_SIMT)
    assert got.shape == (B, Sq, H, 80)
    fold = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3).reshape(-1, a.shape[1], 80)
    want = attention_ref(fold(q), fold(k), fold(v), n_q_heads_per_kv=H // KV, causal=False)
    want = np.asarray(want).reshape(B, H, Sq, 80).transpose(0, 2, 1, 3)
    close(got, want, TOL["flash_f32"])
    close(got, flash_mha_ref(*map(torch.from_numpy, (q, k, v)), causal=False),
          TOL["flash_f32"])


@pytest.mark.parametrize("causal", [False, True])
def test_simt_twin_at_hd80_vs_pallas(causal):
    """S a multiple of the Pallas blocks (its ragged k tail leaks)."""
    q, k, v = randn(98, (1, 256, 4, 80)), randn(99, (1, 256, 2, 80)), randn(100, (1, 256, 2, 80))
    got = flash_mha_tiled(*map(torch.from_numpy, (q, k, v)), causal=causal, **_SIMT)
    close(got, jax_flash_mha(*map(jnp.asarray, (q, k, v)), causal=causal), TOL["flash_f32"])
