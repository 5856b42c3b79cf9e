"""Parity of the port's MoE family with the JAX package on the CPU.

``router_topk`` in f32 and, with equal logits at the k-th place, in bf16
and f32: the same expert ids (the lower id first among ties, as
``jax.lax.top_k`` orders them), gates and probabilities at 1e-6. The
bf16 cases build their router logits from values that every sum order
computes exactly, so both packages round the same logits. ``moe_dense``
and ``moe_onehot`` (with and without capacity drops) at f32 1e-5 and bf16
2e-2. The reduced qwen3-moe-30b-a3b (qk-norm, 8 experts, top 2) and
phi3.5-moe-42b-a6.6b (no qk-norm, GQA 4 / 2) forward, prefill and decode
at the tolerances of ``test_torch_model.py``, the port's decode against its
own forward, and the ServeEngine's greedy tokens. ``init_params`` keeps the
values of one draw per leaf for the dense and hybrid configs, and draws a
leaf above its size limit one slice at a time; the bridge carries the
expert leaves and their bf16 bits across packages.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import TOL, close
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import REGISTRY
from repro_torch.models import build_model
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe
from repro_torch.models.layers import PT, init_params, map_templates
from repro_torch.serve import ServeEngine

ARCHS = ["qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b"]
B, S, SMAX = 2, 20, 40
_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
_MOE_TOL = {"f32": 1e-5, "bf16": 2e-2}


def _exact_router(seed, T, d, E):
    """x [T,d] and w [d,E] whose products and sums are exact in f32 and whose
    logits are exact in bf16 (multiples of 1/8 below 16 in magnitude): every
    sum order gives the same logits, and equal logits are frequent."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-1, 2, (T, d)) * 0.5).astype(np.float32)
    x[:d] = np.eye(d, dtype=np.float32)[:T]          # some tokens read one row of w
    w = (rng.integers(-4, 4, (d, E)) * 0.25).astype(np.float32)
    return x, w


def _experts(seed, E, d, f):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((E, d, f)) / d ** 0.5).astype(np.float32),
            (rng.standard_normal((E, d, f)) / d ** 0.5).astype(np.float32),
            (rng.standard_normal((E, f, d)) / f ** 0.5).astype(np.float32))


def _both(arrays, dt):
    return ([jnp.asarray(a, _JDT[dt]) for a in arrays],
            [torch.from_numpy(a).to(_TDT[dt]) for a in arrays])


def test_router_topk_matches_jax_f32():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 32)).astype(np.float32)
    w = rng.standard_normal((32, 16)).astype(np.float32)
    gates, ids, probs = t_moe.router_topk(torch.from_numpy(x), torch.from_numpy(w), 4)
    jg, ji, jp = jax_moe.router_topk(jnp.asarray(x), jnp.asarray(w), 4)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    close(gates, jg, 1e-6)
    close(probs, jp, 1e-6)


@pytest.mark.parametrize("E,k", [(8, 2), (128, 8)])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_router_topk_breaks_ties_as_jax(E, k, dt):
    x, w = _exact_router(1, 64, 16, E)
    (jx, jw), (tx, tw) = _both((x, w), dt)
    gates, ids, probs = t_moe.router_topk(tx, tw, k)
    jg, ji, jp = jax_moe.router_topk(jx, jw, k)
    p = probs.numpy()
    kth = np.sort(p, axis=-1)[:, ::-1][:, k - 1:k + 1]
    tied = kth[:, 0] == kth[:, 1]
    assert tied.sum() >= 8, "the data must put equal logits at the k-th place"
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    close(gates, jg, 1e-6)
    close(probs, jp, 1e-6)
    # among equal probabilities the lower expert id comes first
    chosen = np.take_along_axis(p, ids.numpy(), -1)
    same = chosen[:, 1:] == chosen[:, :-1]
    assert (np.diff(ids.numpy(), axis=-1)[same] > 0).all()


def test_router_topk_takes_the_lower_index_of_a_tie():
    """The case of ROADMAP §3: JAX picks ids [1, 2] of [0.5, 1, 1, 0.2, 1]."""
    logits = np.array([[0.5, 1.0, 1.0, 0.2, 1.0]], np.float32)
    x, w = np.eye(1, dtype=np.float32), logits
    _, ids, _ = t_moe.router_topk(torch.from_numpy(x), torch.from_numpy(w), 2)
    _, ji, _ = jax_moe.router_topk(jnp.asarray(x), jnp.asarray(w), 2)
    assert ids.tolist() == np.asarray(ji).tolist() == [[1, 2]]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_moe_dense_matches_jax(dt):
    E, d, f, k = 8, 16, 32, 2
    x, w = _exact_router(2, 48, d, E)
    (jx, jw, *jexp), (tx, tw, *texp) = _both((x, w) + _experts(3, E, d, f), dt)
    got = t_moe.moe_dense(tx, tw, *texp, k=k)
    assert got.dtype == _TDT[dt] and got.shape == (48, d)
    close(got, jax_moe.moe_dense(jx, jw, *jexp, k=k), _MOE_TOL[dt])


@pytest.mark.parametrize("capacity_factor", [1.0, 8.0])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_moe_onehot_matches_jax(capacity_factor, dt):
    E, d, f, k, T = 8, 16, 32, 2, 48
    x, w = _exact_router(4, T, d, E)
    (jx, jw, *jexp), (tx, tw, *texp) = _both((x, w) + _experts(5, E, d, f), dt)
    kw = dict(k=k, n_experts=E, capacity_factor=capacity_factor)
    got = t_moe.moe_onehot(tx, tw, *texp, **kw)
    close(got, jax_moe.moe_onehot(jx, jw, *jexp, **kw), _MOE_TOL[dt])
    _, ids, _ = t_moe.router_topk(tx, tw, k)
    cap = max(4, -(-(T * k * capacity_factor) // E))
    over = int(torch.bincount(ids.reshape(-1), minlength=E).max()) > cap
    dense = t_moe.moe_dense(tx, tw, *texp, k=k)
    if capacity_factor == 1.0:
        # tokens past an expert's capacity are dropped: not the dense oracle
        assert over and not torch.allclose(got.float(), dense.float(), atol=1e-3)
    else:
        assert not over
        close(got, dense, _MOE_TOL[dt])


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_builds_and_follows_the_reference_template(arch):
    """Full width and reduced: the port builds the MoE family (it refused it
    before), with the reference's segments and leaf paths, shapes and init
    laws."""
    from repro.models.layers import PT as JPT
    from repro.models.model import plan_segments as jax_plan_segments
    from repro_torch.models.model import plan_segments

    for cfg, jcfg in ((REGISTRY[arch], JAX_REGISTRY[arch]),
                      (REGISTRY[arch].reduced(), JAX_REGISTRY[arch].reduced())):
        assert [(g.kind, g.n, g.scanned, g.window) for g in plan_segments(cfg)] == \
            [(g.kind, g.n, g.scanned, g.window) for g in jax_plan_segments(jcfg)]
        mine = build_model(cfg).template()
        ref = jax_build_model(jcfg).template()
        flat = []
        map_templates(lambda t: flat.append((t.shape, t.init, t.fan_in)), mine)
        want = [(t.shape, t.init, t.fan_in) for t in jax.tree_util.tree_leaves(
            ref, is_leaf=lambda t: isinstance(t, JPT))]
        assert flat == want
        assert mine["segments"][0]["we_down"].shape == (
            cfg.n_layers, cfg.n_experts, cfg.d_ff, cfg.d_model)


def _setup(arch):
    jcfg = JAX_REGISTRY[arch].reduced()
    jmodel = jax_build_model(jcfg, remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.float32)
    model = build_model(REGISTRY[arch].reduced())
    params = params_from_numpy(model, jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S + 2),
                                             dtype=np.int32)
    return jmodel, jparams, model, params, toks


def _t(toks):
    return torch.from_numpy(toks.astype(np.int64))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_prefill_decode_match_jax(arch):
    jmodel, jparams, model, params, toks = _setup(arch)
    assert set(params["segments"][0]) >= {"router", "we_gate", "we_up", "we_down"}
    tol = TOL["model_f32"]
    jforward = jax.jit(lambda p, t: jmodel.forward(p, {"tokens": t}, for_train=False))
    jprefill = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, SMAX))
    jdecode = jax.jit(jmodel.decode_step)
    with torch.inference_mode():
        h = model.forward(params, {"tokens": _t(toks[:, :S])})
        close(h, jforward(jparams, jnp.asarray(toks[:, :S])), tol)
        lg, cache = model.prefill(params, {"tokens": _t(toks[:, :S])}, SMAX)
        jlg, jcache = jprefill(jparams, jnp.asarray(toks[:, :S]))
        close(lg, jlg, tol)
        for key in ("k", "v"):
            close(cache["segments"][0][key], jcache["segments"][0][key], tol)
        for n in (S, S + 1):
            lg, cache = model.decode_step(params, cache, _t(toks[:, n:n + 1]))
            jlg, jcache = jdecode(jparams, jcache, jnp.asarray(toks[:, n:n + 1]))
            close(lg, jlg, tol)
        assert cache["pos"] == int(jcache["pos"]) == S + 2


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_port_decode_matches_forward(arch):
    """Prefill + 2 decode steps == the port's own forward logits (the check
    of tests/test_models_smoke.py::test_decode_matches_forward)."""
    _, _, model, params, toks = _setup(arch)
    with torch.inference_mode():
        lg, cache = model.prefill(params, {"tokens": _t(toks[:, :S])}, SMAX)
        got = [lg]
        for n in (S, S + 1):
            lg, cache = model.decode_step(params, cache, _t(toks[:, n:n + 1]))
            got.append(lg)
        for lg, n in zip(got, (S, S + 1, S + 2)):
            h = model.forward(params, {"tokens": _t(toks[:, :n])})
            close(lg, model._logits(params, h[:, -1]), TOL["decode_vs_forward"])


def test_moe_serve_engine_same_tokens():
    jmodel, jparams, model, params, _ = _setup("qwen3-moe-30b-a3b")
    jeng = JaxServeEngine(jmodel, jparams, smax=SMAX)
    eng = ServeEngine(model, params, smax=SMAX)
    rng = np.random.default_rng(7)
    for n in (5, 12, 9, 3):
        prompt = rng.integers(0, 256, n).astype(np.int32)
        assert jeng.submit(prompt, 6, None) == eng.submit(prompt, 6, None)
    want = jeng.run(batch_size=2)
    got = eng.run(batch_size=2)
    assert got == want and sorted(got) == [1, 2, 3, 4]
    assert all(len(v) == 6 for v in got.values())


def test_moe_bf16_params_cross_the_bridge_bit_for_bit():
    jcfg = JAX_REGISTRY["qwen3-moe-30b-a3b"].reduced()
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(3), jnp.bfloat16)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16 else np.asarray(a),
        jparams)
    params = params_from_numpy(build_model(REGISTRY["qwen3-moe-30b-a3b"].reduced()), tree)
    seg = params["segments"][0]
    assert seg["we_gate"].dtype == torch.bfloat16 and seg["we_gate"].shape == (4, 8, 64, 128)
    back = params_to_numpy(params)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _one_draw_per_leaf(template, generator, dtype):
    """init_params as it was before large leaves were sliced: one f32 draw
    per normal leaf, scaled, cast."""
    def make(t):
        dt = t.resolve_dtype(dtype)
        if t.init in ("zeros", "ones"):
            return (torch.zeros if t.init == "zeros" else torch.ones)(t.shape, dtype=dt)
        if t.init == "neg_inf":
            return torch.full(t.shape, -1e30, dtype=dt)
        fan = t.fan_in or (t.shape[-2] if len(t.shape) >= 2 else t.shape[-1])
        scale = (0.1 if t.init == "small" else 1.0) / max(fan, 1) ** 0.5
        return (torch.randn(t.shape, generator=generator, dtype=torch.float32)
                * scale).to(dt)
    return map_templates(make, template)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "hymba-1.5b", "smollm-135m"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_params_keeps_dense_and_hybrid_values(arch, dtype):
    model = build_model(REGISTRY[arch].reduced())
    got = model.init(torch.Generator().manual_seed(5), dtype, "cpu")
    want = _one_draw_per_leaf(model.template(), torch.Generator().manual_seed(5), dtype)
    for g, w in zip(jax.tree_util.tree_leaves(params_to_numpy(got)),
                    jax.tree_util.tree_leaves(params_to_numpy(want))):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch", ["smollm-135m", "minicpm-2b", "qwen2-1.5b", "hymba-1.5b"])
def test_full_width_dense_and_hybrid_leaves_take_one_draw(arch):
    """At full width (templates only, nothing allocated) every normal leaf of
    these configs lies at or below SLICED_DRAW_ELEMS, so init_params draws it
    whole and its values are those of one draw per leaf."""
    sizes = []
    map_templates(lambda t: sizes.append((math.prod(t.shape), t.init)),
                  build_model(REGISTRY[arch]).template())
    drawn = [n for n, init in sizes if init in ("normal", "small")]
    assert drawn and max(drawn) <= t_layers.SLICED_DRAW_ELEMS


def test_full_width_expert_leaves_are_drawn_in_slices():
    sizes = {}
    map_templates(lambda t: sizes.setdefault(t.shape, math.prod(t.shape)),
                  build_model(REGISTRY["qwen3-moe-30b-a3b"]).template())
    assert sizes[(48, 128, 2048, 768)] > t_layers.SLICED_DRAW_ELEMS


def test_init_params_draws_a_large_leaf_one_slice_at_a_time(monkeypatch):
    tmpl = {"a": PT((3, 5, 7), (None, None, None)), "b": PT((4, 6), (None, None), init="small")}
    monkeypatch.setattr(t_layers, "SLICED_DRAW_ELEMS", 50)
    got = init_params(tmpl, torch.Generator().manual_seed(0), torch.bfloat16, "cpu")
    gen = torch.Generator().manual_seed(0)
    want_a = torch.stack([(torch.randn((5, 7), generator=gen) / 5 ** 0.5).to(torch.bfloat16)
                          for _ in range(3)])
    want_b = (torch.randn((4, 6), generator=gen) * 0.1 / 4 ** 0.5).to(torch.bfloat16)
    assert got["a"].dtype == torch.bfloat16 and torch.equal(got["a"], want_a)
    assert torch.equal(got["b"], want_b)
