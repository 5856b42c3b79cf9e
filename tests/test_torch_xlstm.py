"""Parity of the port's xLSTM slice (the ``ssm`` family) with the JAX
package on the CPU.

The cells of ``models/ssm.py`` (the chunkwise-parallel mLSTM at S 64, 40,
37, 257 and 300, i.e. chunk lengths 64, 40, 37, 1 and 150, from a fresh and
a carried state; its decode step;
the sLSTM scan and step) against the reference within 1e-5; the reduced
xlstm-125m (forward, prefill with its f32 cell states, decode) in f32 and,
through the bf16 ``uint16`` bridge, in bf16 (each tensor within 2e-2 in
relative 2-norm, ``close_rel_l2``); decode against forward; the
ServeEngine's greedy tokens; and, for every family, ``Model.init_cache``
against the reference's leaf for leaf (the port once zero-filled every
leaf, where the xLSTM stabilisers start at -1e30 and the sLSTM normaliser
at 1). Inputs are drawn with numpy.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import TOL, close, close_rel_l2, randn
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.models import build_model as jax_build_model
from repro.models import ssm as jax_ssm
from repro.models.layers import PT as JPT
from repro.models.model import plan_segments as jax_plan_segments
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import REGISTRY
from repro_torch.models import build_model, ssm
from repro_torch.models.layers import map_templates
from repro_torch.models.model import plan_segments
from repro_torch.serve import ServeEngine

ARCH = "xlstm-125m"
CELL_TOL = 1e-5
BF16_TOL = 2e-2
B, S, SMAX = 2, 24, 40


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -- the cells ------------------------------------------------------------------

def _mlstm_inputs(S, seed=0, Bc=2, H=3, dk=8, dv=12):
    return (randn(seed, (Bc, S, H, dk)), randn(seed + 1, (Bc, S, H, dk)),
            randn(seed + 2, (Bc, S, H, dv)), randn(seed + 3, (Bc, S, H)),
            2.0 + randn(seed + 4, (Bc, S, H)))


def _mlstm_state(seed=10, Bc=2, H=3, dk=8, dv=12):
    return (randn(seed, (Bc, H, dk, dv)), np.abs(randn(seed + 1, (Bc, H, dk))),
            randn(seed + 2, (Bc, H)))


# the reference's L: min(256, S), shrunk until it divides S. A prime S
# below 256 is one chunk; a prime S above it runs S chunks of one token
@pytest.mark.parametrize("S,L", [(64, 64), (40, 40), (37, 37), (257, 1), (300, 150)])
@pytest.mark.parametrize("carried", [False, True])
def test_mlstm_chunked_matches_jax(S, L, carried):
    assert ssm.chunk_len(S) == L
    x = _mlstm_inputs(S)
    st = _mlstm_state() if carried else None
    jfn = jax.jit(functools.partial(jax_ssm.mlstm_chunked, return_state=True))
    jh, jst = jfn(*map(jnp.asarray, x), None if st is None else tuple(map(jnp.asarray, st)))
    h, got = ssm.mlstm_chunked(*map(_t, x), None if st is None else tuple(map(_t, st)),
                               return_state=True)
    assert h.shape == (2, S, 3, 12) and h.dtype == torch.float32
    close(h, jh, CELL_TOL)
    for a, b in zip(got, jst):
        close(a, b, CELL_TOL)
    close(ssm.mlstm_chunked(*map(_t, x), None if st is None else tuple(map(_t, st))),
          jh, CELL_TOL)


def test_mlstm_chunk_length_changes_no_value():
    """The function does not depend on L: 64 tokens in chunks of 64, 16, 1."""
    x = tuple(map(_t, _mlstm_inputs(64, seed=20)))
    want = ssm.mlstm_chunked(*x)
    for chunk in (16, 1):
        close(ssm.mlstm_chunked(*x, chunk=chunk), want, CELL_TOL)


def test_mlstm_decode_step_matches_jax_and_the_chunked_form():
    q, k, v, i_pre, f_pre = _mlstm_inputs(1, seed=30)
    st = _mlstm_state(40)
    jh, jst = jax.jit(jax_ssm.mlstm_decode_step)(*map(jnp.asarray, (q, k, v, i_pre, f_pre)),
                                                 tuple(map(jnp.asarray, st)))
    h, got = ssm.mlstm_decode_step(*map(_t, (q, k, v, i_pre, f_pre)), tuple(map(_t, st)))
    close(h, jh, CELL_TOL)
    for a, b in zip(got, jst):
        close(a, b, CELL_TOL)
    # one token through the chunked form (L 1) from the same state
    hc, stc = ssm.mlstm_chunked(*map(_t, (q, k, v, i_pre, f_pre)), tuple(map(_t, st)),
                                return_state=True)
    close(hc, h, CELL_TOL)
    for a, b in zip(stc, got):
        close(a, b, CELL_TOL)


def _slstm_inputs(S, seed=50, Bc=2, H=3, hd=8):
    return randn(seed, (Bc, S, H, 4, hd)), 0.1 * randn(seed + 1, (H, hd, 4, hd))


@pytest.mark.parametrize("carried", [False, True])
def test_slstm_scan_matches_jax(carried):
    gx, R = _slstm_inputs(19)
    st = None
    if carried:
        c, h, m = (randn(60 + i, (2, 3, 8)) for i in range(3))
        st = (c, 1.0 + np.abs(randn(63, (2, 3, 8))), h, m)
    jh, jst = jax.jit(jax_ssm.slstm_scan)(jnp.asarray(gx), jnp.asarray(R),
                                          None if st is None else tuple(map(jnp.asarray, st)))
    h, got = ssm.slstm_scan(_t(gx), _t(R), None if st is None else tuple(map(_t, st)))
    assert h.shape == (2, 19, 3, 8)
    close(h, jh, CELL_TOL)
    for a, b in zip(got, jst):
        close(a, b, CELL_TOL)


def test_slstm_decode_step_matches_jax():
    gx, R = _slstm_inputs(1, seed=70)
    st = tuple(np.asarray(s) for s in jax_ssm.slstm_state_init(2, 3, 8))
    jh, jst = jax.jit(jax_ssm.slstm_decode_step)(jnp.asarray(gx), jnp.asarray(R),
                                                 tuple(map(jnp.asarray, st)))
    h, got = ssm.slstm_decode_step(_t(gx), _t(R), tuple(map(_t, st)))
    close(h, jh, CELL_TOL)
    for a, b in zip(got, jst):
        close(a, b, CELL_TOL)


def test_state_inits_match_jax():
    for mine, ref in ((ssm.mlstm_state_init(2, 3, 4, 5), jax_ssm.mlstm_state_init(2, 3, 4, 5)),
                      (ssm.slstm_state_init(2, 3, 4), jax_ssm.slstm_state_init(2, 3, 4))):
        for a, b in zip(mine, ref):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- the model ------------------------------------------------------------------

def _numpy_params(model, seed: int):
    """f32 parameters drawn with numpy by the template's init laws."""
    rng = np.random.default_rng(seed)

    def draw(t):
        if t.init in ("zeros", "ones"):
            return np.full(t.shape, float(t.init == "ones"), np.float32)
        fan = t.fan_in or (t.shape[-2] if len(t.shape) >= 2 else t.shape[-1])
        scale = (0.1 if t.init == "small" else 1.0) / max(fan, 1) ** 0.5
        return (rng.standard_normal(t.shape) * scale).astype(np.float32)

    return map_templates(draw, model.template())


def bridged(arch: str, seed: int = 0, dtype: str = "f32", edit=None):
    """The reduced arch in both packages from one numpy tree (bf16: the same
    bits on both sides, through the ``uint16`` bridge). ``edit(tree)``
    may change the tree first."""
    jcfg = JAX_REGISTRY[arch].reduced()
    model = build_model(REGISTRY[arch].reduced(), remat=False)
    tree = _numpy_params(model, seed)
    if edit is not None:
        edit(tree)
    if dtype == "bf16":
        tree = jax.tree_util.tree_map(
            lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)).view(np.uint16), tree)
        jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a.view(jnp.bfloat16)), tree)
    else:
        jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    params = params_from_numpy(model, tree, device="cpu")
    return jcfg, jax_build_model(jcfg, remat=False), jparams, model, params


@pytest.fixture(scope="module")
def xlstm():
    return bridged(ARCH)


def _toks(jcfg, seed=1):
    return np.random.default_rng(seed).integers(0, jcfg.vocab_size, (B, S + 2),
                                                dtype=np.int32)


def test_xlstm_segments_and_template_follow_the_reference():
    for cfg, jcfg in ((REGISTRY[ARCH], JAX_REGISTRY[ARCH]),
                      (REGISTRY[ARCH].reduced(), JAX_REGISTRY[ARCH].reduced())):
        assert [(s.kind, s.n, s.scanned) for s in plan_segments(cfg)] == \
            [(s.kind, s.n, s.scanned) for s in jax_plan_segments(jcfg)]
        flat = []
        map_templates(lambda t: flat.append((t.shape, t.init, t.fan_in, t.dtype)),
                      build_model(cfg).template())
        want = [(t.shape, t.init, t.fan_in, t.dtype) for t in jax.tree_util.tree_leaves(
            jax_build_model(jcfg).template(), is_leaf=lambda t: isinstance(t, JPT))]
        assert flat == want
    assert [(s.kind, s.n) for s in plan_segments(REGISTRY[ARCH])] == [
        ("mlstm", 1), ("slstm", 1), ("mlstm", 5), ("slstm", 1), ("mlstm", 4)]


def _compare_cache(cache, jcache, check):
    assert cache["pos"] == int(jcache["pos"])
    for seg, jseg in zip(cache["segments"], jcache["segments"]):
        assert set(seg) == set(jseg)
        for key in seg:
            assert seg[key].dtype == torch.float32 and seg[key].shape == jseg[key].shape
            check(seg[key], jseg[key])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_xlstm_forward_prefill_decode_match_jax(xlstm, dtype):
    jcfg, jmodel, jparams, model, params = xlstm if dtype == "f32" else bridged(ARCH, dtype="bf16")
    check = (lambda a, b: close(a, b, TOL["model_f32"])) if dtype == "f32" else \
        (lambda a, b: close_rel_l2(a, b, BF16_TOL))
    toks = _toks(jcfg)
    jforward = jax.jit(lambda p, t: jmodel.forward(p, {"tokens": t}, for_train=False))
    jprefill = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, SMAX))
    jdecode = jax.jit(jmodel.decode_step)
    with torch.inference_mode():
        h = model.forward(params, {"tokens": _t(toks[:, :S].astype(np.int64))})
        check(h, jforward(jparams, jnp.asarray(toks[:, :S])))
        lg, cache = model.prefill(params, {"tokens": _t(toks[:, :S].astype(np.int64))}, SMAX)
        jlg, jcache = jprefill(jparams, jnp.asarray(toks[:, :S]))
        check(lg, jlg)
        _compare_cache(cache, jcache, check)
        for n in (S, S + 1):
            lg, cache = model.decode_step(params, cache, _t(toks[:, n:n + 1].astype(np.int64)))
            jlg, jcache = jdecode(jparams, jcache, jnp.asarray(toks[:, n:n + 1]))
            check(lg, jlg)
        _compare_cache(cache, jcache, check)


def test_xlstm_port_decode_matches_forward(xlstm):
    """Prefill + 2 decode steps == the port's own forward logits (the check
    of tests/test_models_smoke.py::test_decode_matches_forward), from a
    prime prompt of 257 tokens: the prefill and the forward at S 257 run
    257 chunks of one token, the forwards at 258 and 259 chunks of 129 and
    37."""
    jcfg, _, _, model, params = xlstm
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, 260)))
    n0 = 257
    with torch.inference_mode():
        lg, cache = model.prefill(params, {"tokens": toks[:, :n0]}, n0 + 2)
        got = [lg]
        for n in (n0, n0 + 1):
            lg, cache = model.decode_step(params, cache, toks[:, n:n + 1])
            got.append(lg)
        for lg, n in zip(got, (n0, n0 + 1, n0 + 2)):
            h = model.forward(params, {"tokens": toks[:, :n]})
            close(lg, model._logits(params, h[:, -1]), TOL["decode_vs_forward"])


def test_xlstm_serve_engine_same_tokens(xlstm):
    jcfg, jmodel, jparams, model, params = xlstm
    jeng = JaxServeEngine(jmodel, jparams, smax=SMAX)
    eng = ServeEngine(model, params, smax=SMAX)
    rng = np.random.default_rng(7)
    for i, n in enumerate((5, 17, 11, 13)):
        prompt = rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
        max_new, deadline = (8, 3) if i == 1 else (6, None)
        assert jeng.submit(prompt, max_new, deadline) == eng.submit(prompt, max_new, deadline)
    want = jeng.run(batch_size=2)
    got = eng.run(batch_size=2)
    assert got == want
    assert eng.evicted == jeng.evicted == [2]


# -- init_cache: every family -----------------------------------------------------

@pytest.mark.parametrize("arch", sorted(REGISTRY))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_init_cache_matches_jax_leaf_for_leaf(arch, dtype):
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    cache = build_model(REGISTRY[arch].reduced()).init_cache(2, 16, tdt, "cpu")
    jcache = jax_build_model(JAX_REGISTRY[arch].reduced()).init_cache(2, 16, jdt)
    assert cache["pos"] == int(jcache["pos"]) == 0
    got = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.float().numpy(), cache["segments"]))
    dts = [str(t.dtype).split(".")[1] for t in jax.tree_util.tree_leaves(cache["segments"])]
    want = jax.tree_util.tree_leaves(jcache["segments"])
    assert len(got) == len(want) > 0
    for g, w, dt in zip(got, want, dts):
        assert g.shape == w.shape and dt == str(w.dtype)
        np.testing.assert_array_equal(g, np.asarray(w, np.float32))
