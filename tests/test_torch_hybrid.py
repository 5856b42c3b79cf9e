"""Parity of the port's hybrid slice (Hymba) with the JAX package on the CPU.

The SSM scan's plain version against the Pallas kernel (interpret mode) and
its ``ref.py`` oracle; the Mamba mixer; windowed attention with sinks
against the reference's banded and two-piece forms; the reduced hymba model
(forward, prefill with its ring cache and SSM state, decode) on bridged f32
params; and the ServeEngine's greedy tokens. Inputs are drawn with numpy.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import TOL, close, randn
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.kernels.ssm_scan.ops import ssm_scan_batched as jax_ssm_scan_batched
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_ssm_scan_ref
from repro.models import attention as jax_attn
from repro.models import build_model as jax_build_model
from repro.models import mamba as jax_mamba
from repro.models.model import plan_segments as jax_plan_segments
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import REGISTRY
from repro_torch.kernels.ssm_scan.ops import ssm_scan_batched
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.models import attention as t_attn
from repro_torch.models import build_model, mamba as t_mamba
from repro_torch.models.layers import map_templates
from repro_torch.models.model import plan_segments
from repro_torch.serve import ServeEngine

ARCH = "hymba-1.5b"
SCAN_TOL = TOL["scan_f32"]


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


# -- ssm_scan -----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(37, 100), (130, 520), (2, 64, 96), (1, 1, 7)])
def test_ssm_scan_plain_vs_pallas_and_ref(shape):
    a = _sigmoid(randn(0, shape)).astype(np.float32)
    b = randn(1, shape)
    got = ssm_scan_batched(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    close(got, jax_ssm_scan_batched(jnp.asarray(a), jnp.asarray(b)), SCAN_TOL)
    ref = jax_ssm_scan_ref if len(shape) == 2 else jax.vmap(jax_ssm_scan_ref)
    close(got, jax.jit(ref)(jnp.asarray(a), jnp.asarray(b)), SCAN_TOL)


def test_ssm_scan_bf16_keeps_f32_state_and_input_dtype():
    a = _sigmoid(randn(2, (50, 33))).astype(np.float32)
    b = randn(3, (50, 33))
    at, bt = (torch.from_numpy(x).bfloat16() for x in (a, b))
    got = ssm_scan_batched(at, bt)
    assert got.dtype == torch.bfloat16
    want = jax.jit(jax_ssm_scan_ref)(jnp.asarray(a, jnp.bfloat16),
                                     jnp.asarray(b, jnp.bfloat16))
    close(got, want, TOL["scan_bf16"])


def test_ssm_scan_cpu_takes_plain_version_without_counting():
    a, b = torch.from_numpy(randn(4, (9, 12))), torch.from_numpy(randn(5, (9, 12)))
    before = ssm_scan_batched.launches
    assert torch.equal(ssm_scan_batched(a, b), ssm_scan_ref(a, b))
    assert ssm_scan_batched.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        ssm_scan_batched(a.to("meta"), b.to("meta"))


# -- Mamba mixer --------------------------------------------------------------

B_M, S_M, DI, N, DTR, K = 2, 13, 24, 8, 4, 4


def _mamba_inputs(seed=10):
    p = dict(
        conv_w=0.1 * randn(seed, (DI, K)),
        w_x=randn(seed + 1, (DI, DTR + 2 * N)) / DI ** 0.5,
        w_dt=randn(seed + 2, (DTR, DI)) / DTR ** 0.5,
        b_dt=0.1 * randn(seed + 3, (DI,)),
        a_log=0.1 * randn(seed + 4, (DI, N)),
        d_skip=np.ones((DI,), np.float32),
    )
    x_in, z = randn(seed + 5, (B_M, S_M, DI)), randn(seed + 6, (B_M, S_M, DI))
    state = (randn(seed + 7, (B_M, DI, K - 1)), randn(seed + 8, (B_M, DI, N)))
    return p, x_in, z, state


def _args(p, x_in, z, cast):
    return (cast(x_in), cast(z), *(cast(p[k]) for k in
                                   ("conv_w", "w_x", "w_dt", "b_dt", "a_log", "d_skip")))


def test_selective_scan_matches_reference():
    a = _sigmoid(randn(20, (2, 11, 6, 4))).astype(np.float32)
    bu = randn(21, (2, 11, 6, 4))
    got = t_mamba.selective_scan(torch.from_numpy(a), torch.from_numpy(bu))
    close(got, jax.jit(jax_mamba.selective_scan)(jnp.asarray(a), jnp.asarray(bu)),
          SCAN_TOL)


@pytest.mark.parametrize("carried", [False, True])
def test_mamba_mix_matches_reference(carried):
    p, x_in, z, (conv, ssm) = _mamba_inputs()
    kw = dict(n_state=N, dt_rank=DTR)
    jstate = jax_mamba.MambaState(jnp.asarray(conv), jnp.asarray(ssm)) if carried else None
    tstate = (t_mamba.MambaState(torch.from_numpy(conv), torch.from_numpy(ssm))
              if carried else None)
    jmix = jax.jit(functools.partial(jax_mamba.mamba_mix, return_state=True, **kw))
    jout, jst = jmix(*_args(p, x_in, z, jnp.asarray), state=jstate)
    out, st = t_mamba.mamba_mix(*_args(p, x_in, z, torch.from_numpy), state=tstate,
                                return_state=True, **kw)
    close(out, jout, SCAN_TOL)
    close(st.conv, jst.conv, SCAN_TOL)
    close(st.ssm, jst.ssm, SCAN_TOL)
    # without return_state the output alone comes back
    close(t_mamba.mamba_mix(*_args(p, x_in, z, torch.from_numpy), state=tstate, **kw),
          jout, SCAN_TOL)


def test_mamba_decode_mix_matches_reference():
    p, x_in, z, (conv, ssm) = _mamba_inputs(30)
    kw = dict(n_state=N, dt_rank=DTR)
    x1, z1 = x_in[:, :1], z[:, :1]
    jout, jst = jax.jit(functools.partial(jax_mamba.mamba_decode_mix, **kw))(
        *_args(p, x1, z1, jnp.asarray),
        state=jax_mamba.MambaState(jnp.asarray(conv), jnp.asarray(ssm)))
    out, st = t_mamba.mamba_decode_mix(
        *_args(p, x1, z1, torch.from_numpy),
        state=t_mamba.MambaState(torch.from_numpy(conv), torch.from_numpy(ssm)), **kw)
    close(out, jout, SCAN_TOL)
    close(st.conv, jst.conv, SCAN_TOL)
    close(st.ssm, jst.ssm, SCAN_TOL)


# -- windowed attention with sinks ----------------------------------------------

def _qkv(B=2, S=160, H=4, KV=2, hd=16, seed=40):
    return (randn(seed, (B, S, H, hd)), randn(seed + 1, (B, S, KV, hd)),
            randn(seed + 2, (B, S, KV, hd)))


@pytest.mark.parametrize("window,n_sink,q_chunk", [
    (16, 8, 512),    # one chunk: the reference's plain masked path
    (16, 8, 8),      # sink_banded_attention's two-piece (sinks + band) branch
    (16, 8, 40),     # two-piece, four chunks
    (16, 0, 8),      # the reference's banded key slice, no sinks
    (7, 3, 512),     # window shorter than a kernel key tile
])
def test_windowed_attention_matches_reference(window, n_sink, q_chunk):
    q, k, v = _qkv()
    got = t_attn.attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                           window=window, n_sink=n_sink)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    if n_sink:
        want = jax_attn.sink_banded_attention(jq, jk, jv, window=window,
                                              n_sink=n_sink, q_chunk=q_chunk)
        close(t_attn.sink_banded_attention(*map(torch.from_numpy, (q, k, v)),
                                           window=window, n_sink=n_sink),
              want, TOL["flash_f32"])
    else:
        want = jax_attn.attention(jq, jk, jv, causal=True, window=window,
                                  q_chunk=q_chunk)
    close(got, want, TOL["flash_f32"])


def test_reference_banded_attention_drops_sinks_port_keeps_them():
    """Divergence of the reference: banded ``attention`` with n_sink > 0
    drops sink keys outside the band (repro/models/attention.py:102-104).
    ``sink_banded_attention`` never reaches that case; the port always
    attends sinks and agrees with the two-piece form."""
    q, k, v = _qkv(seed=50)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    got = t_attn.attention(*map(torch.from_numpy, (q, k, v)), window=16, n_sink=8)
    banded = jax_attn.attention(jq, jk, jv, causal=True, window=16, n_sink=8,
                                q_chunk=8)
    assert np.abs(np.asarray(banded) - got.numpy()).max() > 1e-2
    close(got, jax_attn.sink_banded_attention(jq, jk, jv, window=16, n_sink=8,
                                              q_chunk=8), TOL["flash_f32"])


# -- the reduced hymba model ----------------------------------------------------

B, S, SMAX = 2, 30, 48      # 30 tokens + 8 meta > window 16 + 8 sinks: the ring wraps


def _t(toks):
    return torch.from_numpy(toks.astype(np.int64))


def _numpy_params(model, seed: int):
    """f32 parameters drawn with numpy by the init laws of the template
    (normal / sqrt(fan_in), x0.1 for "small", zeros, ones), path for path."""
    rng = np.random.default_rng(seed)

    def draw(t):
        if t.init in ("zeros", "ones"):
            return np.full(t.shape, float(t.init == "ones"), np.float32)
        fan = t.fan_in or (t.shape[-2] if len(t.shape) >= 2 else t.shape[-1])
        scale = (0.1 if t.init == "small" else 1.0) / max(fan, 1) ** 0.5
        return (rng.standard_normal(t.shape) * scale).astype(np.float32)

    return map_templates(draw, model.template())


@pytest.fixture(scope="module")
def hymba():
    jcfg = JAX_REGISTRY[ARCH].reduced()
    model = build_model(REGISTRY[ARCH].reduced())
    tree = _numpy_params(model, 0)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    params = params_from_numpy(model, tree, device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S + 2),
                                             dtype=np.int32)
    return jcfg, jparams, model, params, toks


def test_hymba_segments_follow_the_reference():
    cfg = REGISTRY[ARCH]
    for c, jc in ((cfg, JAX_REGISTRY[ARCH]), (cfg.reduced(), JAX_REGISTRY[ARCH].reduced())):
        segs = plan_segments(c)
        assert [(s.kind, s.n, s.scanned, s.window, s.n_sink) for s in segs] == \
            [(s.kind, s.n, s.scanned, s.window, s.n_sink) for s in jax_plan_segments(jc)]
    assert [(s.n, s.scanned, s.window) for s in plan_segments(cfg)] == [
        (1, False, 0), (14, True, 1024), (1, False, 0), (15, True, 1024),
        (1, False, 0)]


@pytest.mark.parametrize("q_chunk", [512, 8])
def test_hymba_forward_prefill_decode_match_jax(hymba, q_chunk):
    jcfg, jparams, model, params, toks = hymba
    jmodel = jax_build_model(jcfg, remat=False, q_chunk=q_chunk)
    jforward = jax.jit(lambda p, t: jmodel.forward(p, {"tokens": t}, for_train=False))
    jprefill = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, SMAX))
    jdecode = jax.jit(jmodel.decode_step)
    tol = TOL["model_f32"]
    jt = jnp.asarray(toks[:, :S])
    with torch.inference_mode():
        h = model.forward(params, {"tokens": _t(toks[:, :S])})
        assert h.shape == (B, S + jcfg.n_meta_tokens, jcfg.d_model)
        close(h, jforward(jparams, jt), tol)

        lg, cache = model.prefill(params, {"tokens": _t(toks[:, :S])}, SMAX)
        jlg, jcache = jprefill(jparams, jt)
        close(lg, jlg, tol)
        assert cache["pos"] == int(jcache["pos"]) == S
        for seg, jseg in zip(cache["segments"], jcache["segments"]):
            assert set(seg) == set(jseg) == {"k", "v", "conv", "ssm"}
            for key in seg:
                assert seg[key].shape == jseg[key].shape
                close(seg[key], jseg[key], tol)
        assert cache["segments"][1]["conv"].dtype == torch.float32

        for n in (S, S + 1):
            lg, cache = model.decode_step(params, cache, _t(toks[:, n:n + 1]))
            jlg, jcache = jdecode(jparams, jcache, jnp.asarray(toks[:, n:n + 1]))
            close(lg, jlg, tol)
        assert cache["pos"] == int(jcache["pos"]) == S + 2
        for seg, jseg in zip(cache["segments"], jcache["segments"]):
            for key in seg:
                close(seg[key], jseg[key], tol)


def test_hymba_port_decode_matches_forward(hymba):
    """Prefill + 2 decode steps == the port's own forward logits."""
    _, _, model, params, toks = hymba
    with torch.inference_mode():
        lg, cache = model.prefill(params, {"tokens": _t(toks[:, :S])}, SMAX)
        got = [lg]
        for n in (S, S + 1):
            lg, cache = model.decode_step(params, cache, _t(toks[:, n:n + 1]))
            got.append(lg)
        for lg, n in zip(got, (S, S + 1, S + 2)):
            h = model.forward(params, {"tokens": _t(toks[:, :n])})
            close(lg, model._logits(params, h[:, -1]), TOL["decode_vs_forward"])


def test_hymba_serve_engine_same_tokens(hymba):
    jcfg, jparams, model, params, _ = hymba
    jeng = JaxServeEngine(jax_build_model(jcfg, remat=False), jparams, smax=SMAX)
    eng = ServeEngine(model, params, smax=SMAX)
    rng = np.random.default_rng(7)
    lengths = [5, 26, 12, 30]
    for i, n in enumerate(lengths):
        prompt = rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
        # request 2 runs out of its deadline twice: evicted, re-queued, evicted
        max_new, deadline = (8, 3) if i == 1 else (6, None)
        assert (jeng.submit(prompt, max_new, deadline)
                == eng.submit(prompt, max_new, deadline))
    want = jeng.run(batch_size=2)
    got = eng.run(batch_size=2)
    assert got == want
    assert eng.evicted == jeng.evicted == [2]
    assert len(got[2]) == 6 and all(len(got[r]) == 6 for r in (1, 3, 4))
