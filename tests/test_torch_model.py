"""Parity of the port's dense model with the JAX model on the CPU.

JAX parameters from ``Model.init(PRNGKey(0), float32)`` are bridged into
the port through numpy; tokens come from a seeded numpy RNG. Reduced
configs cover GQA + QKV bias (qwen2), tied small GQA (smollm), muP scaling
(minicpm: scale_emb, scale_depth, dim_model_base) and qk-norm (qwen3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import TOL, close
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.models import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import REGISTRY
from repro_torch.models import build_model

ARCHS = ["qwen2-1.5b", "smollm-135m", "minicpm-2b", "qwen3-32b"]
B, S, SMAX = 2, 20, 40


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
def test_forward_prefill_decode_match_jax(arch):
    jmodel, jparams, model, params, toks = _setup(arch)
    tol = TOL["model_f32"]
    with torch.inference_mode():
        h = model.forward(params, {"tokens": _t(toks[:, :S])})
        close(h, jmodel.forward(jparams, {"tokens": jnp.asarray(toks[:, :S])},
                                for_train=False), tol)

        lg, cache = model.prefill(params, {"tokens": _t(toks[:, :S])}, SMAX)
        jlg, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])},
                                     SMAX)
        assert lg.dtype == torch.float32 and lg.shape == jlg.shape
        close(lg, jlg, tol)
        for key in ("k", "v"):
            close(cache["segments"][0][key], jcache["segments"][0][key], tol)
        assert cache["pos"] == int(jcache["pos"]) == S

        for n in (S, S + 1):
            lg, cache = model.decode_step(params, cache, _t(toks[:, n:n + 1]))
            jlg, jcache = jmodel.decode_step(jparams, jcache,
                                             jnp.asarray(toks[:, n:n + 1]))
            close(lg, jlg, tol)
        assert cache["pos"] == int(jcache["pos"]) == S + 2


@pytest.mark.parametrize("arch", ARCHS)
def test_port_decode_matches_forward(arch):
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


# every family is ported now (the ssm and vlm ones were refused until
# tests/test_torch_xlstm.py and tests/test_torch_multimodal.py held them):
# a config switched to either family builds the reference's segments and
# template, and only a family neither package knows raises
@pytest.mark.parametrize("change", [{"family": "ssm"}, {"family": "vlm"}])
def test_unported_families_raise(change):
    from repro.models.layers import PT as JPT
    from repro.models.model import plan_segments as jax_plan_segments
    from repro_torch.models.layers import map_templates

    cfg = dataclasses.replace(REGISTRY["qwen2-1.5b"].reduced(), **change)
    jcfg = dataclasses.replace(JAX_REGISTRY["qwen2-1.5b"].reduced(), **change)
    model = build_model(cfg)
    assert [(s.kind, s.n, s.scanned, s.inner) for s in model.segments] == \
        [(s.kind, s.n, s.scanned, s.inner) for s in jax_plan_segments(jcfg)]
    flat = []
    map_templates(lambda t: flat.append((t.shape, t.init)), model.template())
    assert flat == [(t.shape, t.init) for t in jax.tree_util.tree_leaves(
        jax_build_model(jcfg).template(), is_leaf=lambda t: isinstance(t, JPT))]
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(cfg, family="diffusion"))
