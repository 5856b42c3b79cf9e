"""Parity of the port's ServeEngine with the JAX ServeEngine on bridged f32
reduced qwen2-1.5b: identical greedy tokens and eviction lists.

Mixed prompt lengths exercise the left-pad without an attention mask
(``repro/serve/engine.py:95``), a divergence of the reference that the
port reproduces on purpose; the straggler cases run the evict / re-queue
path with and without retry budget.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.models import build_model as jax_build_model
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import REGISTRY
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine

SMAX = 48


@pytest.fixture(scope="module")
def engines():
    jcfg = JAX_REGISTRY["qwen2-1.5b"].reduced()
    jmodel = jax_build_model(jcfg, remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.float32)
    model = build_model(REGISTRY["qwen2-1.5b"].reduced())
    params = params_from_numpy(model, jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")

    def make(max_retries):
        return (JaxServeEngine(jmodel, jparams, smax=SMAX, max_retries=max_retries),
                ServeEngine(model, params, smax=SMAX, max_retries=max_retries))

    return make


def _run_both(make, max_retries, requests, batch_size):
    jeng, eng = make(max_retries)
    for prompt, max_new, deadline in requests:
        assert (jeng.submit(prompt, max_new, deadline)
                == eng.submit(prompt, max_new, deadline))
    want = jeng.run(batch_size=batch_size)
    got = eng.run(batch_size=batch_size)
    return jeng, eng, want, got


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lengths]


def test_mixed_prompt_lengths_same_tokens(engines):
    reqs = [(p, 6, None) for p in _prompts([5, 12, 9, 3, 7], seed=2)]
    jeng, eng, want, got = _run_both(engines, 1, reqs, batch_size=2)
    assert got == want
    assert sorted(got) == [1, 2, 3, 4, 5]
    assert all(len(v) == 6 for v in got.values())


@pytest.mark.parametrize("max_retries", [0, 1])
def test_straggler_eviction_same_tokens(engines, max_retries):
    p = _prompts([8, 5, 11], seed=3)
    reqs = [(p[0], 6, None), (p[1], 8, 3), (p[2], 4, None)]
    jeng, eng, want, got = _run_both(engines, max_retries, reqs, batch_size=2)
    assert got == want
    assert eng.evicted == jeng.evicted == [2]
    # the evicted straggler surfaces its partial output
    assert len(got[2]) == 3 * (max_retries + 1)
