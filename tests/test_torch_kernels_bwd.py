"""The backward kernels' algorithms on the CPU, against ``jax.grad``.

The JAX package has no backward kernels: it differentiates its jnp
functions. So each backward here is held against ``jax.vjp`` of the
function its kernel's forward replaces, on the same numpy inputs and output
gradient:

* rmsnorm — the plain version's autograd (``rmsnorm_bwd_ref``, the
  wrapper's CPU path) against ``repro/kernels/rmsnorm/ref.py::rmsnorm_ref``,
  f32 1e-5;
* flash attention — the plain version's autograd (``flash_mha_bwd_ref``)
  and the emulation of the backward kernel's three launches
  (``flash_mha_bwd_tiled``) against ``repro/kernels/flash_attention/ref.py::
  attention_ref`` (GQA, ragged S, hd 16 and 32) and, under a window with
  sinks, ``repro/models/attention.py::attention``; f32 1e-4. Sq = Sk, where
  the kernel's top-left causal mask and the oracle's bottom-right one agree
  (ROADMAP §3).

The kernels themselves against these plain versions run on the card
(``test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import randn
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro.models.attention import attention as jax_attention
from repro_torch.kernels.flash_attention.kernel import BWD_KEYS, BWD_ROWS
from repro_torch.kernels.flash_attention.ops import flash_mha
from repro_torch.kernels.flash_attention.ref import (bwd_key_tile_visited, flash_mha_bwd_ref,
                                                     flash_mha_bwd_tiled, flash_mha_ref,
                                                     visible)
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref

RMS_TOL, FLASH_TOL = 1e-5, 1e-4


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [(64, 48), (2 * 16 * 4, 16), (3, 5, 128)])
def test_rmsnorm_backward_matches_jax_grad(shape):
    """[rows, d], and [B·S·H, hd] rows as qk-norm sees them."""
    x, w, g = randn(0, shape), 1 + 0.1 * randn(1, shape[-1:]), randn(2, shape)
    _, vjp = jax.vjp(lambda a, b: jax_rmsnorm_ref(a, b, eps=1e-6), jnp.asarray(x),
                     jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    dx, dw = rmsnorm_bwd_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g))
    _close(dx, jdx, RMS_TOL)
    _close(dw, jdw, RMS_TOL)
    # the wrapper's CPU path differentiates the plain version, counting no launch
    xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    before = rmsnorm.bwd_launches, rmsnorm.launches
    out = rmsnorm(xt, wt, 1e-6)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    assert (rmsnorm.bwd_launches, rmsnorm.launches) == before
    _close(xt.grad, jdx, RMS_TOL)
    _close(wt.grad, jdw, RMS_TOL)


def _flash_inputs(B, S, H, KV, hd, seed):
    return (randn(seed, (B, S, H, hd)), randn(seed + 1, (B, S, KV, hd)),
            randn(seed + 2, (B, S, KV, hd)), randn(seed + 3, (B, S, H, hd)))


def _jax_grads_oracle(q, k, v, do, causal):
    """jax.vjp of attention_ref, in its [B·heads, S, hd] layout."""
    B, S, H, hd = q.shape
    KV = k.shape[2]

    def flat(a):
        return jnp.asarray(a).transpose(0, 2, 1, 3).reshape(-1, S, hd)

    def unflat(a, heads):
        return np.asarray(a).reshape(B, heads, S, hd).transpose(0, 2, 1, 3)

    _, vjp = jax.vjp(lambda a, b, c: attention_ref(a, b, c, n_q_heads_per_kv=H // KV,
                                                   causal=causal), flat(q), flat(k), flat(v))
    dq, dk, dv = vjp(flat(do))
    return unflat(dq, H), unflat(dk, KV), unflat(dv, KV)


def _check(q, k, v, do, want, **mask):
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    for got in (flash_mha_bwd_ref(qt, kt, vt, dot, **mask),
                flash_mha_bwd_tiled(qt, kt, vt, flash_mha_ref(qt, kt, vt, **mask), dot,
                                    **mask)):
        for g, w in zip(got, want):
            _close(g, w, FLASH_TOL)


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (2, 64, 4, 4, 16),        # G 1, one tile
    (2, 100, 4, 2, 16),       # G 2, ragged S: neither 64 nor 32 divides it
    (1, 150, 4, 1, 32),       # G 4 (MQA), ragged, several tiles
    (1, 96, 6, 3, 32),        # G 2, hd 32
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_matches_jax_grad(B, S, H, KV, hd, causal):
    q, k, v, do = _flash_inputs(B, S, H, KV, hd, seed=10)
    _check(q, k, v, do, _jax_grads_oracle(q, k, v, do, causal), causal=causal)


@pytest.mark.parametrize("S,window,n_sink,hd", [(150, 40, 7, 16), (130, 5, 0, 32),
                                                (200, 64, 20, 16)])
def test_flash_backward_window_sinks_matches_jax_grad(S, window, n_sink, hd):
    """Hymba's mask: the JAX model's attention (one query chunk, so its
    sinks stay in the softmax) differentiated by jax.vjp."""
    q, k, v, do = _flash_inputs(2, S, 4, 2, hd, seed=20)
    _, vjp = jax.vjp(lambda a, b, c: jax_attention(a, b, c, causal=True, window=window,
                                                   n_sink=n_sink, q_chunk=512),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _check(q, k, v, do, vjp(jnp.asarray(do)), causal=True, window=window, n_sink=n_sink)


def test_flash_wrapper_cpu_path_differentiates_the_plain_version():
    q, k, v, do = (torch.from_numpy(a) for a in _flash_inputs(1, 40, 4, 2, 16, seed=30))
    want = flash_mha_bwd_ref(q, k, v, do)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    before = flash_mha.bwd_launches, flash_mha.launches
    out = flash_mha(q, k, v)
    assert out.grad_fn is not None
    out.backward(do)
    assert (flash_mha.bwd_launches, flash_mha.launches) == before
    for t, w in zip((q, k, v), want):
        torch.testing.assert_close(t.grad, w, rtol=0, atol=0)


@pytest.mark.parametrize("causal,window,n_sink", [(True, 0, 0), (True, 40, 7),
                                                   (True, 100, 0), (False, 0, 0)])
def test_backward_tile_skip_drops_only_masked_tiles(causal, window, n_sink):
    """Every key tile the backward kernel skips (pre-pass and dQ) holds no
    visible pair for any row of its query tile, at every tile position."""
    Sk = 300
    for q0, k0 in itertools.product(range(0, 320, BWD_ROWS), range(0, Sk, BWD_KEYS)):
        if bwd_key_tile_visited(k0, q0, causal=causal, window=window, n_sink=n_sink):
            continue
        rows = torch.arange(q0, q0 + BWD_ROWS)[:, None]
        cols = torch.arange(k0, min(k0 + BWD_KEYS, Sk))[None, :]
        assert not visible(rows, cols, Sk, causal=causal, window=window,
                           n_sink=n_sink).any(), (q0, k0)
