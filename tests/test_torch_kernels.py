"""Parity of the port's kernels on the CPU: each plain version against the
Pallas kernel (interpret mode) and the JAX ``ref.py`` oracle. The CUDA
kernels against their plain versions on the card are in
``test_torch_kernels_cuda.py`` (no JAX there: the card's machine has none).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import TOL, close, randn
from repro.kernels.flash_attention.kernel import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ops import flash_mha as jax_flash_mha
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.rmsnorm.kernel import fused_rmsnorm
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro_torch.kernels.flash_attention.ops import flash_mha
from repro_torch.kernels.flash_attention.ref import flash_mha_ref
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _pair(arr: np.ndarray, dt: str):
    """The same values as a JAX array and a CPU tensor of dtype ``dt`` (f32
    -> bf16 rounds to nearest even in both)."""
    return jnp.asarray(arr, _JDT[dt]), torch.from_numpy(arr).to(_TDT[dt])


# -- rmsnorm ----------------------------------------------------------------

@pytest.mark.parametrize("shape,dt", [
    ((64, 256), "f32"),         # tests/test_kernels.py::test_rmsnorm_sweep
    ((3, 50, 512), "bf16"),
    ((1, 1, 128), "f32"),
    ((2, 20, 4, 16), "f32"),    # qk-norm per head, reduced hd = 16
    ((2, 20, 4, 16), "bf16"),
])
def test_rmsnorm_plain_vs_pallas_and_ref(shape, dt):
    x_np, w_np = randn(0, shape), randn(1, shape[-1:])
    xj, xt = _pair(x_np, dt)
    wj, wt = _pair(w_np, dt)
    got = rmsnorm(xt, wt, 1e-6)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    tol = TOL[f"rmsnorm_{dt}"]
    close(got, fused_rmsnorm(xj, wj, eps=1e-6), tol)
    close(got, jax_rmsnorm_ref(xj, wj, eps=1e-6), tol)


def test_rmsnorm_cpu_takes_plain_version_without_counting():
    x, w = torch.from_numpy(randn(2, (5, 24))), torch.from_numpy(randn(3, (24,)))
    before = rmsnorm.launches
    assert torch.equal(rmsnorm(x, w, 1e-5), rmsnorm_ref(x, w, 1e-5))
    assert rmsnorm.launches == before


def test_rmsnorm_other_device_raises_instead_of_falling_back():
    x = torch.empty(4, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rmsnorm(x, torch.empty(16, device="meta"))


# -- flash attention ------------------------------------------------------

def _flash_inputs(B, Sq, Sk, H, KV, hd, dt, seed=0):
    q = randn(seed, (B, Sq, H, hd))
    k = randn(seed + 1, (B, Sk, KV, hd))
    v = randn(seed + 2, (B, Sk, KV, hd))
    return [_pair(a, dt) for a in (q, k, v)]


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 128, 2, 2, 64),       # MHA      (tests/test_kernels.py shapes)
    (2, 256, 4, 2, 64),       # GQA 2:1
    (1, 384, 8, 1, 32),       # MQA, three k blocks
    (2, 128, 3, 1, 128),      # odd head count
    (2, 40, 4, 2, 16),        # reduced-config head dim, one short block
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_vs_pallas_and_ref(B, S, H, KV, hd, causal):
    (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(B, S, S, H, KV, hd, "f32")
    got = flash_mha(qt, kt, vt, causal=causal)
    assert got.shape == qt.shape and got.dtype == qt.dtype
    close(got, jax_flash_mha(qj, kj, vj, causal=causal), TOL["flash_f32"])
    # Sq == Sk: the oracle's bottom-right mask coincides with top-left
    G = H // KV
    ref = attention_ref(qj.transpose(0, 2, 1, 3).reshape(B * H, S, hd),
                        kj.transpose(0, 2, 1, 3).reshape(B * KV, S, hd),
                        vj.transpose(0, 2, 1, 3).reshape(B * KV, S, hd),
                        n_q_heads_per_kv=G, causal=causal)
    close(got, ref.reshape(B, H, S, hd).transpose(0, 2, 1, 3), TOL["flash_f32"])


def test_flash_plain_vs_pallas_bf16():
    (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(1, 256, 256, 4, 2, 64, "bf16", 1)
    got = flash_mha(qt, kt, vt, causal=True)
    assert got.dtype == torch.bfloat16
    close(got, jax_flash_mha(qj, kj, vj, causal=True), TOL["flash_bf16"])


@pytest.mark.parametrize("Sq,Sk", [(96, 160), (160, 96)])
def test_flash_sq_ne_sk_follows_kernel_top_left_mask(Sq, Sk):
    """Mask hazard: kernel.py aligns the causal mask TOP-LEFT (col <= row);
    the oracle attention_ref aligns it BOTTOM-RIGHT (tril(k=Sk-Sq)). The
    port follows kernel.py, so with Sq != Sk it is held against the Pallas
    kernel, and the oracle is shown to disagree."""
    B, H, KV, hd = 2, 4, 2, 32
    G = H // KV
    (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(B, Sq, Sk, H, KV, hd, "f32", 3)
    got = flash_mha(qt, kt, vt, causal=True)

    def flat(x, n):
        return x.transpose(0, 2, 1, 3).reshape(B * n, x.shape[1], hd)

    # block sizes divide Sk: the Pallas kernel does not mask a ragged k tail
    # (see test_flash_ragged_k_tail_is_masked_unlike_pallas)
    pallas = jax_flash_attention(flat(qj, H), flat(kj, KV), flat(vj, KV),
                                 n_q_heads_per_kv=G, causal=True,
                                 block_q=32, block_k=32)
    pallas = pallas.reshape(B, H, Sq, hd).transpose(0, 2, 1, 3)
    close(got, pallas, TOL["flash_f32"])
    oracle = attention_ref(flat(qj, H), flat(kj, KV), flat(vj, KV),
                           n_q_heads_per_kv=G, causal=True)
    oracle = oracle.reshape(B, H, Sq, hd).transpose(0, 2, 1, 3)
    assert np.abs(np.asarray(oracle) - got.numpy()).max() > 1e-2


def test_flash_ragged_k_tail_is_masked_unlike_pallas():
    """Divergence of the reference: kernel.py masks only col <= row, never
    col >= Sk, so when Sk is not a multiple of block_k the padded K/V block
    leaks into the output (NaN in interpret mode). The port masks ragged
    tails; at Sq == Sk it agrees with the oracle attention_ref."""
    B, S, H, KV, hd = 1, 160, 2, 1, 32
    (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(B, S, S, H, KV, hd, "f32", 6)
    got = flash_mha(qt, kt, vt, causal=True)
    assert bool(torch.isfinite(got).all())
    assert np.isnan(np.asarray(jax_flash_mha(qj, kj, vj, causal=True))).any()
    ref = attention_ref(qj.transpose(0, 2, 1, 3).reshape(B * H, S, hd),
                        kj.transpose(0, 2, 1, 3).reshape(B * KV, S, hd),
                        vj.transpose(0, 2, 1, 3).reshape(B * KV, S, hd),
                        n_q_heads_per_kv=H // KV, causal=True)
    close(got, ref.reshape(B, H, S, hd).transpose(0, 2, 1, 3), TOL["flash_f32"])


def test_flash_plain_zero_for_rows_that_see_no_key():
    """p = 0 where s <= NEG/2 and l clamped at 1e-30: a row with every key
    masked comes out as 0 (reachable only with Sk = 0 under top-left)."""
    q = torch.from_numpy(randn(4, (1, 3, 2, 16)))
    kv = torch.zeros(1, 0, 2, 16)
    assert torch.equal(flash_mha_ref(q, kv, kv, causal=True), torch.zeros_like(q))


def test_flash_cpu_takes_plain_version_without_counting():
    (_, qt), (_, kt), (_, vt) = _flash_inputs(1, 20, 20, 2, 1, 16, "f32", 5)
    before = flash_mha.launches
    assert torch.equal(flash_mha(qt, kt, vt), flash_mha_ref(qt, kt, vt))
    assert flash_mha.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        flash_mha(qt.to("meta"), kt.to("meta"), vt.to("meta"))
