"""The tile loops of the flash forward kernels on the CPU, through their
plain-torch emulation ``flash_mha_tiled``: the tensor-core kernel's
(``csrc/flash_attention_wgmma.cu``, 128 x 128, P rounded to the input dtype)
and the CUDA-core kernel's (``csrc/flash_attention.cu``, ``SIMT_TILE`` x
``SIMT_TILE``, P in f32), against the Pallas kernel in interpret mode,
against JAX's ``attention_ref`` and ``models.attention.attention`` (window
and sinks), against the plain version, L against ``torch.logsumexp``, and
the tile-skip predicate against the mask itself; the dispatch of a call to
the tensor cores by dtype and head dim, and the shared-memory plans of the
tensor-core forward (``wgmma_smem_plan``, the twin of ``Cfg<HD>``) and
backward (``wgmma_bwd_smem_plan``, the twin of ``WCfg<HD>``). The
kernels against the emulation on the card are in
``test_torch_kernels_cuda.py``.
"""
import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import TOL, close, randn
from repro.kernels.flash_attention.ops import flash_mha as jax_flash_mha
from repro.kernels.flash_attention.ref import attention_ref
from repro.models.attention import attention as jax_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.kernel import (HEAD_DIMS, SIMT_TILE, SMEM_PER_BLOCK,
                                                        SMEM_PER_SM, SMEM_RESERVED_PER_BLOCK,
                                                        WGMMA_BLOCK_K, WGMMA_BLOCK_Q,
                                                        WGMMA_BWD_HEAD_DIMS, WGMMA_HEAD_DIMS,
                                                        wgmma_bwd_smem_plan, wgmma_smem_plan)
from repro_torch.kernels.flash_attention.ref import (NEG, flash_mha_ref, flash_mha_tiled,
                                                     tile_visited, visible)

_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
# (block_q, block_k): the kernel's tiles, and a smaller pair that puts
# several tiles in the small shapes
_TILES = [(WGMMA_BLOCK_Q, WGMMA_BLOCK_K), (64, 32), (SIMT_TILE, SIMT_TILE)]
# the CUDA-core kernel's twin: its tiles, P kept in f32
_SIMT = dict(block_q=SIMT_TILE, block_k=SIMT_TILE, tensor_cores=False)


def _inputs(B, Sq, Sk, H, KV, hd, dt, seed):
    arrs = (randn(seed, (B, Sq, H, hd)), randn(seed + 1, (B, Sk, KV, hd)),
            randn(seed + 2, (B, Sk, KV, hd)))
    return ([jnp.asarray(a, _JDT[dt]) for a in arrs],
            [torch.from_numpy(a).to(_TDT[dt]) for a in arrs])


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 128, 2, 2, 64),       # MHA
    (2, 256, 6, 2, 128),      # GQA 3:1 at qwen2's head dim
    (1, 256, 5, 1, 64),       # MQA
    (1, 256, 4, 4, 80),       # HuBERT's head dim: five 16-column k-steps
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_tiled_vs_pallas(B, S, H, KV, hd, causal, dt):
    """Sq == Sk, a multiple of the Pallas blocks (its ragged k tail leaks).
    f32: P stays f32, only sum order differs (2e-5). bf16: P is rounded to
    bf16 before P·V, as on the tensor cores; Pallas keeps it in f32 (3e-2)."""
    (qj, kj, vj), (qt, kt, vt) = _inputs(B, S, S, H, KV, hd, dt, 20)
    got = flash_mha_tiled(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    close(got, jax_flash_mha(qj, kj, vj, causal=causal), TOL[f"flash_{dt}"])


@pytest.mark.parametrize("B,S,H,KV,hd,window,n_sink", [
    (2, 40, 4, 2, 16, 16, 8),         # hymba reduced
    (1, 700, 5, 5, 16, 256, 128),     # skipped tiles between sinks and band
    (2, 300, 4, 2, 16, 100, 7),       # ragged window and sinks
    (1, 130, 4, 1, 16, 5, 0),         # window shorter than a tile, no sinks
])
@pytest.mark.parametrize("block_q,block_k", _TILES)
def test_tiled_window_sink_vs_plain(B, S, H, KV, hd, window, n_sink, block_q, block_k):
    _, (q, k, v) = _inputs(B, S, S, H, KV, hd, "f32", 30)
    kw = dict(causal=True, window=window, n_sink=n_sink)
    close(flash_mha_tiled(q, k, v, block_q=block_q, block_k=block_k, **kw),
          flash_mha_ref(q, k, v, **kw), TOL["flash_f32"])


@pytest.mark.parametrize("Sq,Sk,causal", [(333, 517, True), (517, 333, True),
                                          (77, 300, False), (5, 0, True)])
@pytest.mark.parametrize("block_q,block_k", _TILES)
def test_tiled_ragged_vs_plain(Sq, Sk, causal, block_q, block_k):
    """Tails of neither tile size, Sq != Sk both ways (top-left mask), and no
    key at all (rows come out 0)."""
    _, (q, k, v) = _inputs(1, Sq, Sk, 4, 2, 16, "f32", 40)
    close(flash_mha_tiled(q, k, v, causal=causal, block_q=block_q, block_k=block_k),
          flash_mha_ref(q, k, v, causal=causal), TOL["flash_f32"])


def _visible(Sq, Sk, causal, window, n_sink):
    rows = np.arange(Sq)[:, None]
    cols = np.arange(Sk)[None, :]
    vis = np.ones((Sq, Sk), bool)
    if causal:
        vis = cols <= rows
        if window:
            vis &= (cols > rows - window) | (cols < n_sink)
    return vis


@pytest.mark.parametrize("block_q,block_k", [(128, 128), (64, 32), (16, 48), (8, 8),
                                             (SIMT_TILE, SIMT_TILE)])
def test_skip_predicate_is_exact_for_the_mask(block_q, block_k):
    """Exhaustive over small shapes: every skipped tile holds no visible
    pair, and every visible pair lies in a visited tile."""
    checked = 0
    for Sq, Sk, causal, window, n_sink in itertools.product(
            (1, 9, 40, 130, 300), (1, 9, 40, 130, 300), (True, False),
            (0, 1, 5, 16, 100), (0, 1, 8, 50)):
        if window == 0 and n_sink:
            continue
        vis = _visible(Sq, Sk, causal, window, n_sink)
        covered = np.zeros_like(vis)
        for q0 in range(0, Sq, block_q):
            for k0 in range(0, -(-Sk // block_k) * block_k + block_k, block_k):
                tile = vis[q0:q0 + block_q, k0:k0 + block_k]
                if tile_visited(k0, q0, block_q, block_k, Sk, causal=causal,
                                window=window, n_sink=n_sink):
                    covered[q0:q0 + block_q, k0:k0 + block_k] = True
                else:
                    assert not tile.any(), (Sq, Sk, causal, window, n_sink, q0, k0)
        assert not (vis & ~covered).any(), (Sq, Sk, causal, window, n_sink)
        checked += 1
    assert checked == 5 * 5 * 2 * (1 + 4 * 4)


def _attention_ref(qj, kj, vj, causal):
    """JAX's oracle in the model layout (its causal mask is bottom-right:
    held only where Sq == Sk)."""
    B, S, H, hd = qj.shape
    KV = kj.shape[2]
    flat = [t.transpose(0, 2, 1, 3).reshape(-1, t.shape[1], hd) for t in (qj, kj, vj)]
    o = attention_ref(*flat, n_q_heads_per_kv=H // KV, causal=causal)
    return o.reshape(B, H, S, hd).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal", [
    (1, 128, 128, 2, 2, 16, True),      # MHA
    (2, 192, 192, 6, 2, 32, True),      # GQA 3:1, three query tiles
    (1, 256, 256, 5, 1, 64, False),     # MQA, non-causal
    (1, 128, 128, 6, 2, 128, True),     # qwen2's head dim
    (1, 64, 192, 4, 2, 64, True),       # Sq < Sk, top-left mask
    (1, 192, 64, 4, 2, 32, True),       # Sq > Sk: rows past Sk see every key
    (1, 128, 64, 3, 1, 16, False),
])
def test_simt_tiled_vs_pallas_and_ref(B, Sq, Sk, H, KV, hd, causal):
    """The CUDA-core kernel's tile loop (64 x 64, P in f32) against the
    Pallas kernel in interpret mode at blocks of 64 (Sq and Sk multiples of
    them: its ragged key tail leaks) and, where Sq == Sk, against
    ``attention_ref``. f32: only sum order differs (2e-5)."""
    (qj, kj, vj), (qt, kt, vt) = _inputs(B, Sq, Sk, H, KV, hd, "f32", 50)
    got = flash_mha_tiled(qt, kt, vt, causal=causal, **_SIMT)
    close(got, jax_flash_mha(qj, kj, vj, causal=causal, block_q=64, block_k=64),
          TOL["flash_f32"])
    if Sq == Sk:
        close(got, _attention_ref(qj, kj, vj, causal), TOL["flash_f32"])


@pytest.mark.parametrize("B,S,H,KV,hd,window,n_sink", [
    (2, 200, 4, 2, 32, 64, 8),          # band edges inside the tiles
    (1, 300, 5, 5, 64, 100, 7),         # ragged window and sinks, MHA
    (1, 256, 4, 1, 128, 5, 0),          # window shorter than a tile, MQA
    (1, 330, 4, 2, 16, 64, 70),         # sinks past the first tile, skipped tiles
])
def test_simt_tiled_window_sink_vs_jax(B, S, H, KV, hd, window, n_sink):
    """Window and sinks: the tile loop at the CUDA-core kernel's tiles
    against the JAX model's attention (``repro.models.attention.attention``,
    the mask Hymba runs), f32."""
    (qj, kj, vj), (qt, kt, vt) = _inputs(B, S, S, H, KV, hd, "f32", 60)
    kw = dict(causal=True, window=window, n_sink=n_sink)
    close(flash_mha_tiled(qt, kt, vt, **kw, **_SIMT), jax_attention(qj, kj, vj, **kw),
          TOL["flash_f32"])


# (Sq, Sk, causal, window, n_sink): rows that see no key (Sk = 0; rows past
# Sk + window - 1 under a window without sinks), ragged tails, both masks
_LSE_CASES = [(200, 64, True, 16, 0), (5, 0, True, 0, 0), (333, 517, True, 0, 0),
              (517, 333, True, 100, 7), (77, 300, False, 0, 0), (130, 130, True, 5, 3)]


@pytest.mark.parametrize("Sq,Sk,causal,window,n_sink", _LSE_CASES)
def test_simt_tiled_lse_vs_logsumexp(Sq, Sk, causal, window, n_sink):
    """The twin's L (exp2 domain) against ``torch.logsumexp`` of the scaled
    visible scores over ln 2, 1e-5; a row that sees no key has L = +inf and
    an output of exactly 0, as the plain version gives."""
    B, H, KV, hd = 2, 4, 2, 32
    _, (q, k, v) = _inputs(B, Sq, Sk, H, KV, hd, "f32", 70)
    kw = dict(causal=causal, window=window, n_sink=n_sink)
    out, lse = flash_mha_tiled(q, k, v, return_lse=True, **kw, **_SIMT)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(H // KV, 2)) / hd ** 0.5
    rows, cols = torch.arange(Sq)[:, None], torch.arange(Sk)[None, :]
    seen = visible(rows, cols, Sk, causal=causal, window=window if causal else 0,
                   n_sink=n_sink if causal else 0).expand(Sq, Sk)
    want = torch.logsumexp(s.masked_fill(~seen, float("-inf")), -1) / math.log(2)
    empty = ~seen.any(1) if Sk else torch.ones(Sq, dtype=torch.bool)
    want[..., empty] = float("inf")
    close(lse, want, 1e-5)
    assert torch.all(out[:, empty] == 0)
    close(out, flash_mha_ref(q, k, v, **kw), TOL["flash_f32"])
    if causal and window and not n_sink and Sq > Sk:
        assert empty.any()          # the case holds rows that see no key


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_tensor_core_tiles_at_hd80_ragged_vs_attention_ref(dt):
    """HuBERT's pattern (non-causal, MHA, hd 80) at a ragged Sq = Sk = 300:
    the tensor-core kernel's tile loop (128 x 128, P rounded to the input
    dtype before P·V) against JAX's ``attention_ref``. f32: only sum order
    differs (2e-5); bf16: P and the output rounded to bf16 (3e-2)."""
    (qj, kj, vj), (qt, kt, vt) = _inputs(2, 300, 300, 4, 4, 80, dt, 80)
    got = flash_mha_tiled(qt, kt, vt, causal=False)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    close(got, _attention_ref(qj, kj, vj, False), TOL[f"flash_{dt}"])


# the card's rule for bf16 at hd 80 (chip_smoke.py FWD_HD80_SHARE): max
# |got - want| within this share of max |want|
HD80_BF16_SHARE = 2e-2


@pytest.mark.parametrize("fault", [None, "scale", "dropped_tile"])
def test_hd80_bf16_share_rule_at_hubert_length(fault):
    """The card's rule for bf16 at hd 80 at HuBERT's length (T 1500,
    non-causal, two heads), against JAX's ``attention_ref`` in f32 on the
    same bf16 inputs: the tensor-core tile loop (P in bf16) meets it; the
    same loop with the scale 1/sqrt(64) in place of 1/sqrt(80), or with the
    keys of the second 128-key tile dropped, fails it."""
    _, (q, k, v) = _inputs(1, 1500, 1500, 2, 2, 80, "bf16", 15)
    want = torch.from_numpy(np.array(_attention_ref(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)), False)))
    if fault == "scale":
        q = (q.float() * math.sqrt(80 / 64)).to(q.dtype)
    elif fault == "dropped_tile":
        k, v = (torch.cat((t[:, :128], t[:, 256:]), 1) for t in (k, v))
    got = flash_mha_tiled(q, k, v, causal=False).float()
    share = float((got - want).abs().max() / want.abs().max())
    assert (share <= HD80_BF16_SHARE) == (fault is None), share


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_tensor_core_route_by_dtype_and_head_dim(hd, dt):
    """The wrapper's route: a bf16 forward and a bf16 backward at hd 64, 80
    (HuBERT's) or 128 run on the tensor cores, f32 never does, nor bf16 at
    hd 16/32."""
    q = torch.empty((1, 1, 1, hd), dtype=_TDT[dt])
    assert flash_ops._tensor_cores(q) == (dt == "bf16" and hd in (64, 80, 128))
    assert flash_ops._tensor_cores(q, WGMMA_BWD_HEAD_DIMS) == (dt == "bf16"
                                                               and hd in (64, 80, 128))


@pytest.mark.parametrize("hd", WGMMA_HEAD_DIMS)
def test_wgmma_smem_plan_invariants(hd):
    """The tensor-core forward's shared-memory plan: the boxes tile hd
    exactly (hd 80 is not padded to 128), a box row fits its swizzle span,
    the 32-byte swizzle only where 160-byte rows rule out the 128-byte one,
    and one block's shared memory fits the card's 227 KiB."""
    p = wgmma_smem_plan(hd)
    assert p["boxes"] * p["box_cols"] == hd
    assert p["row_bytes"] == 2 * p["box_cols"] <= p["swizzle_bytes"]
    assert p["swizzle_bytes"] == (128 if hd % 64 == 0 else 32)
    # every box (Q: 128 rows, K/V: 128 keys) starts on a 256-byte swizzle atom
    assert (WGMMA_BLOCK_Q * p["row_bytes"]) % 256 == 0 and p["tile_bytes"] % 1024 == 0
    assert p["smem_bytes"] <= SMEM_PER_BLOCK
    if hd == 80:
        assert (p["box_cols"], p["boxes"]) == (16, 5)


def test_wgmma_smem_plan_refuses_other_head_dims():
    for hd in (16, 32, 96):
        with pytest.raises(ValueError, match="head dim"):
            wgmma_smem_plan(hd)


@pytest.mark.parametrize("hd", WGMMA_BWD_HEAD_DIMS)
def test_wgmma_bwd_smem_plan_invariants(hd):
    """The tensor-core backward's shared-memory plan (the twin of
    ``WCfg<HD>``): the boxes tile hd exactly, a box row fits its swizzle
    span, the 32-byte swizzle only at hd 80, every box starts on a swizzle
    atom and every tile on 1024 bytes, and two blocks an SM fit the SM's
    228 KiB with the 1 KiB it reserves per block (hd 64/128 keep their
    sizes of 66.6 and 98.0 KiB)."""
    p = wgmma_bwd_smem_plan(hd)
    assert p["boxes"] * p["box_cols"] == hd
    assert p["row_bytes"] == 2 * p["box_cols"] <= p["swizzle_bytes"]
    assert (p["swizzle_bytes"] == 32) == (hd == 80)
    assert p["box_bytes"] % (8 * p["row_bytes"]) == 0 and p["tile_bytes"] % 1024 == 0
    assert p["boxes"] * p["box_bytes"] == p["tile_bytes"] == SIMT_TILE * hd * 2
    assert 2 * (p["smem_bytes"] + SMEM_RESERVED_PER_BLOCK) <= SMEM_PER_SM
    want = {64: (68152, 3, 1), 80: (84536, 3, 5), 128: (100392, 2, 2)}[hd]
    assert (p["smem_bytes"], p["stages"], p["boxes"]) == want


def test_wgmma_bwd_smem_plan_refuses_other_head_dims():
    for hd in (16, 32, 96):
        with pytest.raises(ValueError, match="head dim"):
            wgmma_bwd_smem_plan(hd)
