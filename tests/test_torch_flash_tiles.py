"""The tile loop of the tensor-core flash kernel (``csrc/flash_attention_wgmma.cu``)
on the CPU, through its plain-torch emulation ``flash_mha_tiled``: against
the Pallas kernel in interpret mode, against the plain version under a
window and sinks, and the tile-skip predicate against the mask itself. The
kernel against the emulation on the card is in
``test_torch_kernels_cuda.py``.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import TOL, close, randn
from repro.kernels.flash_attention.ops import flash_mha as jax_flash_mha
from repro_torch.kernels.flash_attention.kernel import WGMMA_BLOCK_K, WGMMA_BLOCK_Q
from repro_torch.kernels.flash_attention.ref import (flash_mha_ref, flash_mha_tiled,
                                                     tile_visited)

_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
# (block_q, block_k): the kernel's tiles, and a smaller pair that puts
# several tiles in the small shapes
_TILES = [(WGMMA_BLOCK_Q, WGMMA_BLOCK_K), (64, 32)]


def _inputs(B, Sq, Sk, H, KV, hd, dt, seed):
    arrs = (randn(seed, (B, Sq, H, hd)), randn(seed + 1, (B, Sk, KV, hd)),
            randn(seed + 2, (B, Sk, KV, hd)))
    return ([jnp.asarray(a, _JDT[dt]) for a in arrs],
            [torch.from_numpy(a).to(_TDT[dt]) for a in arrs])


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 128, 2, 2, 64),       # MHA
    (2, 256, 6, 2, 128),      # GQA 3:1 at qwen2's head dim
    (1, 256, 5, 1, 64),       # MQA
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


@pytest.mark.parametrize("block_q,block_k", [(128, 128), (64, 32), (16, 48), (8, 8)])
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
