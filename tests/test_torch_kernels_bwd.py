"""The backward kernels' algorithms on the CPU, against ``jax.grad``.

The JAX package has no backward kernels: it differentiates its jnp
functions. So each backward here is held against ``jax.vjp`` of the
function its kernel's forward replaces, on the same numpy inputs and output
gradient:

* rmsnorm — the plain version's autograd (``rmsnorm_bwd_ref``, the
  wrapper's CPU path) against ``repro/kernels/rmsnorm/ref.py::rmsnorm_ref``,
  f32 1e-5;
* rmsnorm — the emulation of the backward kernel's lanes and orders of
  summation (``rmsnorm_bwd_tiled``), under each kind of plan, against the
  same, f32 1e-5;
* flash attention — the plain version's autograd (``flash_mha_bwd_ref``)
  and the emulation of the backward kernels (``flash_mha_bwd_tiled``: L
  from the forward's tile loop, the balanced dK/dV splits and their ordered
  sum, dQ) against ``repro/kernels/flash_attention/ref.py::attention_ref``
  (GQA, ragged S, hd 16, 32 and HuBERT's 80, Sq != Sk non-causal at hd
  80) and, under a window with sinks,
  ``repro/models/attention.py::attention``; f32 1e-4. With
  ``tensor_cores`` (P and dS rounded to bf16, as the wgmma kernels feed
  them) within 2e-2 of each gradient's max, the rule the card holds the
  bf16 kernel to; at hd 80 also on bf16 inputs (HuBERT's pattern at a
  ragged S, a causal GQA case), and at HuBERT's T 1500 beside two wrong
  kernels (dK x 1.1, dS without D) that must fail it. Sq = Sk, where the kernel's top-left causal mask and the
  oracle's bottom-right one agree (ROADMAP §3). The tile predicates and the
  split plan are checked against the mask itself.

* ssm_scan — the reverse scan ``ssm_scan_bwd_ref`` (the wrapper's CPU
  backward) against ``jax.vjp`` of ``repro/models/mamba.py::selective_scan``
  (an associative scan), for a in (0, 1) and ragged S and C, within 1e-4 of
  each gradient's max; the wrapper's autograd Function on the CPU; and the
  gradients of the Mamba mixer (whose in-place ``exp_`` and carried-state
  add sit under autograd), with and without ``torch.utils.checkpoint``,
  against ``jax.grad`` of the reference's.

The kernels themselves against these plain versions run on the card
(``test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""
import itertools
import math
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import randn
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro.models import mamba as jax_mamba
from repro.models.attention import attention as jax_attention
from repro_torch.kernels.flash_attention.kernel import BWD_SPLIT_UNITS, SIMT_TILE
from repro_torch.kernels.flash_attention.ops import flash_mha
from repro_torch.kernels.flash_attention.ref import (bwd_key_tile_rows, bwd_key_tile_visited,
                                                     bwd_split_plan, bwd_tile_needs_mask,
                                                     flash_mha_bwd_ref, flash_mha_bwd_tiled,
                                                     flash_mha_ref, flash_mha_tiled, visible)
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import (BWD_SCALAR, BWD_VECTOR, rmsnorm_bwd_plan,
                                             rmsnorm_bwd_ref, rmsnorm_bwd_tiled)
from repro_torch.kernels.ssm_scan.ops import ssm_scan_batched
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref, ssm_scan_ref
from repro_torch.models import mamba as t_mamba

RMS_TOL, FLASH_TOL = 1e-5, 1e-4
# the bf16 rule of the card (chip_smoke.py BWD_FLASH_BF16): max |got - want|
# within this share of max |want| for each gradient
FLASH_BF16_SHARE = 2e-2


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
    o = flash_mha_ref(qt, kt, vt, **mask)
    for got in (flash_mha_bwd_ref(qt, kt, vt, dot, **mask),
                flash_mha_bwd_tiled(qt, kt, vt, o, dot, **mask)):
        for g, w in zip(got, want):
            _close(g, w, FLASH_TOL)
    # the tensor-core twin: P and dS in bf16 before their products
    for g, w in zip(flash_mha_bwd_tiled(qt, kt, vt, o, dot, tensor_cores=True, **mask), want):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= FLASH_BF16_SHARE * float(np.abs(w).max())


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (2, 64, 4, 4, 16),        # G 1, one tile
    (2, 100, 4, 2, 16),       # G 2, ragged S: neither 64 nor 32 divides it
    (1, 150, 4, 1, 32),       # G 4 (MQA), ragged, several tiles
    (1, 96, 6, 3, 32),        # G 2, hd 32
    (2, 100, 4, 4, 80),       # HuBERT's hd 80, MHA, ragged S
    (1, 150, 4, 2, 80),       # hd 80, G 2, ragged, several tiles
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


@pytest.mark.parametrize("Sq,Sk,causal", [(100, 230, True), (230, 100, True), (77, 150, False)])
def test_flash_backward_tiled_sq_ne_sk_matches_autograd(Sq, Sk, causal):
    """Sq != Sk both ways under the top-left mask, where the JAX oracle's
    bottom-right mask disagrees (ROADMAP §3): the emulation against the
    plain version's autograd, f32."""
    q, k, v, do = (torch.from_numpy(randn(60 + i, shape)) for i, shape in enumerate(
        ((2, Sq, 4, 16), (2, Sk, 2, 16), (2, Sk, 2, 16), (2, Sq, 4, 16))))
    o = flash_mha_ref(q, k, v, causal=causal)
    for got, want in zip(flash_mha_bwd_tiled(q, k, v, o, do, causal=causal),
                         flash_mha_bwd_ref(q, k, v, do, causal=causal)):
        torch.testing.assert_close(got, want, rtol=FLASH_TOL, atol=FLASH_TOL)


@pytest.mark.parametrize("Sq,Sk,KV", [(77, 150, 2), (150, 77, 1)])
def test_flash_backward_hd80_sq_ne_sk_matches_jax_grad(Sq, Sk, KV):
    """HuBERT's head dim with Sq != Sk both ways (the VLM's cross shape),
    non-causal, where no mask alignment is in play: the plain backward and
    the emulation against jax.vjp of attention_ref, f32."""
    H, hd = 4, 80
    q, k, v, do = (randn(70 + i, shape) for i, shape in enumerate(
        ((2, Sq, H, hd), (2, Sk, KV, hd), (2, Sk, KV, hd), (2, Sq, H, hd))))

    def flat(a):
        return jnp.asarray(a).transpose(0, 2, 1, 3).reshape(-1, a.shape[1], hd)

    _, vjp = jax.vjp(lambda a, b, c: attention_ref(a, b, c, n_q_heads_per_kv=H // KV,
                                                   causal=False), flat(q), flat(k), flat(v))
    want = [np.asarray(g).reshape(2, heads, S, hd).transpose(0, 2, 1, 3)
            for g, heads, S in zip(vjp(flat(do)), (H, KV, KV), (Sq, Sk, Sk))]
    _check(q, k, v, do, want, causal=False)


def _bf16_shares(q, k, v, do, want, causal, fault=None):
    """max |got - want| / max |want| of dQ, dK, dV, got the tensor-core
    kernels' twin (``flash_mha_bwd_tiled(..., tensor_cores=True)``) on bf16
    inputs, its O the tensor-core forward's tile loop in bf16. ``fault``: a
    wrong kernel, "dk_x1.1" (its dK x 1.1) or "ds_without_d" (dS = P·dP: O
    zeroed, so D = rowsum(dO·O) is 0)."""
    qb, kb, vb, db = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do))
    o = flash_mha_tiled(qb, kb, vb, causal=causal)
    if fault == "ds_without_d":
        o = torch.zeros_like(o)
    got = list(flash_mha_bwd_tiled(qb, kb, vb, o, db, causal=causal, tensor_cores=True))
    assert all(g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all()) for g in got)
    if fault == "dk_x1.1":
        got[1] = got[1].float() * 1.1
    return [float(np.abs(g.float().numpy() - w).max() / np.abs(w).max())
            for g, w in zip(got, want)]


def _bf16_round(*arrays):
    return [torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in arrays]


@pytest.mark.parametrize("B,S,H,KV,causal", [
    (2, 300, 4, 4, False),    # HuBERT's pattern: MHA, non-causal, ragged S
    (1, 300, 6, 2, True),     # causal GQA, ragged S
])
def test_flash_backward_tensor_core_twin_hd80_bf16_matches_jax_grad(B, S, H, KV, causal):
    """The tensor-core backward at hd 80 (five 16-column boxes; P and dS
    rounded to bf16 before their products) on bf16 inputs, against jax.vjp
    of ``attention_ref`` in f32 on the same rounded inputs: within 2e-2 of
    each gradient's max (FLASH_BF16_SHARE, the card's rule)."""
    arrs = _bf16_round(*_flash_inputs(B, S, H, KV, 80, seed=90))
    want = _jax_grads_oracle(*arrs, causal)
    shares = _bf16_shares(*arrs, want, causal)
    assert max(shares) <= FLASH_BF16_SHARE, shares


@pytest.fixture(scope="module")
def hubert_length_case():
    """HuBERT's length (T 1500, non-causal, MHA hd 80), two heads: bf16
    inputs and jax.vjp of ``attention_ref`` on them in f32."""
    arrs = _bf16_round(*_flash_inputs(1, 1500, 2, 2, 80, seed=95))
    return arrs, _jax_grads_oracle(*arrs, False)


@pytest.mark.parametrize("fault", [None, "dk_x1.1", "ds_without_d"])
def test_hd80_bf16_backward_share_rule_at_hubert_length(fault, hubert_length_case):
    """The card's rule for the bf16 backward (each gradient within 2e-2 of
    its max) at T 1500: the tensor-core kernels' twin meets it on dQ, dK and
    dV; a wrong kernel fails it where it is wrong: dK x 1.1 on dK, dS
    without D on dQ and dK (dV = P^T dO does not read dS)."""
    arrs, want = hubert_length_case
    shares = _bf16_shares(*arrs, want, False, fault)
    failed = [n for n, sh in zip(("dq", "dk", "dv"), shares) if sh > FLASH_BF16_SHARE]
    assert failed == {None: [], "dk_x1.1": ["dk"], "ds_without_d": ["dq", "dk"]}[fault], shares


@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_delta_lane_map_reads_each_vector_once(hd, itemsize):
    """The D kernel's lanes (``bwd_delta_reads``, the twin of
    ``fa_bwd_delta``): every row of a 64-row tile gets one D, summed over
    each of its 16-byte vectors exactly once. A row's vectors spread over
    lanes rounded up to a power of two; the map before it (a lane per
    vector) covers hd 16/32/64/128 the same way but breaks at hd 80, where
    10 or 20 lanes a row straddle warps, the xor shuffle adds neighbouring
    rows and the passes leave the tile's last rows without a D."""
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
    from repro_torch.kernels.flash_attention.ref import bwd_delta_lanes, bwd_delta_reads

    assert hd in HEAD_DIMS
    parts = hd * itemsize // 16

    def sound(writes):
        return sorted(writes) == list(range(SIMT_TILE)) and all(
            len(w) == 1 and w[0] == Counter({(r, p): 1 for p in range(parts)})
            for r, w in writes.items())

    assert sound(bwd_delta_reads(hd, itemsize))
    lanes = bwd_delta_lanes(hd, itemsize)
    assert lanes & (lanes - 1) == 0 and parts <= lanes <= 32
    # the map before: one lane per vector
    assert sound(bwd_delta_reads(hd, itemsize, lanes=parts)) == (hd != 80)


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


_MASKS = [(True, 0, 0), (True, 40, 7), (True, 100, 0), (False, 0, 0), (True, 5, 0),
          (True, 64, 64)]


def _vis(Sq, Sk, causal, window, n_sink):
    return visible(torch.arange(Sq)[:, None], torch.arange(Sk)[None, :], Sk, causal=causal,
                   window=window, n_sink=n_sink).expand(Sq, Sk)


@pytest.mark.parametrize("causal,window,n_sink", _MASKS)
def test_backward_tile_skip_drops_only_masked_tiles(causal, window, n_sink):
    """At every tile position of the backward's SIMT_TILE grid: every key
    tile the dQ kernels skip holds no visible pair for its query tile, and
    every tile ``bwd_tile_needs_mask`` lets through unmasked is all visible."""
    Sq, Sk = 320, 300
    kw = dict(causal=causal, window=window, n_sink=n_sink)
    vis = _vis(Sq, Sk, causal, window if causal else 0, n_sink if causal else 0)
    for q0, k0 in itertools.product(range(0, Sq, SIMT_TILE), range(0, Sk, SIMT_TILE)):
        tile = vis[q0:q0 + SIMT_TILE, k0:k0 + SIMT_TILE]
        if not bwd_key_tile_visited(k0, q0, Sk, **kw):
            assert not tile.any(), (q0, k0)
        if not bwd_tile_needs_mask(q0, k0, Sq, Sk, **kw):
            assert tile.shape == (SIMT_TILE, SIMT_TILE) and tile.all(), (q0, k0)


@pytest.mark.parametrize("Sq,Sk", [(320, 300), (300, 320), (1024, 1024), (40, 40), (65, 1)])
@pytest.mark.parametrize("causal,window,n_sink", _MASKS)
@pytest.mark.parametrize("G", [1, 6])
def test_backward_split_plan_covers_each_visible_pair_once(Sq, Sk, causal, window, n_sink, G):
    """The dK/dV plan: each key tile's rows [q_lo, q_lo + n_qt·SIMT_TILE)
    hold every row that sees one of its keys; its items partition its G·n_qt
    units in order, none above BWD_SPLIT_UNITS; slots run 0, 1, ..."""
    kw = dict(causal=causal, window=window, n_sink=n_sink)
    vis = _vis(Sq, Sk, causal, window if causal else 0, n_sink if causal else 0)
    plan = bwd_split_plan(Sq, Sk, G, **kw)
    assert [it.slot for it in plan] == list(range(len(plan)))
    for j in range(-(-Sk // SIMT_TILE)):
        q_lo, n_qt = bwd_key_tile_rows(j, Sq, Sk, **kw)
        seen = vis[:, j * SIMT_TILE:(j + 1) * SIMT_TILE].any(1)
        inside = torch.zeros(Sq, dtype=torch.bool)
        inside[q_lo:q_lo + n_qt * SIMT_TILE] = True
        assert not (seen & ~inside).any(), j
        units = [u for it in plan if it.j == j for u in range(it.u0, it.u1)]
        assert units == list(range(G * n_qt)), j
        assert all(it.u1 - it.u0 <= BWD_SPLIT_UNITS and it.n_qt == n_qt and it.q_lo == q_lo
                   for it in plan if it.j == j)


@pytest.mark.parametrize("q_off", [37, 64, 200])
@pytest.mark.parametrize("causal,window,n_sink", _MASKS)
def test_backward_tile_predicates_and_plan_with_row_offset(causal, window, n_sink, q_off):
    """A query shard of 130 rows from global row ``q_off`` against 400 keys:
    the dQ kernels' skipped tiles hold no visible pair, the unmasked ones
    are all visible, and each key tile's rows [q_lo, q_lo + n_qt·SIMT_TILE)
    (local tiles from row 0) hold every row that sees one of its keys."""
    Sq, Sk, G = 130, 400, 3
    kw = dict(causal=causal, window=window, n_sink=n_sink, q_off=q_off)
    vis = visible(torch.arange(Sq)[:, None], torch.arange(Sk)[None, :], Sk,
                  **kw).expand(Sq, Sk)
    for q0, k0 in itertools.product(range(0, Sq, SIMT_TILE), range(0, Sk, SIMT_TILE)):
        tile = vis[q0:q0 + SIMT_TILE, k0:k0 + SIMT_TILE]
        if not bwd_key_tile_visited(k0, q0, Sk, **kw):
            assert not tile.any(), (q0, k0)
        if not bwd_tile_needs_mask(q0, k0, Sq, Sk, **kw):
            assert tile.shape == (SIMT_TILE, SIMT_TILE) and tile.all(), (q0, k0)
    plan = bwd_split_plan(Sq, Sk, G, **kw)
    for j in range(-(-Sk // SIMT_TILE)):
        q_lo, n_qt = bwd_key_tile_rows(j, Sq, Sk, **kw)
        assert q_lo % SIMT_TILE == 0
        seen = vis[:, j * SIMT_TILE:(j + 1) * SIMT_TILE].any(1)
        inside = torch.zeros(Sq, dtype=torch.bool)
        inside[q_lo:q_lo + n_qt * SIMT_TILE] = True
        assert not (seen & ~inside).any(), j
        units = [u for it in plan if it.j == j for u in range(it.u0, it.u1)]
        assert units == list(range(G * n_qt)), j


@pytest.mark.parametrize("S,causal,window,n_sink", [(150, True, 0, 0), (130, False, 0, 0),
                                                    (200, True, 64, 20), (9, True, 0, 0)])
def test_forward_lse_is_the_row_logsumexp(S, causal, window, n_sink):
    """L as the forward's tile loop returns it for the backward: the row's
    logsumexp of the scaled scores in the exp2 domain (torch.logsumexp ·
    log2(e)), +inf for a row that sees no key."""
    q, k, v = (torch.from_numpy(randn(40 + i, (2, S, 4, 16))) for i in range(3))
    _, lse = flash_mha_tiled(q, k, v, causal=causal, window=window, n_sink=n_sink,
                             return_lse=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / 4.0
    seen = _vis(S, S, causal, window, n_sink)
    want = torch.logsumexp(s.masked_fill(~seen, float("-inf")), -1) * math.log2(math.e)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)


_RMS_PLANS = [   # (rows, d, dtype, aligned): lanes a row below, at and above a warp; scalar
    (300, 64, torch.float32, True), (96, 1536, torch.float32, True),
    (96, 1536, torch.bfloat16, True), (40, 2000, torch.float32, True),
    (20, 8192, torch.bfloat16, True), (37, 100, torch.bfloat16, True),
    (50, 96, torch.float32, False),
]


@pytest.mark.parametrize("rows,d,dtype,aligned", _RMS_PLANS)
def test_rmsnorm_backward_tiled_matches_jax_grad(rows, d, dtype, aligned):
    """The kernel's sum order (``rmsnorm_bwd_tiled`` under the plan the
    kernel takes, 7 blocks at most so rows split across blocks) against
    jax.vjp of the reference on the same f32 inputs."""
    x, w, g = randn(50, (rows, d)), 1 + 0.1 * randn(51, (d,)), randn(52, (rows, d))
    plan = rmsnorm_bwd_plan(rows, d, dtype, aligned, 7)
    assert plan.variant == (BWD_VECTOR if aligned and d % (16 // dtype.itemsize) == 0
                            else BWD_SCALAR)
    _, vjp = jax.vjp(lambda a, b: jax_rmsnorm_ref(a, b, eps=1e-6), jnp.asarray(x),
                     jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    dx, dw = rmsnorm_bwd_tiled(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g),
                               1e-6, plan)
    _close(dx, jdx, RMS_TOL)
    _close(dw, jdw, RMS_TOL)


def test_library_hash_covers_every_csrc_file(tmp_path, monkeypatch):
    """The built library's name hashes every file under kernels/csrc, the
    headers the sources include among them: an edit to a header alone must
    name another library (a stale build is never loaded)."""
    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in _build.csrc_files():
        (csrc / src.name).write_bytes(src.read_bytes())
    assert any(p.suffix == ".cuh" for p in csrc.iterdir())
    monkeypatch.setattr(_build, "_CSRC", csrc)
    before = _build.library_path()
    header = csrc / "flash_wgmma.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    assert _build.library_path() != before
    header.write_bytes(header.read_bytes()[:-len(b"\n// edited\n")])
    assert _build.library_path() == before


# -- ssm_scan ---------------------------------------------------------------

SCAN_BWD_SHARE = 1e-4


def _scan_inputs(shape, seed):
    a = 1.0 / (1.0 + np.exp(-randn(seed, shape)))           # in (0, 1)
    return a.astype(np.float32), randn(seed + 1, shape), randn(seed + 2, shape)


def _share_close(got, want, share):
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= share * np.abs(want).max(), (err, np.abs(want).max())


@jax.jit
def _jax_scan_vjp(a, b, g):
    return jax.vjp(jax_mamba.selective_scan, a, b)[1](g)


@pytest.mark.parametrize("shape", [(37, 100), (3, 45, 130), (1, 1, 7), (2, 129, 33)])
def test_ssm_scan_backward_matches_jax_grad(shape):
    a, b, g = _scan_inputs(shape, 40)
    as4 = (lambda t: t[None, ..., None]) if len(shape) == 2 else (lambda t: t[..., None])
    jda, jdb = (np.asarray(t).reshape(shape) for t in _jax_scan_vjp(
        *(jnp.asarray(as4(x)) for x in (a, b, g))))
    at, bt, gt = (torch.from_numpy(x) for x in (a, b, g))
    da, db = ssm_scan_bwd_ref(at, ssm_scan_ref(at, bt), gt)
    assert da.dtype == db.dtype == torch.float32 and da.shape == db.shape == shape
    _share_close(da, jda, SCAN_BWD_SHARE)
    _share_close(db, jdb, SCAN_BWD_SHARE)


def test_ssm_scan_backward_keeps_the_input_dtype():
    a, b, g = (torch.from_numpy(x).bfloat16() for x in _scan_inputs((2, 50, 33), 44))
    da, db = ssm_scan_bwd_ref(a, ssm_scan_ref(a, b), g)
    assert da.dtype == db.dtype == torch.bfloat16
    want = ssm_scan_bwd_ref(*(t.float() for t in (a, ssm_scan_ref(a, b), g)))
    for got, w in zip((da, db), want):
        torch.testing.assert_close(got.float(), w, rtol=1e-2, atol=1e-2 * float(w.abs().max()))


def test_ssm_scan_wrapper_cpu_path_runs_the_reverse_scan():
    """Under autograd on the CPU the wrapper's Function runs the plain
    forward and ``ssm_scan_bwd_ref``, counting no launch; its gradients
    equal autograd through the plain loop."""
    a, b, g = (torch.from_numpy(x) for x in _scan_inputs((2, 40, 24), 48))
    ar, br = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    ref_out = ssm_scan_ref(ar, br)
    want = torch.autograd.grad(ref_out, (ar, br), g)
    before = ssm_scan_batched.launches, ssm_scan_batched.bwd_launches
    ar, br = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    out = ssm_scan_batched(ar, br)
    assert type(out.grad_fn).__name__ == "_SsmScanFnBackward"
    assert torch.equal(out.detach(), ref_out.detach())
    out.backward(g)
    assert (ssm_scan_batched.launches, ssm_scan_batched.bwd_launches) == before
    h = ssm_scan_ref(a, b)
    assert torch.equal(ar.grad, ssm_scan_bwd_ref(a, h, g)[0])
    assert torch.equal(br.grad, ssm_scan_bwd_ref(a, h, g)[1])
    for got, w in zip((ar.grad, br.grad), want):
        torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-5)


_M = dict(B=2, S=13, DI=24, N=8, DTR=4, K=4)


def _mamba_tree(seed):
    B, S, DI, N, DTR, K = (_M[k] for k in ("B", "S", "DI", "N", "DTR", "K"))
    return dict(
        x_in=randn(seed, (B, S, DI)), z=randn(seed + 1, (B, S, DI)),
        conv_w=0.1 * randn(seed + 2, (DI, K)),
        w_x=randn(seed + 3, (DI, DTR + 2 * N)) / DI ** 0.5,
        w_dt=randn(seed + 4, (DTR, DI)) / DTR ** 0.5,
        b_dt=0.1 * randn(seed + 5, (DI,)), a_log=0.1 * randn(seed + 6, (DI, N)),
        d_skip=np.ones((DI,), np.float32))


_MAMBA_ARGS = ("x_in", "z", "conv_w", "w_x", "w_dt", "b_dt", "a_log", "d_skip")


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("remat", [False, True])
def test_mamba_mix_gradients_match_jax_grad(carried, remat):
    """The port's Mamba mixer under autograd (the scan's Function, the
    in-place ``exp_`` and, with a carried state, the in-place add into the
    first step), optionally under non-reentrant checkpointing, against
    ``jax.grad`` of the reference's mixer; 1e-4 of each gradient's max."""
    tree = _mamba_tree(60)
    B, DI, N, K = _M["B"], _M["DI"], _M["N"], _M["K"]
    conv, ssm = randn(70, (B, DI, K - 1)), randn(71, (B, DI, N))
    cot = randn(72, (B, _M["S"], DI))
    kw = dict(n_state=N, dt_rank=_M["DTR"])

    def jloss(args):
        st = jax_mamba.MambaState(jnp.asarray(conv), jnp.asarray(ssm)) if carried else None
        return jnp.sum(jax_mamba.mamba_mix(*args, state=st, **kw) * cot)

    want = jax.jit(jax.grad(jloss))([jnp.asarray(tree[k]) for k in _MAMBA_ARGS])
    leaves = [torch.from_numpy(tree[k]).requires_grad_(True) for k in _MAMBA_ARGS]

    def tloss(*args):
        st = (t_mamba.MambaState(torch.from_numpy(conv), torch.from_numpy(ssm))
              if carried else None)
        return (t_mamba.mamba_mix(*args, state=st, **kw) * torch.from_numpy(cot)).sum()

    loss = (torch.utils.checkpoint.checkpoint(tloss, *leaves, use_reentrant=False) if remat
            else tloss(*leaves))
    for name, got, w in zip(_MAMBA_ARGS, torch.autograd.grad(loss, leaves), want):
        _share_close(got, w, SCAN_BWD_SHARE)
