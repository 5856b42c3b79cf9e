"""Plain PyTorch version of the flash attention kernel, in the model layout.

It computes the function of ``repro/kernels/flash_attention/kernel.py``
(``flash_attention_kernel``): f32 scores scaled by 1/sqrt(hd), the causal
mask ``col <= row`` aligned TOP-LEFT, masked scores set to NEG = -1e30, p =
0 where s <= NEG/2, and the sum divided by max(l, 1e-30), so a row that
sees no key comes out as 0. ``flash_mha_ref`` takes the query rows in
chunks, as the reference's ``repro/models/attention.py::attention`` does
(``q_chunk`` 512: the largest divisor of Sq not above Sq / 512 chunks), and
under autograd runs each chunk inside ``torch.utils.checkpoint``, so neither
pass holds more than one chunk's [B, KV, G, Sc, Sk] scores;
``flash_mha_unchunked`` is the same function in one shot, an oracle for the
tests that no model path calls.

Sliding window and sinks (Hymba, the mask of ``repro/models/attention.py::
attention`` and ``sink_banded_attention``): under ``causal``, key ``col``
is visible from query ``row`` when

  col <= row and (window == 0 or col > row - window or col < n_sink).

Without ``causal`` neither ``window`` nor ``n_sink`` masks anything, as in
the reference ``attention``.

Row offset (sequence-parallel attention): ``q_off`` is the global index of
q's first row, so row ``r`` of q is row ``q_off + r`` of the mask above,
against the whole K and V; the reference's chunks take their rows from a
global index the same way (``row = i * Sc + ...``). It acts only under
``causal``. Every function below that takes a mask takes ``q_off``; at 0
each computes what it computed without it.

Mask hazard: the JAX oracle ``repro/kernels/flash_attention/ref.py::
attention_ref`` aligns its causal mask BOTTOM-RIGHT (``tril(k=Sk-Sq)``). It
agrees with the Pallas kernel only when Sq == Sk. This version, the CUDA
kernel and the port follow the kernel (top-left); a test with Sq != Sk is
held against the Pallas kernel, never against ``attention_ref``.

The backward's plain version is autograd of ``flash_mha_ref``
(``flash_mha_bwd_ref``), the counterpart of ``jax.grad`` of the reference.
``flash_mha_bwd_tiled`` emulates the backward kernels
(``csrc/flash_attention_bwd.cu``) for the tests: L read from the forward's
twin (``flash_mha_tiled(..., return_lse=True)``, exp2 domain) and D =
rowsum(dO·O); dK, dV as one f32 partial per item of ``bwd_split_plan`` (a
split of a key tile's (head, query tile) units, walked in order), the
partials of a key tile added in split order; dQ per query tile over the key
tiles ``bwd_key_tile_visited`` keeps; P recomputed as exp2(s·scale·log2(e)
− L) under the forward's mask; with ``tensor_cores``, P and dS rounded to
bf16 before their products, as the wgmma kernels feed them.

``flash_mha_tiled`` emulates the tile loop of both forward kernels for the
tests: the same key tiles, chosen by ``tile_visited`` (the twin of the
kernels' predicate), the same online softmax per tile on raw scores with
``exp2``, ``l`` summed over the f32 p. At ``WGMMA_BLOCK_Q`` x
``WGMMA_BLOCK_K`` with P rounded to the input dtype before ``P·V``, the
tensor-core kernel (``csrc/flash_attention_wgmma.cu``); at ``SIMT_TILE``
x ``SIMT_TILE`` with ``tensor_cores=False`` (P stays f32), the CUDA-core
kernel (``csrc/flash_attention.cu``). Nothing on the model path calls it.
"""
from __future__ import annotations

import math
from collections import Counter

import torch

from typing import NamedTuple

import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .kernel import BWD_SPLIT_UNITS, SIMT_TILE, WGMMA_BLOCK_K, WGMMA_BLOCK_Q, lse_rows

# threads of a block of the backward's kernels (kThreads)
_BLOCK_THREADS = 256

__all__ = ["NEG", "Q_CHUNK", "q_chunks", "flash_mha_ref", "flash_mha_unchunked",
           "flash_mha_bwd_ref", "tile_visited", "flash_mha_tiled",
           "visible", "bwd_key_tile_visited", "bwd_tile_needs_mask", "bwd_key_tile_rows",
           "BwdItem", "bwd_split_plan", "bwd_delta_lanes", "bwd_delta_reads",
           "flash_mha_bwd_tiled"]

NEG = -1e30
# query rows a chunk of the plain version aims at (the reference's q_chunk)
Q_CHUNK = 512


def q_chunks(Sq: int) -> int:
    """Chunks of the plain version's query rows: the reference's rule,
    max(1, Sq // Q_CHUNK) lowered until it divides Sq."""
    n = max(1, Sq // Q_CHUNK)
    while Sq % n:
        n -= 1
    return n


def _hidden(rows: torch.Tensor, cols: torch.Tensor, window: int, n_sink: int) -> torch.Tensor:
    """The causal mask's hidden pairs of global ``rows`` x ``cols``."""
    hidden = cols > rows
    if window > 0:
        hidden = hidden | ((cols <= rows - window) & (cols >= n_sink))
    return hidden


def flash_mha_unchunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0, n_sink: int = 0,
                        q_off: int = 0) -> torch.Tensor:
    """``flash_mha_ref``'s function with every row's scores at once
    (``[B,KV,G,Sq,Sk]`` f32): one chunk of it, and the tests' oracle."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * scale
    if causal:
        rows = q_off + torch.arange(Sq, device=q.device)[:, None]
        cols = torch.arange(Sk, device=q.device)[None, :]
        s = s.masked_fill(_hidden(rows, cols, window, n_sink), NEG)
    m = (s.amax(dim=-1, keepdim=True) if Sk
         else s.new_zeros(s.shape[:-1] + (1,)))
    # each score-sized tensor let go as soon as the next is made (no grad:
    # two at a time, the dry-run's peak)
    dead = s <= NEG / 2
    p = s - m
    del s
    p = torch.exp(p)
    p = torch.where(dead, torch.zeros((), device=p.device), p)
    del dead
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    p = p / l
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def flash_mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, n_sink: int = 0,
                  q_off: int = 0) -> torch.Tensor:
    """q [B,Sq,H,hd], k/v [B,Sk,KV,hd] -> [B,Sq,H,hd] in q.dtype (f32 math).

    GQA: q head h reads kv head h // (H // KV). Rows in ``q_chunks(Sq)``
    chunks; under autograd each chunk is checkpointed (the reference's
    ``remat_chunk``), so the backward recomputes one chunk's scores at a
    time.
    """
    Sq = q.shape[1]
    n = q_chunks(Sq)
    Sc = Sq // n
    remat = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)
    outs = []
    for i in range(n):
        args = (q[:, i * Sc:(i + 1) * Sc], k, v)
        kw = dict(causal=causal, window=window, n_sink=n_sink, q_off=q_off + i * Sc)
        if remat:
            outs.append(checkpoint(flash_mha_unchunked, *args, use_reentrant=False,
                                   preserve_rng_state=False, **kw))
        else:
            outs.append(flash_mha_unchunked(*args, **kw))
    return outs[0] if n == 1 else torch.cat(outs, dim=1)


def tile_visited(k0: int, q0: int, block_q: int, block_k: int, Sk: int, *,
                 causal: bool, window: int = 0, n_sink: int = 0, q_off: int = 0) -> bool:
    """Does key tile [k0, k0+block_k) hold a visible pair for some row of
    query tile [q0, q0+block_q)? The twin of ``tile_visited`` in
    ``csrc/flash_attention_wgmma.cu`` (and, at 64 x 64, of
    ``key_tile_visited`` in ``csrc/flash_simt.cuh``): a tile it skips would
    only add p = 0 with m unchanged. ``q0`` is local: the tile's global
    first row is ``q_off + q0``."""
    if k0 >= Sk:
        return False
    if not causal:
        return True
    q0 += q_off
    if k0 >= q0 + block_q:                    # wholly past the last row
        return False
    # under a window: not wholly between the sinks and the band of row q0
    return window == 0 or k0 < n_sink or k0 + block_k > q0 - window + 1


def flash_mha_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, n_sink: int = 0, q_off: int = 0,
                    block_q: int = WGMMA_BLOCK_Q, block_k: int = WGMMA_BLOCK_K,
                    return_lse: bool = False, tensor_cores: bool = True):
    """A forward kernel's tile loop in plain torch; same signature and
    result as ``flash_mha_ref`` up to sum order and the rounding of P
    (``tensor_cores``: P rounded to q.dtype before P·V, as the tensor-core
    kernel feeds it; else P stays f32, as on the CUDA cores). With
    ``return_lse``, also each row's logsumexp as the forward stores it for
    the backward: [B, H, Sq] f32, m·scale·log2(e) + log2(l), +inf where no
    key is visible."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale_log2 = (1.0 / math.sqrt(hd)) * math.log2(math.e)
    qf = q.float().permute(0, 2, 1, 3)                           # [B,H,Sq,hd]
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(G, 1)   # [B,H,Sk,hd]
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(G, 1)
    out = torch.zeros(B, H, Sq, hd, device=q.device)
    lse = torch.full((B, H, Sq), float("inf"), device=q.device)
    for q0 in range(0, Sq, block_q):
        q1 = min(q0 + block_q, Sq)
        rows = q_off + torch.arange(q0, q1, device=q.device)[:, None]
        m = torch.full((B, H, q1 - q0, 1), NEG, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, H, q1 - q0, hd, device=q.device)
        for k0 in range(0, Sk, block_k):
            if not tile_visited(k0, q0, block_q, block_k, Sk, causal=causal,
                                window=window, n_sink=n_sink, q_off=q_off):
                continue
            k1 = min(k0 + block_k, Sk)
            s = qf[:, :, q0:q1] @ kf[:, :, k0:k1].transpose(-1, -2)  # raw scores
            if causal:
                cols = torch.arange(k0, k1, device=q.device)[None, :]
                s = s.masked_fill(_hidden(rows, cols, window, n_sink), NEG)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp2((m - m_new) * scale_log2)
            p = torch.where(s <= NEG / 2, torch.zeros((), device=s.device),
                            torch.exp2(s * scale_log2 - m_new * scale_log2))
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            if tensor_cores:
                p = p.to(q.dtype).float()            # P enters P·V in q.dtype
            acc = acc * alpha + p @ vf[:, :, k0:k1]
            m = m_new
        out[:, :, q0:q1] = acc / l.clamp_min(1e-30)
        lse[:, :, q0:q1] = torch.where(l[..., 0] > 0, m[..., 0] * scale_log2
                                       + torch.log2(l[..., 0]), lse[:, :, q0:q1])
    out = out.permute(0, 2, 1, 3).to(q.dtype)
    return (out, lse) if return_lse else out


def flash_mha_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      dout: torch.Tensor, *, causal: bool = True, window: int = 0,
                      n_sink: int = 0, q_off: int = 0):
    """(dq, dk, dv) of ``flash_mha_ref`` for the output gradient ``dout``, by
    autograd (its chunks recomputed one at a time)."""
    with torch.enable_grad():
        qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = flash_mha_ref(qr, kr, vr, causal=causal, window=window, n_sink=n_sink,
                            q_off=q_off)
        return torch.autograd.grad(out, (qr, kr, vr), dout)


def visible(rows: torch.Tensor, cols: torch.Tensor, Sk: int, *, causal: bool,
            window: int = 0, n_sink: int = 0, q_off: int = 0) -> torch.Tensor:
    """The forward's mask as a boolean [rows, cols] grid of local ``rows``:
    the twin of the backward kernel's ``visible`` (ragged key tail
    included)."""
    ok = cols < Sk
    if causal:
        ok = ok & ~_hidden(rows + q_off, cols, window, n_sink)
    return ok


def bwd_key_tile_visited(k0: int, q0: int, Sk: int, *, causal: bool, window: int = 0,
                         n_sink: int = 0, q_off: int = 0) -> bool:
    """The dQ kernels' ``key_tile_visited``: does key tile [k0, k0+SIMT_TILE)
    hold a visible pair for a row of [q0, q0+SIMT_TILE)?"""
    return tile_visited(k0, q0, SIMT_TILE, SIMT_TILE, Sk, causal=causal, window=window,
                        n_sink=n_sink, q_off=q_off)


def bwd_tile_needs_mask(q0: int, k0: int, Sq: int, Sk: int, *, causal: bool,
                        window: int = 0, n_sink: int = 0, q_off: int = 0) -> bool:
    """The kernels' ``tile_needs_mask``: False only when every pair of the
    tile [q0, q0+SIMT_TILE) x [k0, k0+SIMT_TILE) is visible (``q0`` local,
    the ragged tail counted in local rows, the mask in global ones)."""
    t = SIMT_TILE
    if q0 + t > Sq or k0 + t > Sk:
        return True
    if not causal:
        return False
    q0 += q_off
    if k0 + t - 1 > q0:
        return True
    return window > 0 and k0 <= q0 + t - 1 - window and k0 + t > n_sink


def bwd_key_tile_rows(j: int, Sq: int, Sk: int, *, causal: bool, window: int = 0,
                      n_sink: int = 0, q_off: int = 0) -> tuple:
    """(q_lo, n_qt): the SIMT_TILE-row query tiles q_lo, q_lo + SIMT_TILE, ...
    (local rows, tiles counted from row 0) that can see key tile j
    (``key_tile_rows`` in the kernel). Global row ``q_off + r`` sees the
    tile from row k0 on, and under a window (k0 past the sinks) up to the
    row before its last key + window."""
    k0 = j * SIMT_TILE
    if k0 >= Sk:
        return 0, 0
    lo, hi = 0, Sq
    if causal:
        lo = max(0, k0 - q_off) // SIMT_TILE * SIMT_TILE
        if window > 0 and k0 >= n_sink:
            hi = min(Sq, min(Sk, k0 + SIMT_TILE) - 1 + window - q_off)
    return lo, (-(-(hi - lo) // SIMT_TILE) if hi > lo else 0)


class BwdItem(NamedTuple):
    """One dK/dV block: key tile j, units [u0, u1) of its G·n_qt (unit u is
    head u // n_qt, query tile q_lo + (u % n_qt)·SIMT_TILE), partial slot."""
    j: int
    q_lo: int
    n_qt: int
    u0: int
    u1: int
    slot: int


def bwd_split_plan(Sq: int, Sk: int, G: int, *, causal: bool, window: int = 0,
                   n_sink: int = 0, q_off: int = 0) -> list:
    """The dK/dV blocks of one (b, kv head), in block order (``find_item``
    in the kernel): each key tile's units in ceil(units / BWD_SPLIT_UNITS)
    equal splits."""
    if not causal:
        window = n_sink = q_off = 0
    items = []
    for j in range(-(-Sk // SIMT_TILE)):
        q_lo, n_qt = bwd_key_tile_rows(j, Sq, Sk, causal=causal, window=window,
                                       n_sink=n_sink, q_off=q_off)
        units = G * n_qt
        ns = -(-units // BWD_SPLIT_UNITS)
        for s in range(ns):
            chunk = -(-units // ns)
            items.append(BwdItem(j, q_lo, n_qt, s * chunk, min(units, (s + 1) * chunk),
                                 len(items)))
    return items


def bwd_delta_lanes(hd: int, itemsize: int) -> int:
    """Lanes of one row in the D kernel (``fa_bwd_delta``): the row's
    16-byte vectors rounded up to a power of two (``pow2_ceil``)."""
    parts = hd * itemsize // 16
    return 1 << (parts - 1).bit_length()


def bwd_delta_reads(hd: int, itemsize: int, lanes: int | None = None) -> dict:
    """The twin of ``fa_bwd_delta``'s lane map and row reduction over one
    SIMT_TILE-row tile: for each row, the list of what the threads that
    write its D summed, each a Counter of the (row, 16-byte vector) pairs
    loaded by the lanes whose sums reached the writer through the kernel's
    xor shuffles (lane ^ w for w = lanes // 2, halved down to 1). A sound map
    writes every row once, each vector of it counted once. ``lanes``
    overrides the kernel's choice (``bwd_delta_lanes``) to show another
    map."""
    parts = hd * itemsize // 16
    lanes = lanes or bwd_delta_lanes(hd, itemsize)
    rows_per_pass = _BLOCK_THREADS // lanes
    passes = SIMT_TILE // rows_per_pass if rows_per_pass < SIMT_TILE else 1
    writes: dict = {}
    for i in range(passes):
        acc = []
        for t in range(_BLOCK_THREADS):
            r, part = i * rows_per_pass + t // lanes, t % lanes
            acc.append(Counter({(r, part): 1}) if part < parts and r < SIMT_TILE
                       else Counter())
        w = lanes // 2
        while w > 0:                 # w < 32: lane t ^ w is in t's warp
            acc = [acc[t] + acc[t ^ w] for t in range(_BLOCK_THREADS)]
            w //= 2
        for t in range(_BLOCK_THREADS):
            r = i * rows_per_pass + t // lanes
            if t % lanes == 0 and r < SIMT_TILE:
                writes.setdefault(r, []).append(acc[t])
    return writes


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def flash_mha_bwd_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, n_sink: int = 0, q_off: int = 0,
                        lse: torch.Tensor | None = None, tensor_cores: bool = False):
    """The backward kernels in plain torch, f32 math: (dq, dk, dv) in the
    dtypes of q and k, from the forward's inputs, its output ``o``, its L
    (``lse`` [B, H, Sq], exp2 domain; by default from ``flash_mha_tiled``)
    and ``dout``. ``tensor_cores``: P and dS rounded to bf16 before the
    products they enter, as in the wgmma kernels."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    if not causal:
        window = n_sink = q_off = 0
    mask = dict(causal=causal, window=window, n_sink=n_sink, q_off=q_off)
    if lse is None:
        _, lse = flash_mha_tiled(q, k, v, return_lse=True, **mask)
    scale = 1.0 / math.sqrt(hd)
    sl2 = scale * math.log2(math.e)
    t = SIMT_TILE
    dev = q.device
    rnd = _bf16 if tensor_cores else (lambda x: x)
    sq_pad, sk_pad = lse_rows(Sq), -(-Sk // t) * t

    def rows_of(x, pad):            # [B,S,heads,hd] -> [B,heads,S_pad,hd] f32
        x = x.float().permute(0, 2, 1, 3)
        return F.pad(x, (0, 0, 0, pad - x.shape[2]))

    qf, of, df = (rows_of(x, sq_pad) for x in (q, o, dout))              # [B,H,Sq_pad,hd]
    kf, vf = (rows_of(x, sk_pad) for x in (k, v))                        # [B,KV,Sk_pad,hd]
    L = F.pad(lse.float(), (0, sq_pad - Sq))                             # [B,H,Sq_pad]
    D = (df * of).sum(-1)                                                # 0 past Sq

    def probs(s, Lr, Dr, dp, rows, cols):
        p = torch.where(visible(rows, cols, Sk, **mask) & (rows < Sq),
                        torch.exp2(s * sl2 - Lr), torch.zeros((), device=dev))
        return p, p * (dp - Dr)

    # dK, dV: one partial per item, a key tile's partials added in split order
    dk = torch.zeros(B, KV, sk_pad, hd, device=dev)
    dv = torch.zeros_like(dk)
    qg, dg = qf.unflatten(1, (KV, G)), df.unflatten(1, (KV, G))          # [B,KV,G,S,hd]
    Lg, Dg = L.unflatten(1, (KV, G)), D.unflatten(1, (KV, G))
    for it in bwd_split_plan(Sq, Sk, G, **mask):
        k0 = it.j * t
        kt, vt = kf[:, :, k0:k0 + t], vf[:, :, k0:k0 + t]
        cols = torch.arange(k0, k0 + t, device=dev)[:, None]             # keys down
        pk = torch.zeros(B, KV, t, hd, device=dev)
        pv = torch.zeros_like(pk)
        for u in range(it.u0, it.u1):
            g, q0 = u // it.n_qt, it.q_lo + (u % it.n_qt) * t
            rows = torch.arange(q0, q0 + t, device=dev)[None, :]         # rows across
            qt, dt = qg[:, :, g, q0:q0 + t], dg[:, :, g, q0:q0 + t]      # [B,KV,t,hd]
            s = kt @ qt.transpose(-1, -2)                                # S^T [B,KV,keys,rows]
            dp = vt @ dt.transpose(-1, -2)
            p, ds = probs(s, Lg[:, :, g, None, q0:q0 + t], Dg[:, :, g, None, q0:q0 + t],
                          dp, rows, cols)
            pv += rnd(p) @ dt
            pk += rnd(ds) @ qt
        dk[:, :, k0:k0 + t] += pk
        dv[:, :, k0:k0 + t] += pv
    dk = dk[:, :, :Sk] * scale
    dv = dv[:, :, :Sk]

    # dQ per query tile over the visited key tiles
    kh, vh = kf.repeat_interleave(G, 1), vf.repeat_interleave(G, 1)     # [B,H,Sk_pad,hd]
    dq = torch.zeros(B, H, sq_pad, hd, device=dev)
    for q0 in range(0, Sq, t):
        rows = torch.arange(q0, q0 + t, device=dev)[:, None]
        k_end = min(Sk, q_off + q0 + t) if causal else Sk
        for k0 in range(0, k_end, t):
            if not bwd_key_tile_visited(k0, q0, Sk, **mask):
                continue
            cols = torch.arange(k0, k0 + t, device=dev)[None, :]
            kt, vt = kh[:, :, k0:k0 + t], vh[:, :, k0:k0 + t]
            s = qf[:, :, q0:q0 + t] @ kt.transpose(-1, -2)
            dp = df[:, :, q0:q0 + t] @ vt.transpose(-1, -2)
            _, ds = probs(s, L[:, :, q0:q0 + t, None], D[:, :, q0:q0 + t, None], dp, rows,
                          cols)
            dq[:, :, q0:q0 + t] += rnd(ds) @ kt
    dq = dq[:, :, :Sq] * scale
    return (dq.permute(0, 2, 1, 3).to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))
