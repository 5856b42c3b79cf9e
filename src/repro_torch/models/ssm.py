"""xLSTM cells: mLSTM (matrix memory, chunk-parallel) + sLSTM (scalar memory).

Counterpart of ``repro/models/ssm.py``. mLSTM training and prefill use the
chunkwise-parallel form: within a chunk of length L the contribution is a
masked [L, L] decay-weighted attention matrix; across chunks a Python loop
(``jax.lax.scan`` in the reference) carries the stabilised state (C [dk, dv],
n [dk], m a scalar per head). L follows the reference's rule: the largest
divisor of S not above ``chunk``, so a prime S runs S chunks of one token.
The function does not depend on L; its rounding does.

All gate math is float32 and stabilised in log space (running max ``m``).
Decode is the O(1) recurrent step. sLSTM is strictly sequential over S in
both packages: a Python loop over the tokens. No Pallas kernel of the
reference sits under either cell, so they are plain torch here.

Shapes: q, k [B, S, H, dk], v [B, S, H, dv], gate preacts [B, S, H].
State: C [B, H, dk, dv], n [B, H, dk], m [B, H] (stored pre-scaled by
exp(-m), i.e. "hatted").

DTensors (under sharding rules) run both scans on each rank's local batch
rows and heads, the sequence whole (``_on_local_rows``): a chunk's or a
step's state depends on every token before it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import (kernel_placements, mesh_of, moved_placements, on_shards,
                                    to_mesh)

__all__ = [
    "mlstm_chunked",
    "mlstm_decode_step",
    "mlstm_state_init",
    "slstm_scan",
    "slstm_decode_step",
    "slstm_state_init",
]

NEG_INIT = -1e30


def _logsigmoid(x: torch.Tensor) -> torch.Tensor:
    return -F.softplus(-x)


def mlstm_state_init(B: int, H: int, dk: int, dv: int, dtype=torch.float32, device=None):
    return (torch.zeros((B, H, dk, dv), dtype=dtype, device=device),
            torch.zeros((B, H, dk), dtype=dtype, device=device),
            torch.full((B, H), NEG_INIT, dtype=dtype, device=device))


def chunk_len(S: int, chunk: int = 256) -> int:
    """The reference's chunk length: min(chunk, S), shrunk until it divides S."""
    L = min(chunk, S)
    while S % L:
        L -= 1
    return L


def _on_local_rows(fn, x, batch_head_args, head_args, state, n_out):
    """``fn(*batch_head_args, *head_args, *state)`` on each rank's local
    shards, where the DTensor ``x`` ([B, S, H, ...]) keeps its batch and
    head splits and its sequence whole: ``batch_head_args`` are laid out as
    x, ``head_args`` ([H, ...]) split where x's heads are, the ``state``
    ([B, H, ...]) where x's batch rows and heads are. ``fn`` returns an
    output laid out as x, then ``n_out`` states."""
    mesh = x.device_mesh
    pl = kernel_placements(to_mesh(x, mesh), (0, 2))
    st = moved_placements(pl, {0: 0, 2: 1})
    args = tuple(batch_head_args) + tuple(head_args) + tuple(state)
    pls = ([pl] * len(batch_head_args) + [moved_placements(pl, {2: 0})] * len(head_args)
           + [st] * len(state))
    return on_shards(fn, mesh, args, pls, (pl,) + (st,) * n_out)


def mlstm_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  i_pre: torch.Tensor, f_pre: torch.Tensor,
                  state: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
                  *, chunk: int = 256, return_state: bool = False):
    """Chunk-parallel mLSTM. Returns h [B, S, H, dv] in v.dtype (and the
    final f32 state)."""
    if mesh_of(q, k, v, i_pre, f_pre) is not None:
        def local(*a):
            h, st = mlstm_chunked(*a[:5], tuple(a[5:]) or None, chunk=chunk,
                                  return_state=True)
            return (h,) + tuple(st)
        h, *st = _on_local_rows(local, q, (q, k, v, i_pre, f_pre), (), tuple(state or ()), 3)
        return (h, tuple(st)) if return_state else h
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    L = chunk_len(S, chunk)
    Nc = S // L

    def to_chunks(x):                     # [B,S,H,*] -> [Nc,B,H,L,*]
        return x.reshape(B, Nc, L, H, -1).permute(1, 0, 3, 2, 4)

    qf = to_chunks(q).float()
    kf = to_chunks(k).float() / math.sqrt(dk)
    vf = to_chunks(v).float()
    lf = _logsigmoid(to_chunks(f_pre[..., None]).float())[..., 0]   # [Nc,B,H,L]
    li = to_chunks(i_pre[..., None]).float()[..., 0]

    if state is None:
        Ch, nh, m = mlstm_state_init(B, H, dk, dv, device=q.device)
    else:
        Ch, nh, m = (s.float() for s in state)

    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()   # s <= t
    hs = []
    for c in range(Nc):
        qc, kc, vc, lfc, lic = qf[c], kf[c], vf[c], lf[c], li[c]         # [B,H,L,*]
        b = torch.cumsum(lfc, dim=-1)                                    # inclusive
        btot = b[..., -1:]
        G = torch.cummax(lic - b, dim=-1).values
        m_t = b + torch.maximum(m[..., None], G)                         # stabiliser per t
        # intra-chunk decay D[t,s] = exp(b_t - b_s + li_s - m_t), s <= t
        logD = b[..., :, None] - b[..., None, :] + lic[..., None, :] - m_t[..., :, None]
        D = torch.exp(logD.masked_fill(~tri, -math.inf))
        E = (qc @ kc.transpose(-1, -2)) * D                              # [B,H,L,L]
        num = E @ vc
        den = E.sum(-1)
        # the carried state's contribution
        a = torch.exp(b + m[..., None] - m_t)
        num = num + a[..., None] * (qc @ Ch)
        den = den + a * (qc @ nh[..., None])[..., 0]
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])
        # the state at the chunk's end
        m_new = btot[..., 0] + torch.maximum(m, G[..., -1])
        g = torch.exp(btot - b + lic - m_new[..., None])                 # [B,H,L]
        decay = torch.exp(btot[..., 0] + m - m_new)                      # [B,H]
        Ch = decay[..., None, None] * Ch + (g[..., None] * kc).transpose(-1, -2) @ vc
        nh = decay[..., None] * nh + (g[..., None] * kc).sum(-2)
        m = m_new
    h = torch.stack(hs).permute(1, 0, 3, 2, 4).reshape(B, S, H, dv).to(v.dtype)
    if return_state:
        return h, (Ch, nh, m)
    return h


def mlstm_decode_step(q, k, v, i_pre, f_pre, state):
    """One-token recurrent mLSTM step. q, k, v [B,1,H,d*]; gates [B,1,H]."""
    dk = q.shape[-1]
    Ch, nh, m = (s.float() for s in state)
    qf = q[:, 0].float()                                  # [B,H,dk]
    kf = k[:, 0].float() / math.sqrt(dk)
    vf = v[:, 0].float()
    lf = _logsigmoid(f_pre[:, 0].float())                 # [B,H]
    li = i_pre[:, 0].float()
    m_new = torch.maximum(lf + m, li)
    fs = torch.exp(lf + m - m_new)
    is_ = torch.exp(li - m_new)
    C_new = fs[..., None, None] * Ch + is_[..., None, None] * (kf[..., :, None] * vf[..., None, :])
    n_new = fs[..., None] * nh + is_[..., None] * kf
    num = (qf[..., None, :] @ C_new)[..., 0, :]           # [B,H,dv]
    den = (qf * n_new).sum(-1)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h[:, None].to(v.dtype), (C_new, n_new, m_new)


# ---------------------------------------------------------------------------
# sLSTM — scalar memory, exponential gating, strictly sequential
# ---------------------------------------------------------------------------

def slstm_state_init(B: int, H: int, hd: int, dtype=torch.float32, device=None):
    z = dict(dtype=dtype, device=device)
    return (torch.zeros((B, H, hd), **z),            # c
            torch.ones((B, H, hd), **z),             # n
            torch.zeros((B, H, hd), **z),            # h
            torch.full((B, H, hd), NEG_INIT, **z))   # m


def _slstm_cell(state, gates_x, R):
    """gates_x [B,H,4,hd] (input contribution); R [H,hd,4,hd] recurrent."""
    c, n, h, m = state
    pre = gates_x + torch.einsum("bhd,hdgk->bhgk", h, R)
    zi, fi, ii, oi = pre.unbind(2)
    z = torch.tanh(zi)
    o = torch.sigmoid(oi)
    m_new = torch.maximum(fi + m, ii)
    fs = torch.exp(fi + m - m_new)
    is_ = torch.exp(ii - m_new)
    c_new = fs * c + is_ * z
    n_new = fs * n + is_
    h_new = o * (c_new / n_new.clamp_min(1e-9))
    return (c_new, n_new, h_new, m_new), h_new


def slstm_scan(gates_x: torch.Tensor, R: torch.Tensor, state=None):
    """gates_x [B,S,H,4,hd] -> (h [B,S,H,hd] in gates_x.dtype, f32 state)."""
    if mesh_of(gates_x, R) is not None:
        def local(gx, r, *st):
            h, st = slstm_scan(gx, r, tuple(st) or None)
            return (h,) + tuple(st)
        h, *st = _on_local_rows(local, gates_x, (gates_x,), (R,), tuple(state or ()), 4)
        return h, tuple(st)
    B, S, H, _, hd = gates_x.shape
    if state is None:
        state = slstm_state_init(B, H, hd, device=gates_x.device)
    gx = gates_x.float()
    Rf = R.float()
    hs = []
    for t in range(S):
        state, h = _slstm_cell(state, gx[:, t], Rf)
        hs.append(h)
    return torch.stack(hs, dim=1).to(gates_x.dtype), state


def slstm_decode_step(gates_x: torch.Tensor, R: torch.Tensor, state):
    """gates_x [B,1,H,4,hd], one step."""
    state, h = _slstm_cell(state, gates_x[:, 0].float(), R.float())
    return h[:, None].to(gates_x.dtype), state
