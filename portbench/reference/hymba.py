"""Plain reference of Hymba (arXiv:2411.13676), float32, TF32 off.

The full forward of the hybrid-head decoder over a whole sequence, no cache
and no batching tricks: learned meta tokens prepended to the prompt; in
every layer attention heads and Mamba (selective SSM) heads read the same
normed input, their outputs are each RMS-normed and averaged into the
residual, then a SwiGLU FFN. Layers listed in ``global_attn_layers`` attend
causally to the whole sequence; the others see a causal window of
``sliding_window`` keys plus the ``n_meta_tokens`` meta tokens as sinks.
Attention is grouped-query with rotary positions over the whole sequence,
meta tokens included. The Mamba heads: in-projection to (x, z), a causal
depthwise convolution of width ``ssm_conv`` and SiLU, an input-dependent
step dt = softplus(x W_x[:r] W_dt + b_dt) and B, C = x W_x[r:], the
diagonal recurrence h_t = exp(dt·A)·h_{t-1} + dt·x·B with A = -exp(a_log),
run step by step, y = h·C + D·x, gated by SiLU(z), out-projected.

Departures from the published model, all shared with the measured program:
the FFN is SwiGLU; the fusion is the mean of the two normed branch outputs
without learned branch scales; no cross-layer KV sharing; the vocabulary
is padded to a multiple of 128 and the logits span the padded columns
(random like the rest); the weights are random (``layout`` gives their
shapes, in the program's parameter layout, and scales).

Every matrix product goes through ``common.mm``, so ``prec="fp8"`` gives the
lower-precision control.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .common import (Leaf, attention, layer_views, mm, param_layout_runs, rms_norm, rope,
                     swiglu)

__all__ = ["layout", "logits_at", "padded_vocab", "dt_rank"]


def padded_vocab(c: Dict) -> int:
    return -(-c["vocab_size"] // 128) * 128


def dt_rank(c: Dict) -> int:
    return -(-c["d_model"] // 16)


def _layer(c: Dict) -> Dict[str, Leaf]:
    d, H, KV, hd, f = c["d_model"], c["n_heads"], c["n_kv_heads"], c["head_dim"], c["d_ff"]
    di, n, K, r = c["ssm_expand"] * d, c["ssm_state"], c["ssm_conv"], dt_rank(c)
    nrm = lambda fan: 1.0 / fan ** 0.5          # noqa: E731
    return {
        "ln1": Leaf((d,), "ones"), "norm_attn": Leaf((d,), "ones"),
        "norm_ssm": Leaf((d,), "ones"), "ln2": Leaf((d,), "ones"),
        "d_skip": Leaf((di,), "ones"),
        "wq": Leaf((d, H, hd), scale=nrm(d)), "wk": Leaf((d, KV, hd), scale=nrm(d)),
        "wv": Leaf((d, KV, hd), scale=nrm(d)), "wo": Leaf((H, hd, d), scale=nrm(H * hd)),
        "w_in": Leaf((d, 2 * di), scale=nrm(d)),
        "conv_w": Leaf((di, K), scale=0.1 * nrm(di)),
        "w_x": Leaf((di, r + 2 * n), scale=nrm(di)),
        "w_dt": Leaf((r, di), scale=nrm(r)),
        "b_dt": Leaf((di,), scale=0.1 * nrm(di)),
        "a_log": Leaf((di, n), scale=0.1 * nrm(di)),
        "wo_m": Leaf((di, d), scale=nrm(di)),
        "wg": Leaf((d, f), scale=nrm(d)), "wi": Leaf((d, f), scale=nrm(d)),
        "wo2": Leaf((f, d), scale=nrm(f)),
    }


def layout(c: Dict):
    """The parameter tree in the program's layout: segments of stacked
    windowed layers between the single global layers."""
    d, V, M = c["d_model"], padded_vocab(c), c["n_meta_tokens"]
    one = _layer(c)
    segs = [one if single else {k: Leaf((n,) + v.shape, v.init, v.scale) for k, v in one.items()}
            for single, _, n in param_layout_runs(c["n_layers"], tuple(c["global_attn_layers"]))]
    return {"embed": Leaf((V, d), scale=d ** -0.5), "meta": Leaf((M, d), scale=0.1 * M ** -0.5),
            "segments": segs, "final_norm": Leaf((d,), "ones"),
            "head": Leaf((d, V), scale=d ** -0.5)}


def _scan(a: torch.Tensor, bu: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + bu_t along dim 1 (h_{-1} = 0), one step at a
    time, written over bu."""
    for t in range(1, bu.shape[1]):
        bu[:, t].addcmul_(a[:, t], bu[:, t - 1])
    return bu


def _mamba(c: Dict, p, h: torch.Tensor, prec: str) -> torch.Tensor:
    di, n, K, r = c["ssm_expand"] * c["d_model"], c["ssm_state"], c["ssm_conv"], dt_rank(c)
    S = h.shape[1]
    xz = mm(h, p["w_in"], prec)
    x, z = xz[..., :di], xz[..., di:]
    xp = F.pad(x, (0, 0, K - 1, 0))                             # zeros before the sequence
    xc = F.silu(sum(xp[:, k:k + S] * p["conv_w"][:, k] for k in range(K)))
    proj = mm(xc, p["w_x"], prec)
    dt = F.softplus(mm(proj[..., :r], p["w_dt"], prec) + p["b_dt"])
    Bm, Cm = proj[..., r:r + n], proj[..., r + n:]
    A = -torch.exp(p["a_log"])
    a = torch.exp(dt[..., None] * A)                            # [B,S,di,n]
    hs = _scan(a, (dt * xc)[..., None] * Bm[:, :, None, :])
    del a
    y = torch.einsum("bsdn,bsn->bsd", hs, Cm) + p["d_skip"] * xc
    return mm(y * F.silu(z), p["wo_m"], prec)


def _block(c: Dict, p, x: torch.Tensor, window: int, n_sink: int, prec: str) -> torch.Tensor:
    d, H, KV, hd, eps = c["d_model"], c["n_heads"], c["n_kv_heads"], c["head_dim"], c["norm_eps"]
    B, S = x.shape[:2]
    h = rms_norm(x, p["ln1"], eps)
    q = rope(mm(h, p["wq"].reshape(d, H * hd), prec).view(B, S, H, hd), c["rope_theta"])
    k = rope(mm(h, p["wk"].reshape(d, KV * hd), prec).view(B, S, KV, hd), c["rope_theta"])
    v = mm(h, p["wv"].reshape(d, KV * hd), prec).view(B, S, KV, hd)
    o = attention(q, k, v, causal=True, window=window, n_sink=n_sink, prec=prec)
    o_attn = mm(o.reshape(B, S, H * hd), p["wo"].reshape(H * hd, d), prec)
    o_ssm = _mamba(c, p, h, prec)
    x = x + 0.5 * (rms_norm(o_attn, p["norm_attn"], eps) + rms_norm(o_ssm, p["norm_ssm"], eps))
    return x + swiglu(rms_norm(x, p["ln2"], eps), p["wg"], p["wi"], p["wo2"], prec)


@torch.no_grad()
def logits_at(params, c: Dict, tokens: torch.Tensor, n_last: int,
              prec: str = "f32") -> torch.Tensor:
    """Logits [B, n_last, padded vocab] (f32) at the last ``n_last``
    positions of ``tokens`` [B, S] (meta tokens prepended here), from the
    full forward. ``params`` is the parameter tree in any dtype; each leaf
    is read in float32, one layer at a time."""
    f32 = lambda t: t.float()                                   # noqa: E731
    x = torch.cat([f32(params["meta"]).expand(tokens.shape[0], -1, -1),
                   f32(params["embed"])[tokens.long()]], dim=1)
    globals_ = tuple(c["global_attn_layers"])
    runs = param_layout_runs(c["n_layers"], globals_)
    for i, lp in layer_views(params["segments"], runs):
        p = {k: f32(v) for k, v in lp.items()}
        win, sink = (0, 0) if i in globals_ else (c["sliding_window"], c["n_meta_tokens"])
        x = _block(c, p, x, win, sink, prec)
        del p
    h = rms_norm(x[:, -n_last:], f32(params["final_norm"]), c["norm_eps"])
    return mm(h, f32(params["head"]), prec)
