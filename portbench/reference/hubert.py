"""Plain reference of the HuBERT X-Large encoder (arXiv:2106.07447), its
masked-unit loss and one AdamW training step, float32, TF32 off.

Frame embeddings [B, T, d] stand in for the convolutional waveform front
end: an input RMSNorm, then fixed sinusoidal positions (sin on even,
cos on odd channels, frequencies 10000^(-2i/d)). Then ``n_layers`` pre-norm
blocks: RMSNorm, bidirectional multi-head attention (no mask, scale
1/sqrt(hd)), out-projection and residual; RMSNorm, SwiGLU FFN and residual.
A final RMSNorm gives the hidden states. The loss is the mean cross entropy
of every frame's unit target under a linear head over the padded vocabulary.

Departures from the published model, all shared with the measured program:
RMSNorm in place of LayerNorm, SwiGLU in place of the GELU FFN, sinusoidal
positions in place of the convolutional relative position embedding, no
biases, no masking of frames (every frame is a target), the unit vocabulary
(504) padded to a multiple of 128 with the padded columns inside the
softmax, random weights (``layout``: the program's parameter layout).

The training step is the program's step written out: gradients of the mean
loss, global-norm clipping, then AdamW (b1 0.9, b2 0.95, eps 1e-8) with
decoupled weight decay on every stored leaf of two or more dims, at a
constant learning rate. Each layer is recomputed in the backward
(``torch.utils.checkpoint``) so the float32 graph fits. Every matrix
product goes through ``common.mm``: ``prec="fp8"`` is the control.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .common import Leaf, attention, mm, rms_norm, swiglu

__all__ = ["layout", "forward", "loss", "padded_vocab", "named_slices", "train_steps",
           "B1", "B2", "EPS"]

B1, B2, EPS = 0.9, 0.95, 1e-8


def padded_vocab(c: Dict) -> int:
    return -(-c["vocab_size"] // 128) * 128


def layout(c: Dict):
    d, H, hd, f, L = c["d_model"], c["n_heads"], c["head_dim"], c["d_ff"], c["n_layers"]
    KV = c["n_kv_heads"]
    nrm = lambda fan: 1.0 / fan ** 0.5          # noqa: E731
    seg = {
        "ln1": Leaf((L, d), "ones"), "ln2": Leaf((L, d), "ones"),
        "wq": Leaf((L, d, H, hd), scale=nrm(d)), "wk": Leaf((L, d, KV, hd), scale=nrm(d)),
        "wv": Leaf((L, d, KV, hd), scale=nrm(d)), "wo": Leaf((L, H, hd, d), scale=nrm(H * hd)),
        "wg": Leaf((L, d, f), scale=nrm(d)), "wi": Leaf((L, d, f), scale=nrm(d)),
        "wo2": Leaf((L, f, d), scale=nrm(f)),
    }
    return {"in_norm": Leaf((d,), "ones"), "segments": [seg], "final_norm": Leaf((d,), "ones"),
            "head": Leaf((d, padded_vocab(c)), scale=nrm(d))}


def named_slices(params) -> List[Tuple[str, torch.Tensor]]:
    """The parameters as compared leaf by leaf: each layer's slice of a
    stacked leaf, and every unstacked leaf whole, in a fixed order."""
    out = [(k, params[k]) for k in ("in_norm", "final_norm", "head")]
    for k in sorted(params["segments"][0]):
        t = params["segments"][0][k]
        out += [(f"{k}[{i}]", t[i]) for i in range(t.shape[0])]
    return out


def _embed(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = rms_norm(x, w, eps)
    S, d = x.shape[1], x.shape[2]
    pos = torch.arange(S, dtype=torch.float32, device=x.device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=x.device)
                    * (-math.log(1e4) / d))
    pe = torch.zeros((S, d), dtype=torch.float32, device=x.device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return x + pe


def _block(x, ln1, wq, wk, wv, wo, ln2, wg, wi, wo2, eps: float, prec: str):
    B, S, d = x.shape
    H, hd = wq.shape[1], wq.shape[2]
    KV = wk.shape[1]
    h = rms_norm(x, ln1, eps)
    q = mm(h, wq.reshape(d, H * hd), prec).view(B, S, H, hd)
    k = mm(h, wk.reshape(d, KV * hd), prec).view(B, S, KV, hd)
    v = mm(h, wv.reshape(d, KV * hd), prec).view(B, S, KV, hd)
    o = attention(q, k, v, causal=False, prec=prec)
    x = x + mm(o.reshape(B, S, H * hd), wo.reshape(H * hd, d), prec)
    return x + swiglu(rms_norm(x, ln2, eps), wg, wi, wo2, prec)


_ORDER = ("ln1", "wq", "wk", "wv", "wo", "ln2", "wg", "wi", "wo2")


def forward(params, c: Dict, frames: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """Hidden states [B, T, d] of ``frames`` [B, T, d]; every leaf read in
    float32. Under autograd each layer is recomputed in the backward."""
    eps = c["norm_eps"]
    seg = params["segments"][0]
    x = _embed(frames.float(), params["in_norm"].float(), eps)
    for i in range(c["n_layers"]):
        args = [seg[k][i].float() for k in _ORDER]
        if torch.is_grad_enabled():
            x = checkpoint(_block, x, *args, eps, prec, use_reentrant=False)
        else:
            x = _block(x, *args, eps, prec)
    return rms_norm(x, params["final_norm"].float(), eps)


def loss(params, c: Dict, frames: torch.Tensor, labels: torch.Tensor,
         prec: str = "f32") -> torch.Tensor:
    """Mean cross entropy of every frame's label over the padded vocabulary."""
    h = forward(params, c, frames, prec)
    logits = mm(h, params["head"].float(), prec)
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels.long()[..., None])[..., 0]).mean()


def _leaves(params) -> List[torch.Tensor]:
    return ([params[k] for k in ("in_norm", "final_norm", "head")]
            + [params["segments"][0][k] for k in sorted(params["segments"][0])])


def train_steps(params, c: Dict, batches, *, lr: float, weight_decay: float,
                clip_norm: float, prec: str = "f32") -> Dict:
    """Run len(batches) training steps from ``params`` (a tree of float32
    tensors, updated in place). Returns each step's loss, the clipped
    gradient of the first step (the tree, as the optimizer gets it) and the
    parameters after the last step (the tree itself)."""
    leaves = _leaves(params)
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    losses, first_grad = [], None
    for step, (frames, labels) in enumerate(batches, start=1):
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            lv = loss(params, c, frames, labels, prec)
            grads = torch.autograd.grad(lv, leaves)
        losses.append(float(lv.detach()))
        with torch.no_grad():
            for p in leaves:
                p.requires_grad_(False)
            gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
            scale = torch.clamp(clip_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
            grads = [g * scale for g in grads]
            if first_grad is None:
                first_grad = _tree_like(params, grads)
            c1, c2 = 1.0 - B1 ** step, 1.0 - B2 ** step
            for p, g, mi, vi in zip(leaves, grads, m, v):
                mi.mul_(B1).add_(g, alpha=1 - B1)
                vi.mul_(B2).addcmul_(g, g, value=1 - B2)
                delta = (mi / c1) / (torch.sqrt(vi / c2) + EPS)
                if p.dim() >= 2:
                    delta = delta + weight_decay * p
                p.sub_(lr * delta)
            del grads
    return {"losses": losses, "first_grad": first_grad}


def _tree_like(params, leaves: List[torch.Tensor]):
    it = iter(leaves)
    out = {k: next(it) for k in ("in_norm", "final_norm", "head")}
    out["segments"] = [{k: next(it) for k in sorted(params["segments"][0])}]
    return out
