"""Architecture configuration record.

``ArchConfig`` is the single config record every model family reads. One
``configs/<id>.py`` per architecture instantiates it with the exact public
numbers; ``reduced()`` derives the CPU smoke-test variant. This is the
port's own copy of the record of the JAX package (``repro.configs.base``):
the same fields, defaults and derived properties, so a config compares
equal field for field with its reference.

``ShapeSpec`` describes one input-shape cell (train_4k / prefill_32k /
decode_32k / long_500k) and knows which program it lowers (``train_step``
vs ``serve_step``) and whether it applies to a family; ``SHAPES`` and
``skip_reason`` are copies of the reference's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "applicable", "skip_reason"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | vlm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0        # 0 -> full attention
    global_attn_layers: Tuple[int, ...] = ()   # hymba: full-attn layer ids
    causal: bool = True            # False for encoder-only (hubert)
    # embeddings / head
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # muP-ish scaling (MiniCPM)
    scale_emb: float = 1.0
    scale_depth: float = 0.0       # >0 -> residual scaled by scale_depth/sqrt(L)
    dim_model_base: int = 0        # >0 -> logits scaled by 1/(d_model/dim_model_base)
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    slstm_layers: Tuple[int, ...] = ()          # xLSTM: sLSTM block positions
    # VLM
    cross_attn_every: int = 0      # insert 1 cross-attn layer per N self layers
    n_image_tokens: int = 0
    # audio
    frontend_stub_dim: int = 0     # precomputed frame-embedding dim (== d_model)
    # misc
    n_meta_tokens: int = 0         # hymba learnable meta tokens
    source: str = ""               # provenance tag "[source; tier]"

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128 (TP divisibility and aligned
        head GEMMs); labels never index the padded tail."""
        return -(-self.vocab_size // 128) * 128

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def n_self_layers(self) -> int:
        if self.cross_attn_every:
            # n_layers counts TOTAL layers (self + cross), e.g. 100 = 80 + 20.
            n_groups = self.n_layers // (self.cross_attn_every + 1)
            return self.n_layers - n_groups
        return self.n_layers

    @property
    def n_cross_layers(self) -> int:
        return self.n_layers - self.n_self_layers if self.cross_attn_every else 0

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can serve a 500k context without a full-attn KV."""
        return self.family in ("ssm", "hybrid")

    @property
    def encoder_only(self) -> bool:
        return not self.causal

    def reduced(self) -> "ArchConfig":
        """CPU smoke-test variant of the same family: tiny but same code path."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=max(2, min(4, self.n_layers)) if not self.cross_attn_every
            else 2 * (self.cross_attn_every + 1),
            d_model=64,
            n_heads=4,
            # keep the MHA-vs-GQA distinction, at a divisor of 4 heads
            n_kv_heads=4 if self.n_kv_heads == self.n_heads else 2,
            head_dim=16 if self.head_dim else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.n_experts else 0,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            global_attn_layers=tuple(
                g for g in self.global_attn_layers if g < 4
            ) or ((0,) if self.global_attn_layers else ()),
            slstm_layers=tuple(g for g in self.slstm_layers if g < 4)
            or ((1,) if self.slstm_layers else ()),
            n_image_tokens=16 if self.n_image_tokens else 0,
            n_meta_tokens=8 if self.n_meta_tokens else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
        )

    def param_count(self) -> int:
        """Analytic parameter count (the reference's formula: the serving
        memory planner and the dry-run read it)."""
        d, hd = self.d_model, self.hd
        H, KV, L = self.n_heads, self.n_kv_heads, self.n_layers
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        per_attn = d * H * hd + 2 * d * KV * hd + H * hd * d
        if self.family == "ssm":
            # xLSTM blocks replace attention+FFN; rough analytic count.
            di = self.ssm_expand * d
            per_layer = 2 * d * di + di * d + 4 * di * hd  # projections + gates
            return emb + head + L * per_layer
        if self.is_moe:
            per_ffn = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
        else:
            per_ffn = 3 * d * self.d_ff
        total = emb + head + self.n_self_layers * (per_attn + per_ffn)
        if self.n_cross_layers:
            total += self.n_cross_layers * (per_attn + 3 * d * self.d_ff)
        if self.family == "hybrid":
            di = self.ssm_expand * d
            total += L * (2 * d * di + di * d)  # mamba in/out projections
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed experts count)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.n_self_layers * (self.n_experts * 3 * d * self.d_ff)
        return dense + self.n_self_layers * (self.experts_per_token * 3 * d * self.d_ff)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def program(self) -> str:
        return "train_step" if self.kind == "train" else "serve_step"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def skip_reason(cfg: ArchConfig, shape: ShapeSpec) -> Optional[str]:
    """Structural (arch-family) skip for a shape cell, or None if runnable:
    encoder-only archs have no autoregressive step; long_500k is defined
    for sub-quadratic archs only."""
    if cfg.encoder_only and shape.kind == "decode":
        return "encoder-only architecture: no autoregressive decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return (
            "pure full-attention architecture: 512k dense-attention decode is "
            "quadratic-cost/KV-infeasible by design; shape defined for "
            "sub-quadratic (SSM/hybrid) archs"
        )
    return None


def applicable(cfg: ArchConfig, shape: ShapeSpec) -> bool:
    return skip_reason(cfg, shape) is None
