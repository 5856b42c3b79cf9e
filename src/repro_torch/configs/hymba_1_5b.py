"""Hymba-1.5B — hybrid-head LM: every layer runs attention heads and Mamba
(SSM) heads IN PARALLEL on the same input, outputs fused. Sliding-window
attention (1k) everywhere except 3 full-attention layers (first/middle/last);
128 learnable meta tokens prepended. ssm_state=16. [arXiv:2411.13676; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,          # GQA kv=5
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    rope_theta=10000.0,
    norm_eps=1e-6,
    sliding_window=1024,
    global_attn_layers=(0, 15, 31),
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    n_meta_tokens=128,
    source="[arXiv:2411.13676; hf]",
)
