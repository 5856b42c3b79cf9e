"""Qwen3-30B-A3B — MoE LM: 128 experts, top-8, expert d_ff=768.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,          # GQA kv=4
    d_ff=768,              # per-expert FFN width
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1000000.0,
    norm_eps=1e-6,
    n_experts=128,
    experts_per_token=8,
    capacity_factor=1.25,
    source="[hf:Qwen/Qwen3-30B-A3B; hf]",
)
