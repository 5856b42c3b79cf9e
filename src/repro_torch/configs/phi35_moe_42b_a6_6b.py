"""Phi-3.5-MoE (42B, 6.6B active) — 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,          # GQA kv=8
    d_ff=6400,             # per-expert FFN width
    vocab_size=32064,
    rope_theta=10000.0,
    norm_eps=1e-5,
    n_experts=16,
    experts_per_token=2,
    capacity_factor=1.25,
    source="[hf:microsoft/Phi-3.5-MoE-instruct; hf]",
)
