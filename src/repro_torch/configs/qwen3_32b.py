"""Qwen3-32B — dense LM with qk-norm and GQA (kv=8). [hf:Qwen/Qwen3-8B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,          # GQA kv=8
    d_ff=25600,
    vocab_size=151936,
    head_dim=128,          # explicit head_dim (Qwen3 decouples from d_model/H)
    qk_norm=True,          # per-head RMSNorm on q and k
    rope_theta=1000000.0,
    norm_eps=1e-6,
    source="[hf:Qwen/Qwen3-8B; hf]",
)
