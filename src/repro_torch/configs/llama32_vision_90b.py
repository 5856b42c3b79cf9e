"""Llama-3.2-Vision-90B backbone — 100 total layers = 80 self-attn + 20
gated cross-attn (1 per 4 self layers). The vision tower is a STUB:
``input_specs`` provides precomputed patch embeddings [B, n_img, d_model].
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,          # total: 80 self + 20 cross
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,          # GQA kv=8
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500000.0,
    norm_eps=1e-5,
    cross_attn_every=4,    # one cross-attn layer per 4 self-attn layers
    n_image_tokens=1024,   # precomputed patch-embedding count (stub)
    source="[hf:meta-llama/Llama-3.2-11B-Vision; unverified]",
)
