"""MiniCPM-2B — llama-like dense LM with muP-style scaling and the WSD
(warmup-stable-decay) LR schedule. [arXiv:2404.06395; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,         # MHA
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,
    rope_theta=10000.0,
    norm_eps=1e-5,
    # muP-style scaling from the MiniCPM paper:
    scale_emb=12.0,        # embedding output x12
    scale_depth=1.4,       # residual branch scaled by 1.4/sqrt(L)
    dim_model_base=256,    # logits scaled by 1/(d_model/256)
    source="[arXiv:2404.06395; hf]",
)
