"""HuBERT-XLarge — encoder-only audio transformer backbone (w2v2 arch).
The conv waveform frontend is a STUB: ``input_specs`` provides precomputed
frame embeddings [B, T, d_model]. vocab=504 is the masked-unit target
codebook. [arXiv:2106.07447; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,         # MHA
    d_ff=5120,
    vocab_size=504,
    causal=False,          # encoder-only, bidirectional
    norm_eps=1e-5,
    frontend_stub_dim=1280,
    source="[arXiv:2106.07447; unverified]",
)
