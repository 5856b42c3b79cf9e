"""xLSTM-125M — sLSTM + mLSTM blocks (attention-free recurrent LM).
d_ff=0: xLSTM blocks contain their own up/down projections. O(1)-state
decode -> runs long_500k. Block ratio mLSTM:sLSTM ~ 7:1 per the paper's
small configs; sLSTM blocks at layers (1, 7). [arXiv:2405.04517; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=192,          # d_model / n_heads for the mLSTM cell
    norm_eps=1e-6,
    ssm_expand=2,          # mLSTM up-projection factor
    slstm_layers=(1, 7),
    source="[arXiv:2405.04517; unverified]",
)
