"""Model FLOPs of the HuBERT encoder: every matrix product (2 a
multiply-add) and the non-causal attention products (4·hd a pair of each
head). A training step counts three times the forward (forward, and the
backward's two products for each), the head included, and no recompute."""
from portbench.reference.hubert import padded_vocab


def layer_params(c) -> int:
    d, H, KV, hd, f = c["d_model"], c["n_heads"], c["n_kv_heads"], c["head_dim"], c["d_ff"]
    return d * (H + 2 * KV) * hd + H * hd * d + 3 * d * f


def forward(c, B: int, T: int) -> float:
    """Hidden states of B clips of T frames (no head)."""
    L = c["n_layers"]
    return (2.0 * L * layer_params(c) * B * T
            + 4.0 * c["head_dim"] * c["n_heads"] * B * T * T * L)


def train_step(c, B: int, T: int) -> float:
    return 3.0 * (forward(c, B, T) + 2.0 * c["d_model"] * padded_vocab(c) * B * T)
