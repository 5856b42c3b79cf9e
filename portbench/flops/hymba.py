"""Model FLOPs of Hymba: every matrix product (2 a multiply-add), the
attention products over the visible pairs (4·hd a pair of each head), the
depthwise convolution, and the scan's FMA and C contraction
(2 + 2 a state element). Elementwise exps, norms and gates are left out."""
from portbench.reference.hymba import dt_rank, padded_vocab
from portbench.harness.masks import visible_pairs


def layer_products(c) -> int:
    """Multiply-adds a token of one layer's products, attention aside."""
    d, H, KV, hd, f = c["d_model"], c["n_heads"], c["n_kv_heads"], c["head_dim"], c["d_ff"]
    di, n, K, r = c["ssm_expand"] * d, c["ssm_state"], c["ssm_conv"], dt_rank(c)
    attn = d * (H + 2 * KV) * hd + H * hd * d
    mamba = d * 2 * di + K * di + di * (r + 2 * n) + r * di + 2 * di * n + di * d
    return attn + mamba + 3 * d * f


def prefill(c, n_tokens: int) -> float:
    """One sequence of ``n_tokens`` (meta tokens included) through every
    layer, and the head at its last position."""
    H, hd, L = c["n_heads"], c["head_dim"], c["n_layers"]
    G = len(c["global_attn_layers"])
    pairs = (G * visible_pairs(n_tokens, n_tokens)
             + (L - G) * visible_pairs(n_tokens, n_tokens, True, c["sliding_window"],
                                       c["n_meta_tokens"]))
    return (2.0 * L * layer_products(c) * n_tokens + 4.0 * hd * H * pairs
            + 2.0 * c["d_model"] * padded_vocab(c))
