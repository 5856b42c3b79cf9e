"""Flash attention backward (D, dK/dV, dQ and the partials' sum): the
function's five products over the visible pairs (q·k, dO·v, P·dO, dS·k,
dS·q: 10·hd FLOPs a pair of each head); q, o, dO read and dq written, k, v
read and dk, dv written once."""
from portbench.harness.peaks import BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S
from portbench.harness.masks import visible_pairs

# the four kernels of one backward call
PATTERNS = ("fa_bwd_",)


def bound_s(B, S, H, KV, hd, causal, esize, window=0, n_sink=0) -> float:
    pairs = B * H * visible_pairs(S, S, causal, window, n_sink)
    peak = BF16_FLOPS if esize == 2 else F32_FLOPS
    byts = (4 * B * S * H * hd + 4 * B * S * KV * hd) * esize
    return max(10 * hd * pairs / peak, byts / HBM_BYTES_PER_S)
