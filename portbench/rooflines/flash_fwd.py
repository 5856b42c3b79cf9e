"""Flash attention forward: softmax(q k^T / sqrt(hd)) v under the mask.
Its bound: the two products over the visible pairs (4·hd FLOPs a pair of
each head) on the bf16 tensor cores, q, k, v read and o written once."""
from portbench.harness.peaks import BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S
from portbench.harness.masks import visible_pairs

# the tensor-core kernel and the CUDA-core one
PATTERNS = ("flash_attention_wgmma_kernel", "flash_attention_simt")


def bound_s(B, Sq, Sk, H, KV, hd, causal, esize, window=0, n_sink=0) -> float:
    pairs = B * H * visible_pairs(Sq, Sk, causal, window, n_sink)
    peak = BF16_FLOPS if esize == 2 else F32_FLOPS
    byts = (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd) * esize
    return max(4 * hd * pairs / peak, byts / HBM_BYTES_PER_S)
