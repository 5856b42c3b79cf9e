"""``ssm_scan``: h_t = a_t·h_{t-1} + b_t over [B, S, C] channels, f32 state.
Its bound: a and b read and h written once, one FMA an element."""
from portbench.harness.peaks import F32_FLOPS, HBM_BYTES_PER_S

# device kernel names the profiler shows for the forward scan
PATTERNS = ("ssm_scan_kernel",)


def bound_s(B: int, S: int, C: int, esize: int) -> float:
    """Seconds: max(bytes / HBM bandwidth, operations / f32 peak)."""
    return max(3 * B * S * C * esize / HBM_BYTES_PER_S, 2 * B * S * C / F32_FLOPS)
