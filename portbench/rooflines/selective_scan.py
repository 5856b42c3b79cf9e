"""The fused selective scan (``selective_scan_fused``): over [B, S, di]
channels of n states, h_t = exp(dt_t·A)·h_{t-1} + dt_t·x_t·B_t and
y_t = (Σ_n h_t·C_t + D·x_t)·silu(z_t), with h in registers, never stored.
Its bound: xc and dt (f32 [B, S, di]) and B, C (f32 [B, S, n]) read, z read
and y written in z's dtype, A [di, n] and D [di] read, the last state
(f32 [B, di, n]) written once; and the B·S·di·n exponentials on the
special function units (the gate's B·S·di exponentials and divisions are
left out, so this stays a bound from below)."""
from portbench.harness.peaks import HBM_BYTES_PER_S, SFU_EXP2_PER_S

# device kernel names the profiler shows for the fused scan
PATTERNS = ("selective_scan_fused_kernel",)


def bound_s(B: int, S: int, di: int, n: int, esize: int) -> float:
    """Seconds: max(bytes / HBM bandwidth, exponentials / SFU rate); ``esize``
    is z's (and y's) bytes an element."""
    byts = 4 * (2 * B * S * di + 2 * B * S * n + di * n + di + B * di * n) + 2 * esize * B * S * di
    return max(byts / HBM_BYTES_PER_S, B * S * di * n / SFU_EXP2_PER_S)
