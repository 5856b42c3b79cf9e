"""Kernels: the flash forward's bound (two products on the bf16 tensor
cores) over the device time of the forward kernels, in the profiled
batches: one call a layer, non-causal, [B, T] frames, every head."""
from portbench.harness.readings import roofline_pct
from portbench.rooflines import flash_fwd


def read(rec):
    c = rec.cfg
    return roofline_pct(rec, flash_fwd.PATTERNS, lambda u: c["n_layers"] * flash_fwd.bound_s(
        u["B"], u["T"], u["T"], c["n_heads"], c["n_kv_heads"], c["head_dim"], False, 2))
