"""Kernels: the flash backward's bound (its five products on the bf16
tensor cores) over the device time of its four kernels, in the profiled
steps: one call a layer, non-causal, [B, T] frames, every head."""
from portbench.harness.readings import roofline_pct
from portbench.rooflines import flash_bwd


def read(rec):
    c = rec.cfg
    return roofline_pct(rec, flash_bwd.PATTERNS, lambda u: c["n_layers"] * flash_bwd.bound_s(
        u["B"], u["T"], c["n_heads"], c["n_kv_heads"], c["head_dim"], False, 2))
