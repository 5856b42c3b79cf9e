"""Kernels: the ssm_scan kernel's bound (bytes ÷ HBM bandwidth) over its
device time, in the profiled prefills: one call a layer on [B, S + meta,
ssm_expand · d · ssm_state] f32."""
from portbench.harness.readings import roofline_pct
from portbench.rooflines import ssm_scan


def read(rec):
    c = rec.cfg
    C = c["ssm_expand"] * c["d_model"] * c["ssm_state"]
    return roofline_pct(rec, ssm_scan.PATTERNS, lambda u: c["n_layers"] * ssm_scan.bound_s(
        len(u["lens"]), u["S_pad"] + c["n_meta_tokens"], C, 4))
