"""Kernels: the fused selective scan's bound (its exponentials on the
special function units, or its bytes ÷ HBM bandwidth) over its device
time, in the profiled prefills: one call a layer on [B, S + meta,
ssm_expand · d, ssm_state], z and y in the served dtype."""
from portbench.harness.readings import roofline_pct
from portbench.rooflines import selective_scan


def read(rec):
    c = rec.cfg
    di, esize = c["ssm_expand"] * c["d_model"], 4 if c["dtype"] == "float32" else 2
    return roofline_pct(rec, selective_scan.PATTERNS, lambda u: c["n_layers"] * (
        selective_scan.bound_s(len(u["lens"]), u["S_pad"] + c["n_meta_tokens"], di,
                               c["ssm_state"], esize)))
