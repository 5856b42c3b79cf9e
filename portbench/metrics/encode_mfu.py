"""Model: forward FLOPs of the unprofiled encode batches ÷ their wall ÷
the bf16 peak."""
from portbench.harness.common import load_module
from portbench.harness.readings import mfu_pct


def read(rec):
    fl = load_module("flops", rec.cfg["flops"])
    return mfu_pct(rec, lambda u: fl.forward(rec.cfg, u["B"], u["T"]))
