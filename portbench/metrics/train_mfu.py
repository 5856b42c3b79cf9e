"""Train step: model FLOPs of the unprofiled steps (6·N·tokens and the
attention, no recompute) ÷ their wall ÷ the bf16 peak."""
from portbench.harness.common import load_module
from portbench.harness.readings import mfu_pct


def read(rec):
    fl = load_module("flops", rec.cfg["flops"])
    return mfu_pct(rec, lambda u: fl.train_step(rec.cfg, u["B"], u["T"]))
