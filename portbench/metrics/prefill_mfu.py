"""Model: prefill FLOPs of every request of the unprofiled stretch (its own
prompt and the meta tokens, not the padding) ÷ that stretch ÷ the bf16 peak."""
from portbench.harness.common import load_module
from portbench.harness.readings import mfu_pct


def read(rec):
    fl = load_module("flops", rec.cfg["flops"])
    M = rec.cfg["n_meta_tokens"]
    return mfu_pct(rec, lambda u: sum(fl.prefill(rec.cfg, n + M) for n in u["lens"]))
