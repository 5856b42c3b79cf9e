"""Train step: device milliseconds of clipping and AdamW a step: Σ device
time of the ``train.clip`` and ``train.optimizer`` spans ÷ the optimizer
spans (the program's spans, profiled steps)."""
from portbench.harness.spans import device_ms, profiled


def read(rec):
    recs = profiled(rec)
    n = sum(1 for r in recs if r.name == "train.optimizer")
    total = device_ms([r for r in recs if r.name in ("train.clip", "train.optimizer")])
    return total / n if n and total is not None else None
