"""Model: device milliseconds of the Mamba heads a prefill: Σ device time of
the ``hybrid.mamba`` spans inside ``serve.prefill`` spans ÷ those prefills
(the program's spans, profiled rounds)."""
from portbench.harness.spans import device_ms, profiled, under


def read(rec):
    recs = profiled(rec)
    n = sum(1 for r in recs if r.name == "serve.prefill")
    total = device_ms([r for r in under(recs, "serve.prefill") if r.name == "hybrid.mamba"])
    return total / n if n and total is not None else None
