"""Device idle share of an encode batch: device busy a batch (union of
kernel intervals, profiled batches) against wall a batch (unprofiled)."""
from portbench.harness.readings import idle_pct


def read(rec):
    return idle_pct(rec)
