"""Device idle share of a training step: device busy a step (union of
kernel intervals, profiled steps) against wall a step (unprofiled)."""
from portbench.harness.readings import idle_pct


def read(rec):
    return idle_pct(rec)
