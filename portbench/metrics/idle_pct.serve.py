"""Device idle share of a serving round: device busy a round (union of
kernel intervals, profiled rounds) against wall a round (unprofiled)."""
from portbench.harness.readings import idle_pct


def read(rec):
    return idle_pct(rec)
