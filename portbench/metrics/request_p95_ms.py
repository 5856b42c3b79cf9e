"""95th percentile over every request of the window of the time from its
submission to its last output being ready (host clock)."""
from portbench.harness.common import percentile


def read(rec):
    return percentile([(r["t_done"] - r["t_submit"]) * 1e3 for r in rec.requests], 95)
