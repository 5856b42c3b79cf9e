"""Serve engine: host clock around the engine's ``decode_fn``, synchronised
as the greedy sampling after it does anyway; the unprofiled stretch's
decode seconds ÷ its decode steps."""
from portbench.harness.readings import unprofiled


def read(rec):
    units, _ = unprofiled(rec)
    steps = sum(u["decode_steps"] for u in units)
    return 1e3 * sum(u["decode_s"] for u in units) / steps if steps else None
