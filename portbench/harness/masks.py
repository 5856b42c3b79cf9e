"""Query-key pairs an attention mask lets through (the flash rooflines and
the FLOP counts)."""
import numpy as np


def visible_pairs(Sq: int, Sk: int, causal: bool = True, window: int = 0,
                  n_sink: int = 0) -> int:
    """Pairs (row, col) with col < Sk and, when causal, col <= row and,
    under a window, col > row - window or col < n_sink."""
    if not causal:
        return Sq * Sk
    r = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(r, Sk - 1)
    if not window:
        return int(np.maximum(hi + 1, 0).sum())
    lo = np.maximum(r - window + 1, 0)
    band = np.maximum(hi - lo + 1, 0)
    sinks = np.maximum(0, np.minimum(np.minimum(n_sink, lo), hi + 1))
    return int((band + sinks).sum())
