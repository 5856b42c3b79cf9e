"""Pareto selection of refinement-worthy grid points.

The pre-screen gives every grid point an analytic (time, energy)
estimate; only the points that could be somebody's operating-point pick
deserve the expensive event-engine run: the Pareto front of
(minimize time, minimize energy), thinned to the refinement budget while
always keeping both extremes.
"""
from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["pareto_front", "select_points"]


def pareto_front(objectives: np.ndarray) -> List[int]:
    """Indices of the non-dominated rows of a [K, M] matrix (all
    objectives minimized). O(K^2) — campaign grids are 1e2..1e4 points."""
    obj = np.asarray(objectives, dtype=float)
    if obj.ndim == 1:
        obj = obj[:, None]
    k = obj.shape[0]
    keep: List[int] = []
    for i in range(k):
        dominated = False
        for j in range(k):
            if j == i:
                continue
            if (obj[j] <= obj[i]).all() and (obj[j] < obj[i]).any():
                dominated = True
                break
        if not dominated:
            keep.append(i)
    return keep


def select_points(objectives: np.ndarray, mode: str = "pareto",
                  max_points: int = 16) -> List[int]:
    """Refinement set for one cell's [K, M] analytic objective matrix.

    ``pareto``: non-dominated points, thinned by even stride along the
    first objective down to ``max_points`` (endpoints always kept).
    ``all`` / ``none``: everything / nothing.
    """
    k = int(np.asarray(objectives).shape[0])
    if mode == "all":
        return list(range(k))
    if mode == "none":
        return []
    if mode != "pareto":
        raise ValueError(f"unknown selection mode {mode!r}")
    front = pareto_front(objectives)
    if len(front) <= max_points:
        return sorted(front)
    obj = np.asarray(objectives, dtype=float)
    front = sorted(front, key=lambda i: (obj[i, 0], i))
    # even stride over the time-sorted front, endpoints pinned
    pick_pos = np.linspace(0, len(front) - 1, max_points).round().astype(int)
    return sorted({front[p] for p in pick_pos})
