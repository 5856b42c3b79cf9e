"""Zero-dependency metrics registry — the observability data plane.

Every instrumented subsystem (event engine, fast engine, batched
refinement — structural-class sizes, shared-vs-fallback point counts,
twin-replay memo hit rate under ``batch.*`` — serving fleet, exec
backends) records into a ``MetricsRegistry``: counters, gauges, and
fixed-bucket histograms, each addressable by name + sorted label pairs.
Two contracts make this a subsystem instead of scattered prints:

* **Determinism** — metrics are pure functions of the simulated inputs:
  no wall-clock, no RNG, insertion-independent snapshots (keys sorted).
  Equal inputs produce byte-identical ``snapshot()`` JSON; the property
  test in ``tests/test_obs.py`` holds this still.
* **Off-by-default, near-zero cost** — the module-level ``REGISTRY``
  starts disabled unless ``REPRO_METRICS=1``. Instrumentation sites
  guard on ``REGISTRY.enabled`` (one attribute load + branch, placed
  outside hot loops wherever possible), and the hot event-kernel loop
  switches to its instrumented variant only when enabled.
  ``benchmarks/bench_obs.py`` gates the measured overhead at <5% on the
  ``bench_refine`` 64-layer point.

Wall-clock timings live in *journals* (``exec.journal``), never here —
that split is what keeps campaign records byte-identical across
backends while telemetry still flows.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "REGISTRY", "enabled", "set_enabled", "collecting"]


class Counter:
    """Monotone accumulator (events processed, jobs claimed, ...)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


class Gauge:
    """Last-written level (queue depth, heap size). ``set`` overwrites;
    ``set_max`` keeps the high-water mark."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def set_max(self, value: float) -> None:
        if value > self.value:
            self.value = float(value)


# default histogram bounds: powers of two — matches the serve cost
# model's bucketing and keeps snapshots readable
_DEFAULT_BOUNDS = tuple(float(1 << i) for i in range(16))


class Histogram:
    """Fixed-bucket histogram (cumulative counts, like Prometheus).

    ``bounds`` are the inclusive upper edges; observations above the
    last bound land in the implicit +inf bucket. Also tracks count /
    sum / min / max so snapshots answer "p50-ish where" without
    per-observation storage.
    """

    __slots__ = ("bounds", "buckets", "count", "sum", "min", "max")

    def __init__(self, bounds: Iterable[float] = _DEFAULT_BOUNDS) -> None:
        self.bounds: Tuple[float, ...] = tuple(sorted(float(b)
                                                      for b in bounds))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = [0] * (len(self.bounds) + 1)   # last = +inf
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.buckets[i] += 1
                return
        self.buckets[-1] += 1

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


def _key(name: str, labels: Dict[str, Any]) -> str:
    """Flattened metric identity: ``name{k=v,...}`` with sorted keys —
    the snapshot key, so identity never depends on call order."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Name+labels -> instrument store with a deterministic snapshot."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    # -- instrument accessors (get-or-create) -----------------------------
    def counter(self, name: str, **labels: Any) -> Counter:
        k = _key(name, labels)
        c = self._counters.get(k)
        if c is None:
            c = self._counters[k] = Counter()
        return c

    def gauge(self, name: str, **labels: Any) -> Gauge:
        k = _key(name, labels)
        g = self._gauges.get(k)
        if g is None:
            g = self._gauges[k] = Gauge()
        return g

    def histogram(self, name: str,
                  bounds: Optional[Iterable[float]] = None,
                  **labels: Any) -> Histogram:
        k = _key(name, labels)
        h = self._histograms.get(k)
        if h is None:
            h = self._histograms[k] = Histogram(bounds if bounds is not None
                                                else _DEFAULT_BOUNDS)
        return h

    # -- export ------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe, sorted, wall-clock-free view of every instrument."""
        hist: Dict[str, Any] = {}
        for k in sorted(self._histograms):
            h = self._histograms[k]
            hist[k] = {
                "count": h.count,
                "sum": h.sum,
                "min": h.min if h.count else 0.0,
                "max": h.max if h.count else 0.0,
                "mean": h.mean(),
                "buckets": {f"le_{b:g}": n
                            for b, n in zip(h.bounds, h.buckets)},
                "overflow": h.buckets[-1],
            }
        return {
            "counters": {k: self._counters[k].value
                         for k in sorted(self._counters)},
            "gauges": {k: self._gauges[k].value
                       for k in sorted(self._gauges)},
            "histograms": hist,
        }

    def snapshot_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), sort_keys=True, indent=indent)

    def reset(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._histograms.clear()


#: process-global registry: off unless REPRO_METRICS=1 (the overhead
#: contract); flip with ``set_enabled`` / the ``collecting`` helper.
REGISTRY = MetricsRegistry(
    enabled=os.environ.get("REPRO_METRICS", "0") not in ("", "0"))


def enabled() -> bool:
    return REGISTRY.enabled


def set_enabled(flag: bool) -> None:
    REGISTRY.enabled = bool(flag)


class collecting:
    """``with collecting() as reg:`` — enable the global registry for a
    scope (resetting it on entry), restore the prior state on exit.
    The test/bench harness idiom."""

    def __init__(self, reset: bool = True) -> None:
        self._reset = reset
        self._prev = False

    def __enter__(self) -> MetricsRegistry:
        self._prev = REGISTRY.enabled
        if self._reset:
            REGISTRY.reset()
        REGISTRY.enabled = True
        return REGISTRY

    def __exit__(self, *exc: Any) -> None:
        REGISTRY.enabled = self._prev


def _labels_of(key: str) -> Tuple[str, Dict[str, str]]:
    """Inverse of ``_key`` — used by the CLI/table renderers."""
    if "{" not in key:
        return key, {}
    name, _, rest = key.partition("{")
    pairs = rest.rstrip("}").split(",")
    return name, dict(p.split("=", 1) for p in pairs if "=" in p)


def render_table(snap: Dict[str, Any]) -> List[str]:
    """Plain-text ``name,value`` lines of a snapshot (CLI output)."""
    lines: List[str] = []
    for k, v in snap.get("counters", {}).items():
        lines.append(f"counter,{k},{v:g}")
    for k, v in snap.get("gauges", {}).items():
        lines.append(f"gauge,{k},{v:g}")
    for k, h in snap.get("histograms", {}).items():
        lines.append(f"histogram,{k},count={h['count']} mean={h['mean']:g} "
                     f"min={h['min']:g} max={h['max']:g}")
    return lines
