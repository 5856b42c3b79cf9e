"""Synthetic request-arrival traces for serving-fleet campaigns.

Three sources, all producing the same flat ``TraceRequest`` stream:

* ``poisson_trace``  — memoryless open-loop traffic: exponential
  inter-arrival gaps at a constant offered rate.
* ``bursty_trace``   — a two-state Markov-modulated Poisson process
  (MMPP-2): the generator alternates between a *calm* and a *burst*
  regime (exponentially distributed dwell times); the burst regime
  offers ``burst_x`` times the calm rate while the long-run mean rate
  stays exactly ``rate_rps``. This is the diurnal-spike/retry-storm
  shape that separates continuous batching from static batching.
* ``load_trace_jsonl`` — replay a recorded trace (one JSON object per
  line) so real production arrival processes can drive the simulator.

Determinism contract: traces are pure functions of their parameters.
Randomness only ever flows through ``Generator.random()`` (raw PCG64
uniforms mapped through explicit inverse CDFs) — numpy guarantees that
stream bit-for-bit across versions, unlike the distribution helpers —
so a trace spec embedded in a refinement payload regenerates the exact
same trace on every backend and host, keeping serving campaign records
byte-identical (the ``tests/test_golden.py`` cross-backend contract).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np

__all__ = ["TraceRequest", "poisson_trace", "bursty_trace",
           "load_trace_jsonl", "make_trace", "TRAFFIC_KINDS"]

TRAFFIC_KINDS = ("poisson", "bursty", "jsonl")


@dataclass(frozen=True)
class TraceRequest:
    """One request of an arrival trace (times in ns from trace start)."""

    arrival_ns: float
    prompt_tokens: int
    max_new: int


def _exp(rng: np.random.Generator, scale: float, n: int) -> np.ndarray:
    """Exponential draws via inverse CDF over raw uniforms (stable
    stream: ``Generator.random`` only)."""
    return -np.log1p(-rng.random(n)) * scale


def poisson_trace(*, rate_rps: float, n_requests: int, seed: int,
                  prompt_tokens: int, max_new: int) -> List[TraceRequest]:
    """Open-loop Poisson arrivals at ``rate_rps`` requests/second."""
    if rate_rps <= 0 or n_requests < 1:
        raise ValueError(f"need rate_rps > 0 and n_requests >= 1, got "
                         f"rate_rps={rate_rps}, n_requests={n_requests}")
    rng = np.random.default_rng(seed)
    gaps_ns = _exp(rng, 1e9 / rate_rps, n_requests)
    arrivals = np.cumsum(gaps_ns)
    return [TraceRequest(float(t), prompt_tokens, max_new)
            for t in arrivals]


def bursty_trace(*, rate_rps: float, n_requests: int, seed: int,
                 prompt_tokens: int, max_new: int, burst_x: float = 4.0,
                 dwell_s: float = 2.0) -> List[TraceRequest]:
    """MMPP-2 arrivals: calm/burst regimes with exponential dwell times.

    The two regimes spend equal expected time (``dwell_s`` each), the
    burst regime arrives ``burst_x`` times faster than the calm one,
    and the rates are normalized so the long-run offered rate is
    ``rate_rps``: ``calm = 2 * rate / (1 + burst_x)``.
    """
    if burst_x < 1.0:
        raise ValueError(f"burst_x must be >= 1, got {burst_x}")
    if rate_rps <= 0 or n_requests < 1 or dwell_s <= 0:
        raise ValueError(f"bad bursty-trace parameters: rate_rps="
                         f"{rate_rps}, n_requests={n_requests}, "
                         f"dwell_s={dwell_s}")
    rng = np.random.default_rng(seed)
    calm_rps = 2.0 * rate_rps / (1.0 + burst_x)
    rates = (calm_rps, calm_rps * burst_x)
    out: List[TraceRequest] = []
    t_ns = 0.0
    regime = 0                       # start calm; dwell draw flips it
    while len(out) < n_requests:
        dwell_ns = float(_exp(rng, dwell_s * 1e9, 1)[0])
        regime_end = t_ns + dwell_ns
        scale_ns = 1e9 / rates[regime]
        while len(out) < n_requests:
            t_next = t_ns + float(_exp(rng, scale_ns, 1)[0])
            if t_next > regime_end:
                break                # arrival falls in the next regime
            t_ns = t_next
            out.append(TraceRequest(t_ns, prompt_tokens, max_new))
        t_ns = regime_end
        regime = 1 - regime
    return out


def load_trace_jsonl(path: str) -> List[TraceRequest]:
    """Load a recorded trace: one JSON object per line with
    ``arrival_s`` (or ``arrival_ns``), ``prompt_tokens``, ``max_new``."""
    out: List[TraceRequest] = []
    with open(path) as f:
        for ln, raw in enumerate(f, 1):
            raw = raw.strip()
            if not raw:
                continue
            d = json.loads(raw)
            if "arrival_ns" in d:
                t = float(d["arrival_ns"])
            elif "arrival_s" in d:
                t = float(d["arrival_s"]) * 1e9
            else:
                raise ValueError(f"{path}:{ln}: needs arrival_s or "
                                 f"arrival_ns")
            out.append(TraceRequest(t, int(d["prompt_tokens"]),
                                    int(d["max_new"])))
    if not out:
        raise ValueError(f"{path}: empty trace")
    return sorted(out, key=lambda r: r.arrival_ns)


def make_trace(spec: Dict[str, Any], *, prompt_tokens: int,
               max_new: int) -> List[TraceRequest]:
    """Build a trace from its payload-embedded spec dict.

    ``spec["kind"]`` selects the source (``poisson`` / ``bursty`` /
    ``jsonl``); the remaining keys are that source's parameters. This is
    the function refinement workers call, so everything that determines
    the trace must be inside ``spec`` (it is part of the result-cache
    content key).
    """
    kind = spec.get("kind", "poisson")
    if kind == "poisson":
        return poisson_trace(rate_rps=spec["rate_rps"],
                             n_requests=spec["n_requests"],
                             seed=spec.get("seed", 0),
                             prompt_tokens=prompt_tokens, max_new=max_new)
    if kind == "bursty":
        return bursty_trace(rate_rps=spec["rate_rps"],
                            n_requests=spec["n_requests"],
                            seed=spec.get("seed", 0),
                            prompt_tokens=prompt_tokens, max_new=max_new,
                            burst_x=spec.get("burst_x", 4.0),
                            dwell_s=spec.get("dwell_s", 2.0))
    if kind == "jsonl":
        return load_trace_jsonl(spec["path"])
    raise ValueError(f"unknown traffic kind {kind!r}; "
                     f"have {'|'.join(TRAFFIC_KINDS)}")
