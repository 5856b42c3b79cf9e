"""Deterministic fault injection for the campaign execution substrate.

Scale turns rare failures into routine ones: a fleet of spool workers
*will* be SIGKILLed mid-publish, write torn files on flaky shared
filesystems, stall their heartbeats under memory pressure, and drift
their clocks. This module makes every one of those failures a
first-class, **seeded, replayable input** so the exec layer's
crash-safety is proven by test, not asserted by comment.

A ``FaultPlan`` is a seed plus a set of rules ``(kind, site) -> value``:

=========  =======================  =====================================
kind       value                    effect at a matching site
=========  =======================  =====================================
``crash``  probability [0..1]       simulated SIGKILL: nothing after the
                                    site runs (``InjectedCrash`` — a
                                    ``BaseException`` that no ``except
                                    Exception`` handler swallows — or a
                                    real ``os._exit`` for ``hard`` plans
                                    in subprocess workers)
``error``  probability [0..1]       a *recoverable* ``RuntimeError`` at
                                    the site — the worker survives; used
                                    to prove release-safety of the
                                    complete/fail paths
``torn``   probability [0..1]       the publish writes a truncated JSON
                                    file at the final path (a
                                    non-atomic filesystem caught
                                    mid-write) and raises ``OSError``
``stall``  probability [0..1]       the job's heartbeat silently stops
                                    refreshing the lease (the worker
                                    keeps computing — a paged-out or
                                    GC-frozen process)
``latency``  seconds                every spool filesystem publish/claim
                                    sleeps this long first (slow NFS)
``skew``   seconds (+/-)            the spool's clock reads offset by
                                    this much (one host's clock is off)
=========  =======================  =====================================

Crash/error sites are the named crash-points threaded through
``worker.run_worker`` and ``Spool.complete``: ``after-claim``,
``mid-refine``, ``before-publish``, ``after-publish`` (the window
between the done-file publish and the lease release). Torn-write sites
name the publish being torn: ``publish-done``, ``publish-fail``,
``publish-job``.

**Determinism.** Every decision is a pure hash of ``(seed, kind, site,
job key, attempt)`` — no RNG state, no call-order dependence. The same
``REPRO_FAULTS`` value makes every worker subprocess misbehave
identically across runs, and a retried job (higher ``attempt``) redraws,
so sub-1.0 crash rates terminate: a job either eventually publishes or
exhausts its retry budget and is quarantined with a diagnosis.

Env grammar (parsed once per distinct value)::

    REPRO_FAULTS="<seed>:<kind>@<site>=<value>[,<kind>@<site>=<value>...]"
    REPRO_FAULTS="7:crash@before-publish=0.4,torn@publish-done=0.3"

Plans loaded from the environment are ``hard`` (``os._exit`` on crash —
the truest SIGKILL for subprocess workers); tests install soft plans
in-process with ``use_plan()``/``plan_scope()``.
"""
from __future__ import annotations

import hashlib
import os
import time
from contextlib import contextmanager
from typing import Dict, Optional, Tuple

from ..obs.metrics import REGISTRY

__all__ = ["FaultPlan", "InjectedCrash", "TornWrite", "CRASH_SITES",
           "TORN_SITES", "active_plan", "use_plan", "plan_scope"]

#: named crash-points, in worker-lifecycle order
CRASH_SITES = ("after-claim", "mid-refine", "before-publish",
               "after-publish")
#: publishes a torn-write rule can target
TORN_SITES = ("publish-done", "publish-fail", "publish-job")
KINDS = ("crash", "error", "torn", "stall", "latency", "skew")

#: exit code of a hard injected crash (visible in worker `$?`)
CRASH_EXIT = 137


class InjectedCrash(BaseException):
    """A simulated SIGKILL. Derives from ``BaseException`` on purpose:
    the worker's ``except Exception`` failure handling must NOT treat a
    simulated kill as a refinement error — nothing after the crash
    point runs except lease-keep-alive teardown (which a real SIGKILL
    would also take down, since the heartbeat thread dies with the
    process)."""


class TornWrite(OSError):
    """An injected non-atomic write: the destination file exists but is
    truncated mid-JSON, and the publish call reports failure."""


def _u01(seed: int, kind: str, site: str, key: str, attempt: int) -> float:
    """Uniform [0,1) from a pure hash — the whole source of randomness."""
    blob = f"{seed}:{kind}:{site}:{key}:{attempt}".encode()
    h = hashlib.sha256(blob).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64


class FaultPlan:
    """A seeded set of fault rules; see module docstring."""

    def __init__(self, seed: int,
                 rules: Dict[Tuple[str, str], float],
                 *, hard: bool = False):
        for (kind, site), _v in rules.items():
            if kind not in KINDS:
                raise ValueError(f"unknown fault kind {kind!r}; "
                                 f"have {'|'.join(KINDS)}")
            if kind in ("crash", "error") and site not in CRASH_SITES:
                raise ValueError(f"unknown crash site {site!r}; "
                                 f"have {'|'.join(CRASH_SITES)}")
            if kind == "torn" and site not in TORN_SITES:
                raise ValueError(f"unknown torn-write site {site!r}; "
                                 f"have {'|'.join(TORN_SITES)}")
        self.seed = int(seed)
        self.rules = dict(rules)
        self.hard = bool(hard)

    # -- construction ------------------------------------------------------

    @classmethod
    def parse(cls, spec: str, *, hard: bool = False) -> "FaultPlan":
        """Parse the ``REPRO_FAULTS`` grammar: ``seed:k@s=v,k@s=v``."""
        head, sep, body = spec.partition(":")
        if not sep:
            raise ValueError(
                f"REPRO_FAULTS must look like 'seed:kind@site=value,...', "
                f"got {spec!r}")
        try:
            seed = int(head)
        except ValueError:
            raise ValueError(f"REPRO_FAULTS seed must be an int, "
                             f"got {head!r}") from None
        rules: Dict[Tuple[str, str], float] = {}
        for token in filter(None, (t.strip() for t in body.split(","))):
            lhs, sep, val = token.partition("=")
            kind, sep2, site = lhs.partition("@")
            if not sep or not sep2:
                raise ValueError(f"bad REPRO_FAULTS rule {token!r} "
                                 f"(want kind@site=value)")
            rules[(kind.strip(), site.strip())] = float(val)
        return cls(seed, rules, hard=hard)

    def to_spec(self) -> str:
        body = ",".join(f"{k}@{s}={v:g}"
                        for (k, s), v in sorted(self.rules.items()))
        return f"{self.seed}:{body}"

    # -- decisions ---------------------------------------------------------

    def rate(self, kind: str, site: str) -> float:
        return self.rules.get((kind, site), 0.0)

    def fires(self, kind: str, site: str, key: str,
              attempt: int = 0) -> bool:
        r = self.rate(kind, site)
        if r <= 0.0:
            return False
        return _u01(self.seed, kind, site, key, attempt) < r

    def _count(self, kind: str, site: str) -> None:
        if REGISTRY.enabled:
            REGISTRY.counter("faults.injected", kind=kind, site=site).inc()

    def maybe_crash(self, site: str, key: str, attempt: int = 0) -> None:
        """Die (hard or soft) / raise a recoverable error at a named
        crash-point, per the plan. No-op when no rule fires."""
        if self.fires("crash", site, key, attempt):
            self._count("crash", site)
            if self.hard:
                # a real kill: no unwinding, no finally blocks, no
                # flushes — exactly what SIGKILL leaves behind
                os._exit(CRASH_EXIT)
            raise InjectedCrash(f"injected crash at {site} "
                                f"(key {key[:12]}, attempt {attempt})")
        if self.fires("error", site, key, attempt):
            self._count("error", site)
            raise RuntimeError(f"injected error at {site} "
                               f"(key {key[:12]}, attempt {attempt})")

    def torn_write(self, site: str, key: str, attempt: int = 0) -> bool:
        fired = self.fires("torn", site, key, attempt)
        if fired:
            self._count("torn", site)
        return fired

    def heartbeat_stalls(self, key: str, attempt: int = 0) -> bool:
        fired = self.fires("stall", "heartbeat", key, attempt)
        if fired:
            self._count("stall", "heartbeat")
        return fired

    def fs_latency_s(self) -> float:
        return self.rules.get(("latency", "fs"), 0.0)

    def sleep_fs(self) -> None:
        d = self.fs_latency_s()
        if d > 0:
            self._count("latency", "fs")
            time.sleep(d)

    def clock_skew_s(self) -> float:
        return self.rules.get(("skew", "clock"), 0.0)


# -- process-wide active plan ----------------------------------------------

_ENV_VAR = "REPRO_FAULTS"
_explicit: Optional[FaultPlan] = None
_explicit_set = False
_env_cache: Tuple[Optional[str], Optional[FaultPlan]] = (None, None)


def active_plan() -> Optional[FaultPlan]:
    """The plan fault hooks consult: an explicitly installed one
    (tests), else the ``REPRO_FAULTS`` env plan (hard crashes), else
    None. Cheap enough for hot paths: one dict lookup when the env
    value hasn't changed."""
    global _env_cache
    if _explicit_set:
        return _explicit
    spec = os.environ.get(_ENV_VAR) or None
    if spec == _env_cache[0]:
        return _env_cache[1]
    plan = FaultPlan.parse(spec, hard=True) if spec else None
    _env_cache = (spec, plan)
    return plan


def use_plan(plan: Optional[FaultPlan]) -> None:
    """Install ``plan`` process-wide (tests); ``None`` reverts to the
    environment-driven plan."""
    global _explicit, _explicit_set
    _explicit = plan
    _explicit_set = plan is not None


@contextmanager
def plan_scope(plan: Optional[FaultPlan]):
    """``with plan_scope(plan): ...`` — scoped ``use_plan``."""
    global _explicit, _explicit_set
    prev, prev_set = _explicit, _explicit_set
    _explicit, _explicit_set = plan, plan is not None
    try:
        yield plan
    finally:
        _explicit, _explicit_set = prev, prev_set


# -- hook helpers (inert when no plan is active) ---------------------------

def crash_point(site: str, key: str, attempt: int = 0) -> None:
    """The named crash-point hook worker/spool code calls inline."""
    plan = active_plan()
    if plan is not None:
        plan.maybe_crash(site, key, attempt)


def now(base: Optional[float] = None) -> float:
    """Wall clock through the active plan's skew (the spool's clock)."""
    t = time.time() if base is None else base
    plan = active_plan()
    if plan is not None:
        t += plan.clock_skew_s()
    return t
