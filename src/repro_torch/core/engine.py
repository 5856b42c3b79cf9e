"""Discrete-event simulation kernel for TPU-EM.

This is the paper's §3.1 substrate. SimPy is not available in this
environment, and the event engine is the core of the contribution, so it is
implemented natively with the same five primitives VPU-EM names:

  * ``Environment``  — testbench construction + simulation launch
  * ``Store``        — hardware FIFOs and queues           (resources.py)
  * ``Container``    — shared memory                        (resources.py)
  * ``Process``      — concurrent hardware modules / FSMs
  * ``Event``        — handshake signals (e.g. interrupts)

Design rules:
  - deterministic: the event queue orders by (time, priority, sequence id);
    no wall-clock, no RNG — identical inputs give identical traces.
  - two event levels (paper §3.1.1): *task-level* events are plain Events /
    Store handoffs between scheduler and engine processes; *sub-task* events
    are Timeouts inside an engine's pipeline-stage processes.
"""
from __future__ import annotations

import heapq
from typing import Any, Callable, Generator, Iterable, Optional

__all__ = [
    "Environment",
    "Event",
    "Timeout",
    "Process",
    "Condition",
    "AllOf",
    "AnyOf",
    "Interrupt",
    "SimulationEnd",
    "PENDING",
    "URGENT",
    "NORMAL",
]

# Sentinel for "event not yet triggered".
PENDING = object()

# Scheduling priorities (lower runs first at equal time).
URGENT = 0
NORMAL = 1


class Interrupt(Exception):
    """Thrown into a process by ``Process.interrupt`` (e.g. engine reset,
    straggler preemption)."""

    def __init__(self, cause: Any = None):
        super().__init__(cause)
        self.cause = cause


class SimulationEnd(Exception):
    """Raised internally to stop ``Environment.run(until=...)``."""


class Event:
    """A one-shot occurrence at a point in simulated time.

    Processes wait on events by ``yield``-ing them. An event carries a value
    (``succeed``) or an exception (``fail``).
    """

    __slots__ = ("env", "callbacks", "_value", "_ok", "_defused")

    def __init__(self, env: "Environment"):
        self.env = env
        self.callbacks: Optional[list] = []
        self._value: Any = PENDING
        self._ok: bool = True
        self._defused = False

    # -- state ------------------------------------------------------------
    @property
    def triggered(self) -> bool:
        return self._value is not PENDING

    @property
    def processed(self) -> bool:
        return self.callbacks is None

    @property
    def ok(self) -> bool:
        return self._ok

    @property
    def value(self) -> Any:
        if self._value is PENDING:
            raise RuntimeError(f"{self!r} not yet triggered")
        return self._value

    # -- triggering -------------------------------------------------------
    def succeed(self, value: Any = None, priority: int = NORMAL) -> "Event":
        if self._value is not PENDING:
            raise RuntimeError(f"{self!r} already triggered")
        self._ok = True
        self._value = value
        self.env._schedule(self, priority)
        return self

    def fail(self, exc: BaseException, priority: int = NORMAL) -> "Event":
        if self._value is not PENDING:
            raise RuntimeError(f"{self!r} already triggered")
        if not isinstance(exc, BaseException):
            raise TypeError("fail() needs an exception")
        self._ok = False
        self._value = exc
        self.env._schedule(self, priority)
        return self

    def trigger(self, event: "Event") -> None:
        """Mirror another (processed) event's outcome onto this one."""
        self._ok = event._ok
        self._value = event._value
        self.env._schedule(self)

    def __repr__(self):
        st = "pending" if self._value is PENDING else ("ok" if self._ok else "failed")
        return f"<{type(self).__name__} {st} at t={self.env.now}>"

    # -- composition ------------------------------------------------------
    def __and__(self, other: "Event") -> "Condition":
        return AllOf(self.env, [self, other])

    def __or__(self, other: "Event") -> "Condition":
        return AnyOf(self.env, [self, other])


class Timeout(Event):
    """Sub-task-level event: elapse of simulated time (pipeline-stage
    latency, transfer duration, ...). Scheduled immediately on creation."""

    __slots__ = ("delay",)

    def __init__(self, env: "Environment", delay: float, value: Any = None):
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        super().__init__(env)
        self.delay = delay
        self._ok = True
        self._value = value
        env._schedule(self, NORMAL, delay)


class Initialize(Event):
    """Starts a process when processed (URGENT so processes begin before any
    same-time Timeout fires)."""

    __slots__ = ()

    def __init__(self, env: "Environment", process: "Process"):
        super().__init__(env)
        self.callbacks.append(process._resume)
        self._ok = True
        self._value = None
        env._schedule(self, URGENT)


class Process(Event):
    """A concurrent hardware module / state machine driven by a generator.

    The generator yields ``Event``s; the process is itself an ``Event`` that
    triggers when the generator returns (value = return value).
    """

    __slots__ = ("_generator", "_target", "name")

    def __init__(self, env: "Environment", generator: Generator, name: str = ""):
        if not hasattr(generator, "throw"):
            raise TypeError(f"{generator!r} is not a generator")
        super().__init__(env)
        self._generator = generator
        self.name = name or getattr(generator, "__name__", "process")
        self._target: Optional[Event] = Initialize(env, self)

    @property
    def is_alive(self) -> bool:
        return self._value is PENDING

    def interrupt(self, cause: Any = None) -> None:
        """Throw ``Interrupt`` into the process at the current time."""
        if self._value is not PENDING:
            raise RuntimeError(f"{self} already terminated")
        if self._target is self.env.active_process:
            raise RuntimeError("a process cannot interrupt itself")
        # Deliver via a special immediate event so ordering stays in-queue.
        event = Event(self.env)
        event._ok = False
        event._value = Interrupt(cause)
        event._defused = True
        event.callbacks.append(self._resume)
        self.env._schedule(event, URGENT)
        # Disconnect from the event we were waiting on.
        if self._target is not None and self._target.callbacks is not None:
            try:
                self._target.callbacks.remove(self._resume)
            except ValueError:
                pass
        self._target = None

    def _resume(self, event: Event) -> None:
        env = self.env
        env._active_proc = self
        while True:
            try:
                if event._ok:
                    next_ev = self._generator.send(event._value)
                else:
                    event._defused = True
                    exc = event._value
                    next_ev = self._generator.throw(exc)
            except StopIteration as e:
                # Generator finished: trigger the process event.
                self._ok = True
                self._value = getattr(e, "value", None)
                env._schedule(self)
                break
            except BaseException as e:
                self._ok = False
                self._value = e
                self._defused = False
                env._schedule(self)
                break

            # Subscribe to the yielded event.
            if not isinstance(next_ev, Event):
                exc = TypeError(
                    f"process {self.name!r} yielded non-event {next_ev!r}"
                )
                self._generator.close()
                self._ok = False
                self._value = exc
                self._defused = False
                env._schedule(self)
                break
            if next_ev.callbacks is not None:
                # Not yet processed: wait for it.
                next_ev.callbacks.append(self._resume)
                self._target = next_ev
                break
            # Already processed: continue immediately with its outcome.
            event = next_ev

        env._active_proc = None


class Condition(Event):
    """Waits on several events; triggers per ``evaluate``."""

    __slots__ = ("_events", "_count", "_evaluate")

    def __init__(
        self,
        env: "Environment",
        evaluate: Callable[[list, int], bool],
        events: Iterable[Event],
    ):
        super().__init__(env)
        self._events = list(events)
        self._count = 0
        self._evaluate = evaluate
        for ev in self._events:
            if ev.env is not env:
                raise ValueError("events from different environments")
        if not self._events:
            self.succeed([])
            return
        for ev in self._events:
            if ev.callbacks is None:  # already processed
                self._check(ev)
            else:
                ev.callbacks.append(self._check)

    def _check(self, event: Event) -> None:
        if self._value is not PENDING:
            return
        self._count += 1
        if not event._ok:
            event._defused = True
            self.fail(event._value)
        elif self._evaluate(self._events, self._count):
            self.succeed([e._value for e in self._events if e._value is not PENDING])


class AllOf(Condition):
    __slots__ = ()

    def __init__(self, env, events):
        super().__init__(env, lambda evs, n: n >= len(evs), events)

    def _check(self, event: Event) -> None:
        # specialized: skip the evaluate() indirection and — at
        # success, when every event has triggered by definition — the
        # PENDING filter of the generic value-list rebuild
        if self._value is not PENDING:
            return
        self._count += 1
        if not event._ok:
            event._defused = True
            self.fail(event._value)
        elif self._count >= len(self._events):
            self.succeed([e._value for e in self._events])


class AnyOf(Condition):
    __slots__ = ()

    def __init__(self, env, events):
        super().__init__(env, lambda evs, n: n >= 1, events)


class Environment:
    """Simulation environment: event queue + clock + launch API.

    Time unit is abstract; TPU-EM uses **nanoseconds** throughout (hw models
    convert cycles→ns via their clock).
    """

    def __init__(self, initial_time: float = 0.0, *, stats: bool = False):
        self._now = float(initial_time)
        self._queue: list = []  # (time, priority, eid, event)
        self._eid = 0
        self._active_proc: Optional[Process] = None
        # kernel observability (obs.metrics): collected only when
        # ``stats`` is set — the default run loop stays untouched, which
        # is what keeps the off-by-default overhead contract (<5%)
        self.stats = stats
        self.events_processed = 0
        self.peak_heap = 0

    # -- clock ------------------------------------------------------------
    @property
    def now(self) -> float:
        return self._now

    @property
    def active_process(self) -> Optional[Process]:
        return self._active_proc

    # -- event factories ----------------------------------------------------
    def event(self) -> Event:
        return Event(self)

    def timeout(self, delay: float, value: Any = None) -> Timeout:
        return Timeout(self, delay, value)

    def process(self, generator: Generator, name: str = "") -> Process:
        return Process(self, generator, name)

    def all_of(self, events: Iterable[Event]) -> AllOf:
        return AllOf(self, events)

    def any_of(self, events: Iterable[Event]) -> AnyOf:
        return AnyOf(self, events)

    # -- scheduling ---------------------------------------------------------
    def _schedule(self, event: Event, priority: int = NORMAL,
                  delay: float = 0.0, _push=heapq.heappush):
        self._eid += 1
        _push(self._queue, (self._now + delay, priority, self._eid, event))

    def peek(self) -> float:
        """Time of the next scheduled event (inf if none)."""
        return self._queue[0][0] if self._queue else float("inf")

    def step(self) -> None:
        """Process the next event."""
        t, _, _, event = heapq.heappop(self._queue)
        self._now = t
        callbacks, event.callbacks = event.callbacks, None
        for cb in callbacks:
            cb(event)
        if not event._ok and not event._defused:
            # Nobody caught the failure.
            exc = event._value
            raise exc

    def run(self, until: Any = None) -> Any:
        """Run until time ``until``, until event ``until`` triggers, or until
        the queue drains."""
        stop_at = None
        stop_ev: Optional[Event] = None
        if until is not None:
            if isinstance(until, Event):
                stop_ev = until
                if stop_ev.processed:
                    if not stop_ev._ok:
                        raise stop_ev._value
                    return stop_ev._value
            else:
                stop_at = float(until)
                if stop_at < self._now:
                    raise ValueError(f"until={stop_at} < now={self._now}")
        # hot loop: step() inlined with the heap bound to locals — the
        # event kernel spends most of its cycles right here
        queue = self._queue
        pop = heapq.heappop
        if self.stats:
            return self._run_instrumented(queue, pop, stop_at, stop_ev)
        while queue:
            if stop_at is not None and queue[0][0] >= stop_at:
                self._now = stop_at
                return None
            t, _, _, event = pop(queue)
            self._now = t
            callbacks, event.callbacks = event.callbacks, None
            for cb in callbacks:
                cb(event)
            if not event._ok and not event._defused:
                raise event._value
            if stop_ev is not None and stop_ev.callbacks is None:
                if not stop_ev._ok:
                    raise stop_ev._value
                return stop_ev._value
        if stop_ev is not None:
            raise RuntimeError("queue drained before `until` event triggered")
        return None

    def _run_instrumented(self, queue: list, pop, stop_at, stop_ev) -> Any:
        """The same inlined run loop plus kernel telemetry: events
        processed and peak heap depth, accumulated in locals and flushed
        once at exit (so the enabled-path overhead is one int add and
        one compare per event)."""
        n = self.events_processed
        peak = self.peak_heap
        try:
            while queue:
                depth = len(queue)
                if depth > peak:
                    peak = depth
                if stop_at is not None and queue[0][0] >= stop_at:
                    self._now = stop_at
                    return None
                t, _, _, event = pop(queue)
                self._now = t
                n += 1
                callbacks, event.callbacks = event.callbacks, None
                for cb in callbacks:
                    cb(event)
                if not event._ok and not event._defused:
                    raise event._value
                if stop_ev is not None and stop_ev.callbacks is None:
                    if not stop_ev._ok:
                        raise stop_ev._value
                    return stop_ev._value
            if stop_ev is not None:
                raise RuntimeError(
                    "queue drained before `until` event triggered")
            return None
        finally:
            self.events_processed = n
            self.peak_heap = peak
