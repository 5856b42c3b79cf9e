"""Shared-resource primitives for the TPU-EM event kernel.

These mirror the SimPy classes the paper names (§3.1.3):

  * ``Store``          — hardware FIFOs / task queues (bounded, FIFO order)
  * ``PriorityStore``  — arbitration-ordered queues (NOC routers)
  * ``Container``      — shared memory capacity (VMEM/CB allocation)
  * ``Resource``       — mutually exclusive ports (memory ports, DMA channels)

All requests are Events; a process interacts by ``yield store.put(x)`` /
``item = yield store.get()`` etc. Requests resolve strictly FIFO (or by
priority) so model behaviour is deterministic.
"""
from __future__ import annotations

import heapq
import operator
from typing import Any, List

from .engine import Environment, Event, URGENT

_BY_KEY = operator.attrgetter("key")

__all__ = [
    "Store",
    "PriorityStore",
    "PriorityItem",
    "Container",
    "Resource",
]


class _Request(Event):
    __slots__ = ("item", "amount", "key")

    def __init__(self, env: Environment):
        super().__init__(env)


class Store:
    """Bounded FIFO of Python objects — the paper's hardware FIFO/queue."""

    __slots__ = ("env", "capacity", "name", "items", "_putq", "_getq",
                 "_seq", "_drainer")

    def __init__(self, env: Environment, capacity: float = float("inf"), name: str = ""):
        if capacity <= 0:
            raise ValueError("capacity must be > 0")
        self.env = env
        self.capacity = capacity
        self.name = name
        self.items: List[Any] = []
        self._putq: List[_Request] = []
        self._getq: List[_Request] = []

    # -- public API ---------------------------------------------------------
    def put(self, item: Any) -> Event:
        req = _Request(self.env)
        req.item = item
        self._putq.append(req)
        self._dispatch()
        return req

    def get(self) -> Event:
        req = _Request(self.env)
        self._getq.append(req)
        self._dispatch()
        return req

    @property
    def level(self) -> int:
        return len(self.items)

    # -- internals ------------------------------------------------------------
    def _do_put(self, req: _Request) -> bool:
        if len(self.items) < self.capacity:
            self.items.append(req.item)
            req.succeed(priority=URGENT)
            return True
        return False

    def _do_get(self, req: _Request) -> bool:
        if self.items:
            req.succeed(self.items.pop(0), priority=URGENT)
            return True
        return False

    def _dispatch(self) -> None:
        # Alternate until no progress: a completed get may unblock a put.
        progress = True
        while progress:
            progress = False
            while self._putq and self._do_put(self._putq[0]):
                self._putq.pop(0)
                progress = True
            while self._getq and self._do_get(self._getq[0]):
                self._getq.pop(0)
                progress = True


class PriorityItem:
    """Orderable wrapper: lower ``priority`` is served first; FIFO at ties."""

    __slots__ = ("priority", "item")

    def __init__(self, priority: float, item: Any):
        self.priority = priority
        self.item = item

    def __lt__(self, other: "PriorityItem") -> bool:
        return self.priority < other.priority

    def __repr__(self):
        return f"PriorityItem({self.priority}, {self.item!r})"


class PriorityStore(Store):
    """Store whose ``get`` returns the lowest-priority item (router arbiter)."""

    __slots__ = ()

    def __init__(self, env: Environment, capacity: float = float("inf"), name: str = ""):
        super().__init__(env, capacity, name)
        self._seq = 0

    def _do_put(self, req: _Request) -> bool:
        if len(self.items) < self.capacity:
            self._seq += 1
            heapq.heappush(self.items, (req.item, self._seq))
            req.succeed(priority=URGENT)
            return True
        return False

    def _do_get(self, req: _Request) -> bool:
        if self.items:
            item, _ = heapq.heappop(self.items)
            req.succeed(item, priority=URGENT)
            return True
        return False

    @property
    def level(self) -> int:
        return len(self.items)


class Container:
    """Continuous shared capacity (bytes of CB/VMEM, DMA credits...).

    ``put(n)`` adds, ``get(n)`` removes; both block until satisfiable.
    Strict FIFO per direction (no barging) for determinism.
    """

    __slots__ = ("env", "capacity", "name", "_level", "_putq", "_getq")

    def __init__(
        self,
        env: Environment,
        capacity: float = float("inf"),
        init: float = 0.0,
        name: str = "",
    ):
        if capacity <= 0:
            raise ValueError("capacity must be > 0")
        if not 0 <= init <= capacity:
            raise ValueError("0 <= init <= capacity violated")
        self.env = env
        self.capacity = capacity
        self.name = name
        self._level = float(init)
        self._putq: List[_Request] = []
        self._getq: List[_Request] = []

    @property
    def level(self) -> float:
        return self._level

    def put(self, amount: float) -> Event:
        if amount <= 0:
            raise ValueError("amount must be > 0")
        req = _Request(self.env)
        req.amount = amount
        self._putq.append(req)
        self._dispatch()
        return req

    def get(self, amount: float) -> Event:
        if amount <= 0:
            raise ValueError("amount must be > 0")
        req = _Request(self.env)
        req.amount = amount
        self._getq.append(req)
        self._dispatch()
        return req

    def _dispatch(self) -> None:
        progress = True
        while progress:
            progress = False
            if self._putq and self._level + self._putq[0].amount <= self.capacity:
                req = self._putq.pop(0)
                self._level += req.amount
                req.succeed(priority=URGENT)
                progress = True
            if self._getq and self._level >= self._getq[0].amount:
                req = self._getq.pop(0)
                self._level -= req.amount
                req.succeed(priority=URGENT)
                progress = True


class Resource:
    """N interchangeable servers (memory ports, DMA channels, ICI links).

    ``yield res.request()`` acquires, ``res.release(req)`` frees. Also usable
    as a context helper:

        req = res.request()
        yield req
        ...
        res.release(req)
    """

    __slots__ = ("env", "capacity", "name", "users", "_queue", "_seq",
                 "n_requests", "n_stalls")

    def __init__(self, env: Environment, capacity: int = 1, name: str = ""):
        if capacity <= 0:
            raise ValueError("capacity must be > 0")
        self.env = env
        self.capacity = capacity
        self.name = name
        self.users: List[_Request] = []
        self._queue: List[_Request] = []
        self._seq = 0
        # contention telemetry (obs.metrics): requests seen / requests
        # that could not be granted immediately. Two int adds per
        # request — requests are orders of magnitude rarer than kernel
        # events, so this stays always-on (and deterministic).
        self.n_requests = 0
        self.n_stalls = 0

    @property
    def count(self) -> int:
        return len(self.users)

    def request(self, priority: float = 0.0) -> Event:
        req = _Request(self.env)
        # FIFO within a priority class via a per-resource sequence
        # number — NEVER id(req): grant order among equal-priority
        # contenders must be identical run to run, or simulations (and
        # the byte-identical-records backend contract) go
        # nondeterministic with memory layout
        self._seq += 1
        key = req.key = (priority, self._seq)
        q = self._queue
        # seq grows monotonically, so appends are already in order
        # unless this request carries a lower priority value
        if q and key < q[-1].key:
            q.append(req)
            q.sort(key=_BY_KEY)
        else:
            q.append(req)
        self._dispatch()
        self.n_requests += 1
        if not req.triggered:
            self.n_stalls += 1
        return req

    def release(self, req: _Request) -> None:
        if req in self.users:
            self.users.remove(req)
        else:  # cancel a queued request
            try:
                self._queue.remove(req)
            except ValueError:
                pass
        self._dispatch()

    def _dispatch(self) -> None:
        while self._queue and len(self.users) < self.capacity:
            req = self._queue.pop(0)
            self.users.append(req)
            req.succeed(priority=URGENT)
