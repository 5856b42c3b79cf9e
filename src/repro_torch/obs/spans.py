"""Named spans of the port's programs, recorded while ``torch.profiler`` runs.

``span(name)`` marks one stretch of a program: the serve engine's
admission, prefill, decode and sampling, the model's programs, each layer
and the parts of a block, the Mamba chain, and the train step's forward,
backward, clipping, compression and optimizer (``PERF.md`` §3 lists the
names). A span is on only while a ``torch.profiler`` session records
(``torch.autograd._profiler_enabled()``). Otherwise ``span`` returns one
shared null context, and a span costs that check alone.

While on, a span

* enters ``torch.profiler.record_function(name)``, so the span is a
  ``user_annotation`` event of the profiler's trace, on the kernels' clock;
* appends a ``SpanRecord`` to a bounded buffer (the last ``MAX_RECORDS``):
  its name, its parent (the enclosing span of the same thread: the
  backward of CUDA tensors, and remat's recompute inside it, run on the
  autograd engine's own thread, where their spans are roots), the thread,
  and the host's ``time.perf_counter()`` at entry and exit;
* if it is timed (``span(name, timed=True)``) and CUDA is initialised,
  records a timing ``torch.cuda.Event`` on the current stream at entry and
  another at exit. Two events cost a span tens of microseconds under the
  profiler, so only the spans whose device time the benchmark's metrics
  read are timed: ``serve.prefill``, ``hybrid.mamba``, ``train.clip`` and
  ``train.optimizer``.

``records(since, until)`` returns the closed records inside a host-clock
interval, with ``device_ms`` filled in: the device clock from a timed
span's entry event to its exit event (``None`` for an untimed span, and
without CUDA). Where the host runs ahead of the device (prefill, a train
step), that is the time of the span's kernels. Where the host paces the
device (decode), it also holds the device's idle time inside the span.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, List, Optional, Tuple

import torch

__all__ = ["span", "records", "clear", "SpanRecord", "MAX_RECORDS"]

MAX_RECORDS = 1 << 16

_active = torch.autograd._profiler_enabled    # the gate: a profiler session records
_OFF = contextlib.nullcontext()
_IDS = itertools.count()
_LOCAL = threading.local()


@dataclass(eq=False)
class SpanRecord:
    id: int
    name: str
    parent: Optional[int]       # id of the enclosing span on the same thread
    thread: int
    t_start: float              # host perf_counter, seconds
    t_end: Optional[float] = None
    device_ms: Optional[float] = None
    events: Optional[Tuple[Any, Any]] = field(default=None, repr=False)


_BUFFER: Deque[SpanRecord] = deque(maxlen=MAX_RECORDS)


def _stack() -> List[SpanRecord]:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class _Span:
    __slots__ = ("name", "timed", "rec", "fn")

    def __init__(self, name: str, timed: bool):
        self.name, self.timed = name, timed

    def __enter__(self):
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        stack = _stack()
        rec = SpanRecord(next(_IDS), self.name, stack[-1].id if stack else None,
                         threading.get_ident(), 0.0)
        if self.timed and torch.cuda.is_initialized():
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        stack.append(rec)
        _BUFFER.append(rec)
        self.rec = rec
        rec.t_start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec.t_end = time.perf_counter()
        try:
            if rec.events is not None:
                rec.events[1].record()
        finally:
            _stack().pop()
            self.fn.__exit__(*exc)
        return False


def span(name: str, timed: bool = False):
    """A context that marks ``name`` while a profiler records (with its
    device time where ``timed``); else one shared null context."""
    return _Span(name, timed) if _active() else _OFF


def records(since: Optional[float] = None, until: Optional[float] = None
            ) -> List[SpanRecord]:
    """The closed records that start at or after ``since`` and end at or
    before ``until`` (host ``perf_counter`` seconds), in order of entry,
    with ``device_ms`` filled in (synchronising on each exit event)."""
    out = [r for r in list(_BUFFER) if r.t_end is not None
           and (since is None or r.t_start >= since) and (until is None or r.t_end <= until)]
    for r in out:
        if r.events is not None:
            start, end = r.events
            end.synchronize()
            r.device_ms = start.elapsed_time(end)
            r.events = None
    return out


def clear() -> None:
    """Empty the buffer."""
    _BUFFER.clear()
