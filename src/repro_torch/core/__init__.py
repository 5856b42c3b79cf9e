"""TPU-EM core: the paper's event-driven simulation kernel (§3.1).

``engine``     — Environment / Process / Event / Timeout / conditions
``resources``  — Store / PriorityStore / Container / Resource
``trace``      — activity sampling shared by perf + Power-EM
``vectorized`` — beyond-paper vmap-able analytic scheduler for sweeps
"""
from .engine import (
    AllOf,
    AnyOf,
    Condition,
    Environment,
    Event,
    Interrupt,
    Process,
    Timeout,
    NORMAL,
    URGENT,
)
from .resources import Container, PriorityItem, PriorityStore, Resource, Store
from .trace import ActivitySample, SampleArrays, TaskRecord, Tracer, pti_bins

__all__ = [
    "AllOf",
    "AnyOf",
    "Condition",
    "Environment",
    "Event",
    "Interrupt",
    "Process",
    "Timeout",
    "NORMAL",
    "URGENT",
    "Container",
    "PriorityItem",
    "PriorityStore",
    "Resource",
    "Store",
    "ActivitySample",
    "SampleArrays",
    "TaskRecord",
    "Tracer",
    "pti_bins",
]
