"""Serving substrate.

Two halves with different import weights:

* ``serve.engine`` — the batched ``ServeEngine`` on the port's torch model.
* ``serve.traffic`` / ``serve.fleet`` — the modeled thing: synthetic
  arrival traces and the event-based fleet simulator that serving
  campaigns refine through ``sweep.refine``.

The engine symbols are re-exported lazily (PEP 562): importing
``repro_torch.serve.fleet`` from a refinement worker must not load the
model stack.
"""
from typing import TYPE_CHECKING

__all__ = ["Request", "ServeEngine", "make_decode_fn", "make_prefill_fn"]

if TYPE_CHECKING:  # pragma: no cover - static analysis only
    from .engine import (Request, ServeEngine, make_decode_fn,
                         make_prefill_fn)


def __getattr__(name):
    if name in __all__:
        from . import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
