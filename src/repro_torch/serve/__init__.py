"""Serving substrate: the batched ``ServeEngine`` on the port's model."""
from .engine import Request, ServeEngine, make_decode_fn, make_prefill_fn

__all__ = ["Request", "ServeEngine", "make_decode_fn", "make_prefill_fn"]
