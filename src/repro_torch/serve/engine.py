"""Serving: prefill/decode step factories + a batched engine.

Counterpart of ``repro/serve/engine.py``. ``make_prefill_fn`` /
``make_decode_fn`` wrap the model's serving programs; the ``ServeEngine``
adds the operational layer: request queue, continuous batching into fixed
decode slots, greedy sampling, and straggler mitigation — a request that
exceeds its decode deadline is evicted and re-queued (bounded retries), so
one stuck stream cannot head-of-line-block the batch.

The programs run eagerly on the parameters' device (there is no ``jit``);
the decode cache is updated in place where the reference donates it. With
sharding ``rules`` (keyword, as the reference's argument) they run under
them: DTensor parameters, a cache laid out by ``Model.cache_pspecs``.

While a ``torch.profiler`` session records, spans (``obs/spans.py``) mark
the padded batch's upload (``serve.admit``), the programs (``serve.prefill``,
``serve.decode``: inside the functions the factories return, so nothing a
caller wraps around them) and the greedy sampling with its wait for the
logits (``serve.sample``).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..distributed.sharding import ShardingRules, use_rules
from ..models.model import Model
from ..obs.spans import span

__all__ = ["make_prefill_fn", "make_decode_fn", "ServeEngine", "Request"]


def _no_grad(rules: Optional[ShardingRules]):
    """Inference mode; ``no_grad`` under rules, since a DTensor view made in
    inference mode of a tensor made outside it cannot take a version
    counter."""
    return torch.inference_mode() if rules is None else torch.no_grad()


def make_prefill_fn(model: Model, smax: int, *, rules: Optional[ShardingRules] = None
                    ) -> Callable:
    def prefill(params, batch):
        with span("serve.prefill", timed=True), _no_grad(rules), use_rules(rules):
            return model.prefill(params, batch, smax)

    return prefill


def make_decode_fn(model: Model, *, rules: Optional[ShardingRules] = None) -> Callable:
    def decode(params, cache, tokens):
        with span("serve.decode"), _no_grad(rules), use_rules(rules):
            return model.decode_step(params, cache, tokens)

    return decode


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # [S] int32
    max_new: int
    generated: List[int] = field(default_factory=list)
    retries: int = 0
    deadline_steps: Optional[int] = None  # straggler budget per request
    steps_used: int = 0

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new


class ServeEngine:
    """Single-slot-group batched decoder (greedy sampling).

    The correctness reference for the serving programs plus the
    scheduling/straggler logic. Token batches go to the device of the
    embedding table.
    """

    def __init__(self, model: Model, params, *, smax: int,
                 rules: Optional[ShardingRules] = None, max_retries: int = 1):
        self.model = model
        self.params = params
        self.smax = smax
        self.rules = rules
        self.max_retries = max_retries
        self.device = params["embed"].device
        self.prefill_fn = make_prefill_fn(model, smax, rules=rules)
        self.decode_fn = make_decode_fn(model, rules=rules)
        self.queue: Deque[Request] = deque()
        self.completed: Dict[int, Request] = {}
        self.evicted: List[int] = []
        self.evicted_partial: Dict[int, Request] = {}
        self._rid = 0

    def submit(self, prompt: np.ndarray, max_new: int = 16,
               deadline_steps: Optional[int] = None) -> int:
        self._rid += 1
        self.queue.append(Request(self._rid, np.asarray(prompt, np.int32),
                                  max_new, deadline_steps=deadline_steps))
        return self._rid

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(toks, np.int64)).to(self.device)

    def _prefill_batch(self, reqs: List[Request]):
        with span("serve.admit"):
            S = max(len(r.prompt) for r in reqs)
            toks = np.zeros((len(reqs), S), np.int32)
            for i, r in enumerate(reqs):
                # left-pad with token 0 and NO attention mask, as the reference
                # does: pad positions are attended, so tokens match it exactly
                toks[i, S - len(r.prompt):] = r.prompt
            tokens = self._tokens(toks)
        return self.prefill_fn(self.params, {"tokens": tokens})

    @staticmethod
    def _greedy(logits: torch.Tensor) -> np.ndarray:
        with span("serve.sample"):
            if isinstance(logits, DTensor):
                logits = logits.full_tensor()
            return logits.argmax(-1).cpu().numpy().astype(np.int32)

    def run(self, batch_size: int = 4) -> Dict[int, List[int]]:
        """Drain the queue; returns {rid: generated tokens}.

        Permanently-evicted stragglers (retry budget exhausted) keep
        their rid in ``self.evicted`` AND contribute whatever they
        generated to the returned mapping.
        """
        while self.queue:
            reqs = [self.queue.popleft() for _ in
                    range(min(batch_size, len(self.queue)))]
            logits, cache = self._prefill_batch(reqs)
            next_tok = self._greedy(logits)
            live = list(range(len(reqs)))
            while live:
                for i in list(live):
                    r = reqs[i]
                    r.generated.append(int(next_tok[i]))
                    r.steps_used += 1
                    if r.done:
                        live.remove(i)
                        self.completed[r.rid] = r
                    elif (r.deadline_steps is not None
                          and r.steps_used >= r.deadline_steps):
                        # straggler: evict; re-queue with remaining budget
                        live.remove(i)
                        if r.retries < self.max_retries:
                            r.retries += 1
                            r.steps_used = 0
                            self.queue.append(r)
                        else:
                            self.evicted.append(r.rid)
                            self.evicted_partial[r.rid] = r
                if not live:
                    break
                logits, cache = self.decode_fn(
                    self.params, cache, self._tokens(next_tok)[:, None])
                next_tok = self._greedy(logits)
        out = {rid: r.generated for rid, r in self.completed.items()}
        out.update({rid: r.generated
                    for rid, r in self.evicted_partial.items()})
        return out
