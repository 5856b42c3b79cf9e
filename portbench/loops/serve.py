"""Closed-loop serving through ``ServeEngine.run``.

Traffic parameters (the mix's data file): ``clients`` closed-loop clients,
each sending its next request once its last one is answered; the engine
takes them as one batch of ``engine_batch``. Prompt lengths follow
``prompt_len`` ``{"median", "sigma", "min", "max"}``, a log-normal truncated
to [min, max), drawn by strata of probability: client s of every round
draws from the s-th of ``clients`` equal slices of the distribution
(``schedule``), so every seed serves the same set of lengths in another
order; token ids are uniform over the vocabulary. ``max_new`` greedy tokens a request, cache capacity
``smax``. ``warmup_rounds`` rounds at each stratum's longest length before
the window; with ``--trace 1`` the window's first ``profile_rounds`` rounds
run under the profiler.

Timing, host clock: a request's first token is ready when the engine's
``prefill_fn`` returns, synchronised (the greedy sampling that follows
synchronises anyway); its last when ``run`` returns. ``decode_fn`` is timed
the same way. The window runs whole rounds until ``--seconds`` have passed
(and at least ``check_rounds``).

Correctness: after the window, ``check_rounds`` rounds drawn from the seed,
the round with the longest prompt always among them: the reference's full
forward over each request as served (the left padding of its batch, the
prompt, its served tokens but the last) gives logits at every served
position, and the number compared is the widest gap by which a served
token's logit lies below the reference's best there.

Planted faults (``fault``, for the tests and ``calibrate.py``): ``token``
alters a served token where it is produced; ``stale_state`` leaves a decode
step's cache as it was; ``fp8``, the control, judges in place of the served
tokens the ones the reference with float8 products puts first at the same
positions.
"""
from __future__ import annotations

import gc
import math
import time
from statistics import NormalDist

import numpy as np

from portbench.harness.common import load_module, make_params, mark, sub_seed
from portbench.harness.port import port_config, sync_fn
from portbench.harness.profile import Stretch

__all__ = ["run", "schedule", "longest_per_stratum"]


def _length(t, u):
    """Prompt lengths at probabilities ``u`` in [0, 1) of the mix's
    distribution (its quantile function, floored)."""
    u = np.asarray(u, dtype=np.float64)
    d = t["prompt_len"]
    nd = NormalDist(math.log(d["median"]), d["sigma"])
    f_lo, f_hi = nd.cdf(math.log(d["min"])), nd.cdf(math.log(d["max"]))
    z = [nd.inv_cdf(f_lo + x * (f_hi - f_lo)) for x in u.ravel()]
    out = np.floor(np.exp(np.array(z))).reshape(u.shape).astype(np.int64)
    return np.clip(out, d["min"], d["max"] - 1)


def longest_per_stratum(t):
    """The longest prompt ``schedule`` gives each client (the warm-up's)."""
    k = t["clients"]
    return _length(t, (np.arange(k) + (k - 0.5) / k) / k)


def schedule(t, seed: int, rounds: int):
    """Prompt lengths [rounds, clients]. Rounds come in blocks of
    ``clients``; in every block client s draws each of ``clients`` fixed
    points of stratum s of the distribution once, in an order the seed
    sets. So every seed serves the same set of lengths in each block (and,
    the longest stratum padding each batch, the same padded lengths), in
    another order."""
    k = t["clients"]
    rng = np.random.default_rng(sub_seed(seed, "lengths"))
    blocks = -(-rounds // k)
    order = np.stack([rng.permuted(np.tile(np.arange(k), (k, 1)), axis=1)
                      for _ in range(blocks)])                   # [blocks, clients, k]
    j = order.transpose(0, 2, 1).reshape(blocks * k, k)[:rounds]   # [rounds, clients]
    return _length(t, (np.arange(k)[None, :] + (j + 0.5) / k) / k)


def _prompts(seed: int, r: int, lens, vocab: int):
    rng = np.random.default_rng(sub_seed(seed, "prompts", r))
    return [rng.integers(0, vocab, size=int(n), dtype=np.int32) for n in lens]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone() if hasattr(tree, "clone") else tree


def _restore(dst, src):
    if isinstance(dst, dict):
        for k in dst:
            if k != "pos":
                _restore(dst[k], src[k])
    elif isinstance(dst, list):
        for a, b in zip(dst, src):
            _restore(a, b)
    else:
        dst.copy_(src)


def run(rec, limits, fault=None):
    import torch
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeEngine

    c, t, seed = rec.cfg, rec.traffic, rec.seed
    dev = torch.device(rec.device)
    mark(rec, "import program")
    sync = sync_fn(dev)
    ref = load_module("reference", c["reference"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        mark(rec, "device context")
    model = build_model(port_config(c), remat=False)
    params = make_params(ref.layout(c), seed, getattr(torch, c["dtype"]), dev)
    engine = ServeEngine(model, params, smax=t["smax"])
    mark(rec, "weights")
    pre0, dec0 = engine.prefill_fn, engine.decode_fn
    cur = {}

    def prefill(p, batch):
        out = pre0(p, batch)
        if fault == "token":                # a served token altered where it is produced
            logits = out[0].clone()
            top = logits[0].argmax()
            logits[0, (top + 1) % logits.shape[-1]] = logits[0, top] + 1.0
            out = (logits, out[1])
        sync()
        cur["t_first"] = time.perf_counter()
        return out

    def decode(p, cache, tokens):
        t0 = time.perf_counter()
        keep = _clone(cache) if fault == "stale_state" else None
        out = dec0(p, cache, tokens)
        if keep is not None:                # a decode step that leaves its state as it was
            with torch.inference_mode():
                _restore(out[1], keep)
        sync()
        cur["decode_s"] += time.perf_counter() - t0
        cur["decode_steps"] += 1
        return out

    engine.prefill_fn, engine.decode_fn = prefill, decode
    vocab = c["vocab_size"]

    def do_round(r, lens, stream, profiled):
        prompts = _prompts(seed if stream == "window" else sub_seed(seed, stream), r, lens,
                           vocab)
        cur.update(decode_s=0.0, decode_steps=0)
        t0 = time.perf_counter()
        rids = [engine.submit(p, max_new=t["max_new"]) for p in prompts]
        out = engine.run(batch_size=t["engine_batch"])
        t1 = time.perf_counter()
        engine.completed.clear()
        served = [out[i] for i in rids]
        return {"t0": t0, "t1": t1, "t_first": cur["t_first"], "lens": [int(n) for n in lens],
                "S_pad": int(max(lens)), "prompts": prompts, "served": served,
                "decode_s": cur["decode_s"], "decode_steps": cur["decode_steps"],
                "profiled": profiled}

    plan = schedule(t, seed, 4096)
    # warm-up at each stratum's longest prompt: the padded batch is the
    # longest the window serves, so the allocator does not grow in it
    for r in range(t["warmup_rounds"]):
        do_round(r, longest_per_stratum(t), "warmup", False)
    sync()

    units = []
    mark(rec, "warm-up")
    st = Stretch(rec.trace, sync).start()
    t_w0 = time.perf_counter()
    rec.setup_s = t_w0 - rec.t_start
    with st:
        if rec.trace:
            for _ in range(t["profile_rounds"]):
                units.append(do_round(len(units), plan[len(units)], "window", True))
            st.units = len(units)
    rec.unprofiled_t0 = time.perf_counter()
    while time.perf_counter() - t_w0 < rec.seconds or len(units) < t["check_rounds"]:
        units.append(do_round(len(units), plan[len(units)], "window", False))
    rec.window_s = units[-1]["t1"] - t_w0
    mark(rec, "window")
    rec.units = units
    rec.requests = [{"t_submit": u["t0"], "t_first": u["t_first"], "t_done": u["t1"],
                     "tokens": len(s)} for u in units for s in u["served"]]
    rec.attempted = len(rec.requests)
    rec.failed = sum(1 for r in rec.requests if r["tokens"] != t["max_new"])
    rec.memory_peak_bytes = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    rec.trace = st.read()

    del engine, model, pre0, dec0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng(sub_seed(seed, "check"))
    longest = max(range(len(units)), key=lambda i: units[i]["S_pad"])
    rest = [i for i in range(len(units)) if i != longest]
    k = min(t["check_rounds"], len(units)) - 1
    picked = [longest] + sorted(rng.choice(rest, size=k, replace=False).tolist())
    gaps = []
    for i in picked:
        u = units[i]
        n_new = t["max_new"]
        toks = np.zeros((len(u["prompts"]), u["S_pad"] + n_new - 1), np.int64)
        for row, (p, s) in enumerate(zip(u["prompts"], u["served"])):
            toks[row, u["S_pad"] - len(p):u["S_pad"]] = p
            toks[row, u["S_pad"]:] = s[:n_new - 1]
        toks_t = torch.from_numpy(toks).to(dev)
        want = ref.logits_at(params, c, toks_t, n_new)              # [B, n_new, V]
        served = u["served"]
        if fault == "fp8":                  # the control: the token float8 puts first
            served = ref.logits_at(params, c, toks_t, n_new, prec="fp8").argmax(-1).tolist()
        best = want.max(-1).values
        for row, s in enumerate(served):
            for j, tok in enumerate(s):
                gaps.append(float(best[row, j] - want[row, j, tok]))
        del want, best
    rec.checked = len(gaps)
    return {"logit_gap": (max(gaps), limits["logit_gap"])}
