"""Shared pieces of the harness: paths, loading of data files and of the
per-name modules (loops, metric readers, rooflines, FLOP counts,
references), seeds, the weights factory and percentiles."""
from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["BENCH", "ROOT", "load_json", "load_module", "sub_seed", "make_params",
           "percentile", "tree_leaves", "mark", "host_between", "Record"]

BENCH = Path(__file__).resolve().parents[1]     # portbench/
ROOT = BENCH.parent                             # the checkout

_MODULES: Dict[str, ModuleType] = {}


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str) -> ModuleType:
    """``portbench/<kind>/<name>.py`` as a module: imported as
    ``portbench.<kind>.<name>`` where the name is an identifier, else
    loaded from its path (metric names hold dots)."""
    key = f"{kind}/{name}"
    if key not in _MODULES and name.isidentifier():
        _MODULES[key] = importlib.import_module(f"portbench.{kind}.{name}")
    if key not in _MODULES:
        path = BENCH / kind / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
        mod_name = "portbench._" + key.replace("/", "_").replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def sub_seed(seed: int, *tags) -> int:
    """A seed below 2**62 for one purpose, from the run's seed (any size)."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).hexdigest()
    return int(h[:15], 16)


def tree_leaves(tree):
    """Leaves of a tree of dicts (keys sorted) and lists."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t) for t in tree)
    return fn(tree)


def make_params(layout, seed: int, dtype, device):
    """The parameters of ``layout`` (a tree of ``reference.common.Leaf``)
    from ``seed``: every drawn leaf is a view of one flat buffer filled by
    one ``torch.randn`` call on ``device`` in ``dtype``, then scaled in
    place; constant leaves are filled. The same seed on the same device
    gives the same values."""
    import torch

    drawn = [lf for lf in tree_leaves(layout) if lf.init == "normal"]
    total = sum(math.prod(lf.shape) for lf in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    offset = [0]

    def make(lf):
        if lf.init == "ones":
            return torch.ones(lf.shape, dtype=dtype, device=device)
        if lf.init == "zeros":
            return torch.zeros(lf.shape, dtype=dtype, device=device)
        n = math.prod(lf.shape)
        t = flat[offset[0]:offset[0] + n].view(lf.shape)
        offset[0] += n
        return t.mul_(lf.scale)

    return _map(make, layout)


def percentile(values, q: float) -> Optional[float]:
    """The q-th percentile (linear interpolation between ranks)."""
    if not len(values):
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def mark(rec, name: str) -> None:
    """Note the time a phase ended (printed on standard error), with what
    this process alone can read of the host: its CPU seconds, the main
    thread's, and its involuntary context switches (``host_between``)."""
    import resource
    import time
    ru = resource.getrusage(resource.RUSAGE_SELF)
    rec.setdefault("marks", []).append((name, time.perf_counter()))
    rec.setdefault("host", {})[name] = (time.perf_counter(), ru.ru_utime + ru.ru_stime,
                                        time.thread_time(), ru.ru_nivcsw)


def host_between(rec, a: str, b: str) -> Optional[str]:
    """The host as this process saw it from mark ``a`` to mark ``b``."""
    h = rec.get("host", {})
    if a not in h or b not in h:
        return None
    (w0, c0, t0, n0), (w1, c1, t1, n1) = h[a], h[b]
    wall = w1 - w0
    return (f"{wall:.3f} s wall, process CPU {(c1 - c0) / wall:.3f} s/s, main thread "
            f"{(t1 - t0) / wall:.3f} s/s, {n1 - n0} involuntary context switches")


class Record(dict):
    """What a loop measured in one run, read by the metric readers:
    attribute access over a dict."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k) from None

    def __setattr__(self, k, v):
        self[k] = v
