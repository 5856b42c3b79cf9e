"""Capture of the port's own programs as simulator workloads.

The JAX package compiles a program and parses its scheduled HLO
(``graph/hlo_parser.py::extract_tasks``); the port runs its program once
under ``TaskRecorder``, a ``TorchDispatchMode``, and records each op one
device runs as a ``TaskSpec`` in execution order, the list that
``graph/ingest.py::lower_tasks`` lowers to the ``Op`` contract unchanged
(``graph/torch_ingest.py`` reads the checked-in captures, ``torch/<fixture>``
workload names). The mapping follows ``extract_tasks``:

  * ``mxu``     every op with a ``torch.utils.flop_counter`` formula (its
                FLOPs; ``gemm`` (m, n, k) with n the output's last dim, m
                its other elements, k from the FLOPs);
  * ``dma``     copies, concatenation, indexing, fills and in-place writes
                (the decode program's cache writes among them);
  * ``vector``  every other op, ``elems`` the output's elements;
  * free        views and allocations (``TRIVIAL_OPS``, ``bitcast``); a pure
                dtype conversion aliases through (``free_converts=True``);
  * ``ici``     each collective the program issues, with the HLO op names
                (``all-reduce``, ``all-gather``, ``reduce-scatter``,
                ``all-to-all``), its payload (the larger of operand and
                result bytes), group size and group count.

Each task's bytes are those of the local shards it reads and writes; its
``deps`` are the tasks that last wrote the storage of each input. The
recorder lets a DTensor op desugar first (it returns ``NotImplemented``, as
``torch.distributed.tensor.debug.CommDebugMode`` does), so it sees the
local ops and the collectives that DTensor issues, not the DTensor op.

A kernel wrapper calls ``kernel_call``: under a recorder it records ONE
task with the kernel's FLOPs and bytes and suppresses every op inside, so
a program gives the same task list on the card, through the kernels, as on
fake CPU tensors, through their plain versions. The model tags each layer
(``layer()``): its tasks are named ``layers[i].<op>.<k>``, k counted within
the layer, the form ``lower_tasks`` reads as the layer loop; the rest are
``<op>.<k>``, k counted over them. Names, order and numbers depend on the
program alone, not on ids or addresses, so one program gives the same
bytes (``dumps``).
"""
from __future__ import annotations

import contextlib
import gzip
import io
import json
import sys
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from .hlo_parser import Collective, TaskSpec

__all__ = ["TaskRecorder", "active_recorder", "kernel_call", "layer", "tasks_to_json",
           "dumps", "gzip_bytes"]

_ACTIVE: List["TaskRecorder"] = []

# ops that move no data: allocations, views the dispatcher does not mark
# as such, and the functional collectives' wait
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "arange",
         "detach", "alias", "lift_fresh", "lift_fresh_copy", "_unsafe_view", "wait_tensor",
         "_local_scalar_dense", "scalar_tensor", "resize_", "set_"}
_DMA = {"copy_", "copy", "clone", "cat", "stack", "index", "index_select", "index_put",
        "index_put_", "index_copy", "index_copy_", "gather", "scatter", "scatter_",
        "slice_scatter", "select_scatter", "embedding", "full", "zeros", "ones", "fill_",
        "zero_", "new_zeros", "new_ones", "new_full", "full_like", "zeros_like", "ones_like",
        "repeat", "repeat_interleave", "constant_pad_nd", "flip", "roll", "_to_copy",
        "masked_scatter", "as_strided_scatter"}
# functional collectives -> the HLO op name
_COLLECTIVES = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all",
                "shard_dim_alltoall": "all-to-all"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor) -> Optional[int]:
    """The storage a tensor lies in (a key only: it never reaches a name)."""
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


_PROPAGATION_CODE: List = []


def _propagation_code() -> List:
    """The code of DTensor's tensor-meta propagation (``ShardingPropagator``'s
    ``_propagate_tensor_meta*`` methods); raises where this torch has none,
    rather than record propagation as device work."""
    if not _PROPAGATION_CODE:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        for name, fn in vars(ShardingPropagator).items():
            fn = getattr(fn, "__wrapped__", fn)
            if "propagate_tensor_meta" in name and hasattr(fn, "__code__"):
                _PROPAGATION_CODE.append(fn.__code__)
        if not _PROPAGATION_CODE:
            raise RuntimeError("DTensor's ShardingPropagator has no _propagate_tensor_meta "
                               "method: the recorder cannot tell its propagation apart")
    return _PROPAGATION_CODE


def _in_sharding_propagation() -> bool:
    """Is DTensor's sharding propagation on the stack? It runs an op once on
    fake tensors of the global shapes to learn its output's (the first time
    it meets the op and its input layout): no device's work."""
    codes = _propagation_code()
    f = sys._getframe(2)
    while f is not None:
        if f.f_code in codes:
            return True
        f = f.f_back
    return False


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name).size()


class TaskRecorder(TorchDispatchMode):
    """Records the ops one device runs as ``TaskSpec``s (``self.tasks``)."""

    def __init__(self):
        super().__init__()
        self.tasks: List[TaskSpec] = []
        self._producer: Dict[int, int] = {}      # storage -> task that last wrote it
        self._suppress = 0
        self._prefix = ""
        self._k = 0                              # tasks of the current layer
        self._k_rest = 0                         # tasks outside the layers
        self._n_layers = 0

    # -- context ----------------------------------------------------------
    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)

    @contextlib.contextmanager
    def layer(self):
        """The tasks recorded inside are the next layer's."""
        prev = (self._prefix, self._k)
        self._prefix, self._k = f"layers[{self._n_layers}].", 0
        self._n_layers += 1
        try:
            yield
        finally:
            self._prefix, self._k = prev

    # -- recording ---------------------------------------------------------
    def _name(self, op: str) -> str:
        if self._prefix:
            name, self._k = f"{self._prefix}{op}.{self._k}", self._k + 1
        else:
            name, self._k_rest = f"{op}.{self._k_rest}", self._k_rest + 1
        return name

    def _deps(self, tensors) -> tuple:
        got = {self._producer.get(_key(t)) for t in tensors}
        got.discard(None)
        return tuple(sorted(got))

    def _add(self, task: TaskSpec, outs) -> None:
        self.tasks.append(task)
        idx = len(self.tasks) - 1
        for t in outs:
            k = _key(t)
            if k is not None:
                self._producer[k] = idx

    def kernel(self, name: str, engine: str, fn, inputs: Sequence[torch.Tensor], cost):
        """Run ``fn`` (a kernel launch, or its plain version) with every op
        inside unrecorded, and record one task for it: ``cost()`` gives its
        ``flops`` and ``gemm`` (mxu) or ``elems`` (vector)."""
        self._suppress += 1
        try:
            out = fn()
        finally:
            self._suppress -= 1
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        c = cost()
        self._add(TaskSpec(self._name(name), engine, flops=float(c.get("flops", 0.0)),
                           elems=float(c.get("elems", 0.0)),
                           bytes_in=float(sum(_nbytes(t) for t in inputs)),
                           bytes_out=float(sum(_nbytes(t) for t in outs)),
                           deps=self._deps(inputs), gemm=c.get("gemm")), outs)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor desugars into local ops and collectives
        out = func(*args, **kwargs)
        if not self._suppress and not _in_sharding_propagation():
            self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out) -> None:
        op = func._overloadpacket.__name__
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not outs or op in _FREE or func.is_view:     # no tensor out: a query
            held = {_key(t) for t in ins}
            for t in outs:               # a fresh storage (not a view): no writer yet
                if _key(t) not in held:
                    self._producer.pop(_key(t), None)
            return
        if op == "_to_copy" and ins and set(kwargs) <= {"dtype"}:
            # a pure dtype conversion aliases through to its operand's writer
            src = self._producer.get(_key(ins[0]))
            for t in outs:
                if src is None:
                    self._producer.pop(_key(t), None)
                else:
                    self._producer[_key(t)] = src
            return
        b_in = float(sum(_nbytes(t) for t in ins))
        b_out = float(sum(_nbytes(t) for t in outs))
        deps = self._deps(ins)
        if op in _COLLECTIVES:
            hlo = _COLLECTIVES[op]
            group = next(a for a in reversed(args) if isinstance(a, str))
            gsize = _group_size(group)
            world = dist.get_world_size() if dist.is_initialized() else gsize
            coll = Collective(op=hlo, payload_bytes=int(max(b_out, b_in)), group_size=gsize,
                              n_groups=max(world // max(gsize, 1), 1), count=1.0,
                              crosses_pod=False, name=hlo)
            task = TaskSpec(self._name(hlo), "ici", bytes_in=b_in, bytes_out=b_out,
                            collective=coll, deps=deps)
        elif func._overloadpacket in flop_registry:
            flops = float(flop_registry[func._overloadpacket](*args, **kwargs, out_val=out))
            o = outs[0]
            n = o.shape[-1] if o.dim() else 1
            m = max(o.numel() // max(n, 1), 1)
            k = max(int(round(flops / (2.0 * m * max(n, 1)))), 1)
            task = TaskSpec(self._name(op), "mxu", flops=flops, bytes_in=b_in, bytes_out=b_out,
                            deps=deps, gemm=(int(m), int(n), int(k)))
        elif op in _DMA:
            task = TaskSpec(self._name(op), "dma", bytes_in=b_in, bytes_out=b_out, deps=deps)
        else:
            task = TaskSpec(self._name(op), "vector",
                            elems=float(max(sum(t.numel() for t in outs), 1)),
                            bytes_in=b_in, bytes_out=b_out, deps=deps)
        self._add(task, outs)


def active_recorder() -> Optional[TaskRecorder]:
    return _ACTIVE[-1] if _ACTIVE else None


def kernel_call(name: str, engine: str, fn, inputs: Sequence[torch.Tensor], cost):
    """``fn()``; under a recorder, one task of the kernel's FLOPs (``mxu``)
    or elements (``vector``), as ``cost()`` gives them, and bytes
    (``inputs`` read, the result written), the ops inside unrecorded."""
    rec = active_recorder()
    if rec is None:
        return fn()
    return rec.kernel(name, engine, fn, inputs, cost)


def layer():
    """The model's layer tag: under a recorder the next layer's scope, else
    nothing."""
    rec = active_recorder()
    return contextlib.nullcontext() if rec is None else rec.layer()


# -- the fixture format ------------------------------------------------------

def _num(x: float):
    """An integral float as an int (JSON without a trailing .0)."""
    return int(x) if float(x).is_integer() else float(x)


def tasks_to_json(tasks: Sequence[TaskSpec]) -> List[dict]:
    out = []
    for t in tasks:
        d = {"name": t.name, "engine": t.engine, "flops": _num(t.flops),
             "elems": _num(t.elems), "bytes_in": _num(t.bytes_in),
             "bytes_out": _num(t.bytes_out), "deps": list(t.deps)}
        if t.gemm is not None:
            d["gemm"] = list(t.gemm)
        if t.collective is not None:
            c = t.collective
            d["collective"] = {"op": c.op, "payload_bytes": int(c.payload_bytes),
                               "group_size": c.group_size, "n_groups": c.n_groups}
        out.append(d)
    return out


def dumps(tasks: Sequence[TaskSpec]) -> bytes:
    """The fixture text of a task list: one JSON document, sorted keys."""
    return json.dumps({"tasks": tasks_to_json(tasks)}, sort_keys=True,
                      separators=(",", ":")).encode()


def gzip_bytes(text: bytes) -> bytes:
    """``text`` gzipped with mtime 0 and no file name: the same text gives
    the same bytes."""
    buf = io.BytesIO()
    with gzip.GzipFile(fileobj=buf, mode="wb", filename="", mtime=0) as gz:
        gz.write(text)
    return buf.getvalue()
