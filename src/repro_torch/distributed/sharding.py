"""Logical-axis sharding rules (DP / FSDP / TP / SP / EP) over a DeviceMesh.

Counterpart of ``repro/distributed/sharding.py``. Models are written against
*logical* axis names; a ``ShardingRules`` object maps them to the named dims
of a ``torch.distributed.device_mesh.DeviceMesh``. Outside any rules context
every constraint returns its argument untouched, so the same model code runs
on plain tensors on one device and on DTensors over a mesh.

Logical axes (as in the reference)
----------------------------------
  batch      activation batch dim                    -> ('pod','data')
  act_seq    activation sequence dim (SP regime)     -> 'model' | None
  heads      attention-head dim (TP regime)          -> 'model' | None
  kv_heads   kv-head dim                             -> None
  ff         FFN hidden dim                          -> 'model'
  vocab      vocabulary dim (embed/logits)           -> 'model'
  embed      parameter d_model dim (FSDP shard)      -> 'data'
  expert     MoE expert dim                          -> 'model'
  kv_seq     KV-cache sequence dim (flash-decoding)  -> 'model'
  ssm_inner  SSM inner-channel dim                   -> 'model'
  stack      layer-stack dim of stacked params       -> None

Two forms of one spec. ``P`` (the reference's ``PartitionSpec``, with its
string form) is indexed by tensor dim: entry i names the mesh axes that
split dim i. A DTensor's placements are indexed by mesh dim:
``placements(spec, mesh)`` gives ``Shard(i)`` on every mesh dim that splits
tensor dim i and ``Replicate()`` on the rest. A dim mapped to a tuple
(``batch`` -> ``("pod", "data")``) is ``Shard(i)`` on both mesh dims; a
DTensor splits a dim over several mesh dims in mesh order, pod outermost,
as the tuple reads.

``constrain`` is ``with_sharding_constraint``: on a DTensor it is a
``redistribute`` to the spec's placements (differentiable; the values do not
change). A plain tensor under rules is a value every rank holds whole (a
table or mask made in the model code): it enters the mesh replicated.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

__all__ = [
    "P",
    "ShardingRules",
    "rules_for",
    "active_rules",
    "use_rules",
    "bind_rules",
    "constrain",
    "logical_to_pspec",
    "logical_to_placements",
    "placements",
    "spec_of",
    "mesh_sizes",
    "to_mesh",
    "kernel_placements",
    "moved_placements",
    "whole",
    "mesh_of",
    "on_shards",
    "full_on_mesh",
    "local_offset",
    "write_along_",
    "store_",
]

Axis = Union[None, str, Tuple[str, ...]]

_STATE = threading.local()


class P(tuple):
    """A partition spec: one entry per tensor dim (None, a mesh axis name or
    a tuple of them), trailing Nones trimmed; a one-name tuple reads as the
    name. Prints as the reference's ``PartitionSpec``."""

    def __new__(cls, *parts: Axis):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in parts))

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


def mesh_sizes(mesh) -> Dict[str, int]:
    """Mesh dim name -> size."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


@dataclass(frozen=True)
class ShardingRules:
    mesh: object                 # torch.distributed.device_mesh.DeviceMesh
    table: Dict[str, Axis]
    moe_impl: str = "dense"      # "dense" | "ep"
    ep_axis: Optional[str] = None

    def axis_size(self, logical: str) -> int:
        phys = self.table.get(logical)
        if phys is None:
            return 1
        if isinstance(phys, str):
            phys = (phys,)
        sizes = mesh_sizes(self.mesh)
        n = 1
        for a in phys:
            n *= sizes[a]
        return n


def rules_for(mesh, *, n_heads: int = 0, n_experts: int = 0, d_ff: int = 0,
              moe: bool = False, fsdp: bool = True,
              sp_residual: bool = False) -> ShardingRules:
    """Divisibility-aware assignment of logical->physical axes for one arch
    (the reference's table, entry for entry). ``fsdp=False`` replicates
    parameters over the data axis (serving)."""
    sizes = mesh_sizes(mesh)
    names = tuple(sizes)
    data_axes: Tuple[str, ...] = tuple(a for a in ("pod", "data") if a in names)
    model_ax = "model" if "model" in names else None
    msize = sizes[model_ax] if model_ax else 1

    head_tp = model_ax is not None and n_heads > 0 and n_heads % msize == 0
    table: Dict[str, Axis] = {
        "batch": data_axes if data_axes else None,
        "heads": model_ax if head_tp else None,
        "act_seq": (model_ax if (sp_residual or not head_tp) else None),
        "kv_heads": None,
        "ff": model_ax if (d_ff == 0 or d_ff % max(msize, 1) == 0) else None,
        "vocab": model_ax,
        "embed": ("data" if ("data" in names and fsdp) else None),
        "expert": model_ax,
        "kv_seq": model_ax,
        "ssm_inner": model_ax,
        "stack": None,
    }
    ep_ok = moe and model_ax is not None and n_experts % max(msize, 1) == 0
    return ShardingRules(mesh=mesh, table=table, moe_impl="ep" if ep_ok else "dense",
                         ep_axis=model_ax if ep_ok else None)


def active_rules() -> Optional[ShardingRules]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def bind_rules(rules: Optional[ShardingRules]):
    """Make ``rules`` the active rules of this thread, and nothing else."""
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = rules
    try:
        yield rules
    finally:
        _STATE.rules = prev


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    """Activate ``rules`` on this thread. Under rules a plain tensor that
    meets a DTensor in an op is taken as replicated (DTensor's
    ``implicit_replication``, a process-wide switch, turned on by the
    outermost rules context of the thread and off when it exits): the
    tables and masks the model code makes are the same on every rank."""
    outer = active_rules() is None
    with bind_rules(rules):
        if rules is None or not outer:
            yield rules
        else:
            with implicit_replication():
                yield rules


def _trim(parts: List[Axis]) -> P:
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def logical_to_pspec(axes: Sequence[Optional[str]], rules: ShardingRules) -> P:
    return _trim([None if name is None else rules.table.get(name) for name in axes])


def placements(spec: P, mesh) -> List[Placement]:
    """A spec (by tensor dim) as DTensor placements (by mesh dim)."""
    names = list(mesh.mesh_dim_names)
    out: List[Placement] = [Replicate()] * len(names)
    for dim, part in enumerate(spec):
        if part is None:
            continue
        for a in ((part,) if isinstance(part, str) else part):
            i = names.index(a)
            if isinstance(out[i], Shard):
                raise ValueError(f"mesh axis {a!r} splits two dims of {spec}")
            out[i] = Shard(dim)
    return out


def logical_to_placements(axes: Sequence[Optional[str]], rules: ShardingRules
                          ) -> List[Placement]:
    return placements(logical_to_pspec(axes, rules), rules.mesh)


def spec_of(shape: Sequence[int], axes: Sequence[Optional[str]],
            rules: ShardingRules) -> P:
    """The spec of a tensor of ``shape`` by logical ``axes``, a dim that its
    mesh axes do not divide left unsharded (``param_pspecs``' guard)."""
    parts: List[Axis] = []
    for dim, name in zip(shape, axes):
        phys = rules.table.get(name) if name is not None else None
        if phys is not None:
            n = rules.axis_size(name)
            if n <= 1 or dim % n != 0:
                phys = None
        parts.append(phys)
    return _trim(parts)


def to_mesh(x: torch.Tensor, mesh) -> DTensor:
    """A plain tensor that every rank holds whole, as a replicated DTensor;
    a DTensor as it is."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """``with_sharding_constraint`` by logical axis names; returns ``x``
    untouched without rules.

    Divisibility guard: a dim that the mapped mesh axes do not evenly divide
    is left unsharded. Dedup: when two dims map to one mesh axis, the
    rightmost dim keeps it (feature/TP dims sit rightmost: [B, S(act_seq->
    model), ff(->model)] resolves to ff-sharded, the Megatron-SP
    convention).
    """
    rules = active_rules()
    if rules is None:
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"{len(axes)} axes for rank-{x.ndim} tensor")
    parts: List[Axis] = list(spec_of(x.shape, axes, rules))
    parts += [None] * (x.ndim - len(parts))
    used: set = set()
    for i in range(len(parts) - 1, -1, -1):
        phys = parts[i]
        if phys is None:
            continue
        names = (phys,) if isinstance(phys, str) else tuple(phys)
        if any(a in used for a in names):
            parts[i] = None
        else:
            used.update(names)
    want = placements(_trim(parts), rules.mesh)
    x = to_mesh(x, rules.mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(rules.mesh, want)


def mesh_of(*xs):
    """The mesh of the first DTensor among ``xs``, or None."""
    for x in xs:
        if isinstance(x, DTensor):
            return x.device_mesh
    return None


def on_shards(fn, mesh, args: Sequence[torch.Tensor],
              arg_placements: Sequence[Sequence[Placement]],
              out_placements) -> DTensor:
    """``fn`` on each rank's local shards (``shard_map``, or ``local_map``
    with its gradient layouts spelled out): each arg is redistributed to its
    placements and handed over as a plain tensor, the plain result is this
    rank's shard of the output. An arg replicated over a mesh dim that
    splits the output gets a gradient that is a partial sum there (each
    rank saw its own tokens). ``out_placements`` as a tuple of placement
    lists: ``fn`` returns that many tensors, split over the same mesh dims
    as the first, and so does the result."""
    several = isinstance(out_placements, tuple)
    first = out_placements[0] if several else out_placements
    local = []
    for a, pl in zip(args, arg_placements):
        d = to_mesh(a, mesh).redistribute(mesh, pl)
        grad_pl = [Partial() if isinstance(p, Replicate) and isinstance(o, Shard) else p
                   for p, o in zip(pl, first)]
        local.append(d.to_local(grad_placements=grad_pl))
    out = fn(*local)
    if several:
        return tuple(DTensor.from_local(o, mesh, list(pl), run_check=False)
                     for o, pl in zip(out, out_placements))
    return DTensor.from_local(out, mesh, list(out_placements), run_check=False)


def moved_placements(pl: Sequence[Placement], dims: Dict[int, Optional[int]]
                     ) -> List[Placement]:
    """Placements ``pl`` for a tensor whose dim ``dims[d]`` holds what dim
    ``d`` holds in ``pl``'s tensor (None: a dim it has not, replicated
    there): each ``Shard(d)`` becomes ``Shard(dims[d])``, anything else
    ``Replicate()``."""
    out: List[Placement] = []
    for p in pl:
        to = dims.get(p.dim) if isinstance(p, Shard) else None
        out.append(Shard(to) if to is not None else Replicate())
    return out


def whole(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """``x`` with ``dims`` unsplit (every dim when none is named): a layout
    change only; a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    nd = x.ndim
    cut = {d % nd for d in dims} if dims else set(range(nd))
    want = [Replicate() if isinstance(p, Shard) and p.dim % nd in cut else p
            for p in x.placements]
    return x if want == list(x.placements) else x.redistribute(x.device_mesh, want)


def kernel_placements(x: DTensor, keep: Sequence[int]) -> List[Placement]:
    """``x``'s placements with every split of a dim outside ``keep`` (and
    every pending sum) replaced by ``Replicate()``: the layout in which a
    kernel that needs the other dims whole runs on local shards."""
    nd = x.ndim
    keep = {d % nd for d in keep}
    return [p if isinstance(p, Shard) and p.dim % nd in keep else Replicate()
            for p in x.placements]



def full_on_mesh(shape: Sequence[int], fill: float, dtype: torch.dtype, device,
                 spec: P, mesh) -> DTensor:
    """A DTensor of ``shape`` filled with ``fill``, laid out by ``spec``
    (dims it splits divide evenly): each rank allocates its shard only."""
    pl = placements(spec, mesh)
    local = list(shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    x = torch.full(local, fill, dtype=dtype, device=device)
    return DTensor.from_local(x, mesh, pl, run_check=False)


def local_offset(x: DTensor, dim: int) -> int:
    """Where this rank's shard of ``x`` starts along ``dim`` (even splits,
    mesh dims in order, the first outermost)."""
    mesh, coord = x.device_mesh, x.device_mesh.get_coordinate()
    chunk = 0
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = chunk * mesh.size(i) + coord[i]
    return chunk * x.to_local().shape[dim]


def write_along_(dst: torch.Tensor, src: torch.Tensor, dim: int, start: int = 0,
                 index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``dst[..., start:start+n, ...] = src`` along ``dim`` (with ``index``:
    ``dst.index_copy_(dim, index, src)``), in place. On a DTensor each rank
    writes the part of the slots that its shard of ``dst`` holds; ``index``
    writes need ``dim`` unsplit (the ring caches of windowed layers, whose
    sequence dim no rule splits)."""
    if not isinstance(dst, DTensor):
        if index is None:
            dst.narrow(dim, start, src.shape[dim]).copy_(src)
        else:
            dst.index_copy_(dim, index, src)
        return dst
    mesh = dst.device_mesh
    want = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
            for p in dst.placements]
    loc = dst.to_local()
    src = to_mesh(src, mesh).redistribute(mesh, want).to_local()
    if index is not None:
        if want != list(dst.placements):
            raise ValueError(f"an indexed write along a split dim {dim}")
        loc.index_copy_(dim, index.to_local() if isinstance(index, DTensor) else index, src)
        return dst
    off, n = local_offset(dst, dim), src.shape[dim]
    lo, hi = max(start, off), min(start + n, off + loc.shape[dim])
    if hi > lo:
        loc.narrow(dim, lo - off, hi - lo).copy_(src.narrow(dim, lo - start, hi - lo))
    return dst


def store_(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst.copy_(src)``; on a DTensor, into each rank's shard of ``dst``."""
    if not isinstance(dst, DTensor):
        return dst.copy_(src)
    src = to_mesh(src, dst.device_mesh).redistribute(dst.device_mesh, dst.placements)
    dst.to_local().copy_(src.to_local())
    return dst
