"""Parameter bridge between numpy trees and the port's tensors.

``params_from_numpy(model, tree)`` turns a parameter tree given as numpy
arrays — the JAX package's pytree after ``np.asarray`` on every leaf, with
bf16 leaves as a ``uint16`` view (the convention of
``repro/train/checkpoint.py``, since numpy has no bfloat16) — into the
port's parameters, path for path along ``model.template()``. It imports no
JAX: the caller does the conversion to numpy. ``params_to_numpy`` goes the
other way, for any tree of dicts and lists of tensors (the JAX package's
pytree of the same paths, once each leaf is read with ``jnp.asarray`` and
bf16 ``uint16`` views are taken back as bf16; a DTensor leaf is read
whole). ``place(tree, specs, mesh)`` lays a concrete tree of tensors (a
state, a batch, parameters from ``params_from_numpy``) out on a
``DeviceMesh`` by a tree of partition specs of the same paths
(``distribute_tensor``), so JAX parameters carry across into a sharded
state.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from .distributed.sharding import placements
from .models.layers import PT

__all__ = ["tensor_from_numpy", "tensor_to_numpy", "params_from_numpy",
           "params_to_numpy", "place"]


def tensor_from_numpy(arr: np.ndarray, device=None) -> torch.Tensor:
    """numpy -> tensor; a ``uint16`` array is read as the bits of bf16."""
    arr = np.ascontiguousarray(arr).reshape(np.shape(arr))    # keeps a 0-d shape
    if arr.dtype == np.uint16:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device) if device is not None else t


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy; bf16 comes out as its ``uint16`` bits."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _walk(tmpl, tree, path: str, device):
    if isinstance(tmpl, PT):
        arr = np.asarray(tree)
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"{path}: shape {arr.shape} != template {tmpl.shape}")
        return tensor_from_numpy(arr, device)
    if isinstance(tmpl, dict):
        if set(tmpl) != set(tree):
            raise KeyError(f"{path or '/'}: keys {sorted(tree)} != template "
                           f"{sorted(tmpl)}")
        return {k: _walk(tmpl[k], tree[k], f"{path}/{k}", device) for k in tmpl}
    if isinstance(tmpl, (list, tuple)):
        if len(tmpl) != len(tree):
            raise ValueError(f"{path}: {len(tree)} entries != template {len(tmpl)}")
        return [_walk(t, x, f"{path}/{i}", device)
                for i, (t, x) in enumerate(zip(tmpl, tree))]
    raise TypeError(f"{path}: unexpected template node {type(tmpl).__name__}")


def params_from_numpy(model, tree: Any, device=None):
    """The port's parameter tree from a numpy tree with the same paths."""
    return _walk(model.template(), tree, "", device)


def params_to_numpy(tree: Any):
    """A numpy tree with the paths of a tree of tensors (bf16 as ``uint16``)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return tensor_to_numpy(tree)


def place(tree: Any, specs: Any, mesh, *, src_data_rank: Optional[int] = 0):
    """``tree`` (dicts and lists of tensors; ints pass through) as DTensors
    on ``mesh``, each leaf laid out by the spec at its path. With the
    default ``src_data_rank`` rank 0's values are scattered to every rank;
    ``None`` takes each rank's own copy (every rank holds the same values)."""
    if isinstance(tree, dict):
        return {k: place(v, specs[k], mesh, src_data_rank=src_data_rank)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v, s, mesh, src_data_rank=src_data_rank)
                          for v, s in zip(tree, specs))
    if not isinstance(tree, torch.Tensor):
        return tree
    return distribute_tensor(tree, mesh, placements(specs, mesh), src_data_rank=src_data_rank)
