"""Checkpointing in the JAX package's format, with async save and restore.

Counterpart of ``repro/train/checkpoint.py``, same format, so a checkpoint
saved by either package restores into the other: ``step_XXXXXXXX/`` holds
one ``.npy`` per leaf, ``index.json`` (the tree's leaves with their logical
dtypes and shapes, the training step, the data-pipeline cursor and a meta
dict) and a ``DONE`` marker written last; the directory is renamed into
place atomically. Leaves are keyed by the JAX path string: dict keys and
list indices joined by "/" (``params/segments/0/wq``); bf16 leaves are
stored as their ``uint16`` bits with logical dtype "bfloat16". Restore
puts each leaf on the device and in the structure of a target state.

Fault-tolerance runbook (with ``launch/train.py``):
  * save every N steps (async thread), keep last K
  * on restart: newest complete checkpoint wins (the DONE marker)
  * data cursor restored -> bit-identical batch stream resumes
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..bridge import tensor_from_numpy, tensor_to_numpy
from .optim import tree_map

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "CheckpointManager"]


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """path -> leaf, dict keys sorted (the order of jax.tree_util)."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), t) for i, t in enumerate(tree)]
    else:
        return {prefix: tree}
    flat = {}
    for key, sub in items:
        flat.update(_flatten(sub, f"{prefix}/{key}" if prefix else key))
    return flat


def save_checkpoint(directory: str, step: int, state, *, data_cursor: int = 0,
                    meta: Optional[Dict] = None) -> str:
    ckpt = os.path.join(directory, f"step_{step:08d}")
    tmp = ckpt + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    index = {"step": step, "data_cursor": data_cursor, "meta": meta or {}, "leaves": {}}
    for key, leaf in _flatten(state).items():
        arr = tensor_to_numpy(leaf)                 # bf16 -> its uint16 bits
        logical_dtype = "bfloat16" if leaf.dtype == torch.bfloat16 else str(arr.dtype)
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        index["leaves"][key] = {"file": fname, "dtype": logical_dtype,
                                "shape": list(arr.shape)}
    with open(os.path.join(tmp, "index.json"), "w") as f:
        json.dump(index, f)
    with open(os.path.join(tmp, "DONE"), "w") as f:
        f.write("ok")
    if os.path.exists(ckpt):
        shutil.rmtree(ckpt)
    os.rename(tmp, ckpt)
    return ckpt


def _complete_steps(directory: str):
    return sorted(int(n.split("_")[1]) for n in os.listdir(directory)
                  if n.startswith("step_") and not n.endswith(".tmp")
                  and os.path.exists(os.path.join(directory, n, "DONE")))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _complete_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: int, target_state) -> Tuple[Any, int, Dict]:
    """Restore into the structure, devices and dtypes of ``target_state``;
    a leaf whose shape differs from the target's raises."""
    ckpt = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(ckpt, "index.json")) as f:
        index = json.load(f)
    flat_target = _flatten(target_state)
    loaded = {}
    for key, rec in index["leaves"].items():
        arr = np.load(os.path.join(ckpt, rec["file"]))
        tgt = flat_target.get(key)
        if tgt is not None and tuple(arr.shape) != tuple(tgt.shape):
            raise ValueError(f"checkpoint leaf {key} shape {arr.shape} != target "
                             f"{tuple(tgt.shape)} — incompatible architecture")
        loaded[key] = tensor_from_numpy(arr, tgt.device if tgt is not None else None)
    missing = sorted(set(flat_target) - set(loaded))
    if missing:
        raise KeyError(f"checkpoint {ckpt} lacks leaves {missing[:5]}")
    leaves = iter([loaded[key] for key in flat_target])     # tree_map's order
    return tree_map(lambda _: next(leaves), target_state), index["data_cursor"], \
        index.get("meta", {})


class CheckpointManager:
    """Async save-every-N with keep-last-K retention."""

    def __init__(self, directory: str, *, save_every: int = 100, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.save_every = save_every
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def maybe_save(self, step: int, state, *, data_cursor: int = 0,
                   meta: Optional[Dict] = None) -> bool:
        if step % self.save_every:
            return False
        self.wait()
        # copy to the host on the calling thread: the train step updates the
        # parameters and moments in place
        host_state = tree_map(lambda x: x.detach().to("cpu", copy=True), state)

        def work():
            save_checkpoint(self.directory, step, host_state, data_cursor=data_cursor,
                            meta=meta)
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
        return True

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = _complete_steps(self.directory)
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
