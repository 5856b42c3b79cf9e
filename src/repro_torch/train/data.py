"""Deterministic synthetic data pipeline with a checkpointable cursor.

Counterpart of ``repro/train/data.py``. ``batch_at(step)`` is a pure
function of (seed, step), drawn with the reference's numpy generator, so
its tokens equal the JAX package's bit for bit and a restart resumes from
the checkpointed step with the same batches. Tensors are made on the
device the pipeline was given (the card unless told otherwise); there is
no sharding.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..device import resolve_device

__all__ = ["SyntheticData"]


class SyntheticData:
    def __init__(self, cfg: ArchConfig, shape: ShapeSpec, seed: int = 0,
                 batch_override: Optional[int] = None,
                 seq_override: Optional[int] = None, device=None):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.B = batch_override or shape.global_batch
        self.S = seq_override or shape.seq_len
        self.device = resolve_device(device)

    def _t(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def batch_at(self, step: int) -> Dict[str, Any]:
        cfg = self.cfg
        rng = np.random.default_rng((self.seed << 20) ^ step)
        B, S = self.B, self.S
        batch: Dict[str, Any] = {}
        if cfg.family == "audio":
            batch["frames"] = self._t(rng.standard_normal((B, S, cfg.d_model), np.float32))
        else:
            toks = rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
            batch["tokens"] = self._t(toks[:, :S])
        if cfg.family == "vlm":
            batch["images"] = self._t(
                rng.standard_normal((B, cfg.n_image_tokens, cfg.d_model),
                                    np.float32).astype(np.float32))
        if self.shape.kind == "train":
            if cfg.family == "audio":
                batch["labels"] = self._t(
                    rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32))
            else:
                batch["labels"] = self._t(toks[:, 1:])
        return batch
