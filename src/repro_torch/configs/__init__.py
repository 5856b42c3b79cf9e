"""Architecture config registry — ``--arch <id>`` resolution.

The port's own copies of every record of the JAX package's registry
(``repro.configs``). The campaign simulator reads all of them (a
``moe_ep_grid`` campaign needs qwen3-moe-30b-a3b); the torch model runs
the dense and hybrid families, and ``build_model`` refuses the others.
"""
from __future__ import annotations

from typing import Dict, List

from . import (hubert_xlarge, hymba_1_5b, llama32_vision_90b, minicpm_2b,
               phi35_moe_42b_a6_6b, qwen2_1_5b, qwen3_32b, qwen3_moe_30b_a3b,
               smollm_135m, xlstm_125m)
from .base import ArchConfig

_MODULES = (smollm_135m, minicpm_2b, qwen2_1_5b, qwen3_32b, hubert_xlarge,
            qwen3_moe_30b_a3b, phi35_moe_42b_a6_6b, xlstm_125m,
            llama32_vision_90b, hymba_1_5b)

REGISTRY: Dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def list_archs() -> List[str]:
    return list(REGISTRY)


def get_config(name: str) -> ArchConfig:
    """Resolve ``--arch`` ids; accepts dashed or underscored spellings."""
    key = name.strip()
    if key in REGISTRY:
        return REGISTRY[key]
    alt = key.replace("_", "-")
    if alt in REGISTRY:
        return REGISTRY[alt]
    raise KeyError(f"unknown arch {name!r}; known: {', '.join(REGISTRY)}")


__all__ = ["ArchConfig", "REGISTRY", "list_archs", "get_config"]
