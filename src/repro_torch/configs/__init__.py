"""Architecture config registry — ``--arch <id>`` resolution.

The port's own copies of the records of the JAX package's registry
(``repro.configs``) for the families it runs: dense and hybrid. Other
families join with their slice.
"""
from __future__ import annotations

from typing import Dict, List

from . import hymba_1_5b, minicpm_2b, qwen2_1_5b, qwen3_32b, smollm_135m
from .base import ArchConfig

_MODULES = (smollm_135m, minicpm_2b, qwen2_1_5b, qwen3_32b, hymba_1_5b)

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
