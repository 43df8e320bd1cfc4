"""Architecture registry: ``--arch <id>`` resolution for the port's
launchers. Lists the JAX package's whole catalog, every family trained
and served by the port: the dense archs, grok-1-314b and
llama4-scout-17b-a16e (moe), paligemma-3b (vlm), whisper-large-v3
(encdec), mamba2-2.7b (ssm) and zamba2-1.2b (hybrid)."""

from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig

# arch id -> module name (one module per supported architecture)
_MODULES: Dict[str, str] = {
    "minitron-8b": "minitron_8b",
    "smollm-135m": "smollm_135m",
    "minitron-4b": "minitron_4b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "whisper-large-v3": "whisper_large_v3",
    "mamba2-2.7b": "mamba2_2_7b",
    "zamba2-1.2b": "zamba2_1_2b",
    "grok-1-314b": "grok_1_314b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "paligemma-3b": "paligemma_3b",
}

ARCHS: List[str] = list(_MODULES)


def _load(name: str):
    if name not in _MODULES:
        raise ValueError(f"unknown arch {name!r}; available: {ARCHS}")
    return importlib.import_module(f".{_MODULES[name]}", __package__)


def get_config(name: str) -> ModelConfig:
    return _load(name).CONFIG


def smoke_config(name: str) -> ModelConfig:
    return _load(name).SMOKE
