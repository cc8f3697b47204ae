"""Architecture registry of the port: arch id -> ModelConfig.

Holds the architectures whose family the port runs: the toy testbed pair,
minitron-4b (dense) and mamba2-1.3b (ssm).  The JAX package's registry
(``repro.configs.registry``) has eight more; asking for one of them
raises ``KeyError`` naming it as not ported.  ``reduced(arch)`` gives the
smoke-test variant of the same family (<=2 layers, d_model<=128)."""

from __future__ import annotations

from typing import Dict, List

from ..models.config import ModelConfig
from . import mamba2_1_3b, minitron_4b, testbed

ARCHS: Dict[str, ModelConfig] = {
    "mamba2-1.3b": mamba2_1_3b.CONFIG,
    "minitron-4b": minitron_4b.CONFIG,
    "testbed-base": testbed.BASE,
    "testbed-small": testbed.SMALL,
}

# the JAX package's other architectures, with their families
NOT_PORTED: Dict[str, str] = {
    "llama-3.2-vision-11b": "vlm",
    "phi3-mini-3.8b": "dense",
    "granite-moe-1b-a400m": "moe",
    "whisper-base": "encdec",
    "hymba-1.5b": "hybrid",
    "starcoder2-7b": "dense",
    "qwen3-moe-235b-a22b": "moe",
    "yi-34b": "dense",
}

ASSIGNED: List[str] = [k for k in ARCHS if not k.startswith("testbed")]


def get(arch: str) -> ModelConfig:
    if arch in NOT_PORTED:
        raise KeyError(f"arch {arch!r} ({NOT_PORTED[arch]} family) is not "
                       f"ported; the port has {sorted(ARCHS)}")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; the port has "
                       f"{sorted(ARCHS)}, not ported: {sorted(NOT_PORTED)}")
    return ARCHS[arch]


def reduced(arch: str) -> ModelConfig:
    return get(arch).reduced()
