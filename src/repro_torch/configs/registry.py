"""Architecture registry of the port: arch id -> ModelConfig.

Holds the architectures whose family the port runs: the toy testbed pair,
minitron-4b, phi3-mini-3.8b and starcoder2-7b (dense), mamba2-1.3b (ssm)
and hymba-1.5b (hybrid).  The JAX package's registry
(``repro.configs.registry``) has five more; asking for one of them
raises ``KeyError`` naming it as not ported, with its family: the moe,
encdec and vlm families are not ported, and yi-34b (dense) needs bf16
weights (~137 GB in fp32), which the port does not serve.
``reduced(arch)`` gives the smoke-test variant of the same family (<=2
layers, d_model<=128)."""

from __future__ import annotations

from typing import Dict, List

from ..models.config import ModelConfig
from . import (hymba_1_5b, mamba2_1_3b, minitron_4b, phi3_mini_3_8b,
               starcoder2_7b, testbed)

ARCHS: Dict[str, ModelConfig] = {
    "mamba2-1.3b": mamba2_1_3b.CONFIG,
    "minitron-4b": minitron_4b.CONFIG,
    "phi3-mini-3.8b": phi3_mini_3_8b.CONFIG,
    "hymba-1.5b": hymba_1_5b.CONFIG,
    "starcoder2-7b": starcoder2_7b.CONFIG,
    "testbed-base": testbed.BASE,
    "testbed-small": testbed.SMALL,
}

# the JAX package's other architectures, with their families
NOT_PORTED: Dict[str, str] = {
    "llama-3.2-vision-11b": "vlm",
    "granite-moe-1b-a400m": "moe",
    "whisper-base": "encdec",
    "qwen3-moe-235b-a22b": "moe",
    "yi-34b": "dense",
}

ASSIGNED: List[str] = [k for k in ARCHS if not k.startswith("testbed")]


def get(arch: str) -> ModelConfig:
    if arch in NOT_PORTED:
        why = "it needs bf16 weights" if arch == "yi-34b" else \
            "its family is not ported"
        raise KeyError(f"arch {arch!r} ({NOT_PORTED[arch]} family) is not "
                       f"ported ({why}); the port has {sorted(ARCHS)}")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; the port has "
                       f"{sorted(ARCHS)}, not ported: {sorted(NOT_PORTED)}")
    return ARCHS[arch]


def reduced(arch: str) -> ModelConfig:
    return get(arch).reduced()
