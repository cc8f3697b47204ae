"""Architecture registry of the port: arch id -> ModelConfig.

Holds the architectures whose family the port runs: the toy testbed pair,
minitron-4b, phi3-mini-3.8b and starcoder2-7b (dense), mamba2-1.3b (ssm),
hymba-1.5b (hybrid), granite-moe-1b-a400m (moe), whisper-base (encdec:
a 6-layer encoder over 1500 stub frame embeddings, every decoder layer
cross-attending to it) and llama-3.2-vision-11b (vlm: every 5th of its
40 layers a gated cross-attention layer over 1601 stub patch
embeddings).  The JAX package's registry (``repro.configs.registry``)
has two more; asking for one of them raises ``KeyError`` naming it as
not ported, with its family and why: yi-34b (dense) needs bf16 weights
(~137 GB in fp32), which the port does not serve, and
qwen3-moe-235b-a22b (moe) has 235 B parameters, ~940 GB in fp32 and
~470 GB in bf16, beyond one 80 GB card either way (the port has no
expert or tensor parallelism for moe).  ``reduced(arch)`` gives the
smoke-test variant of the same family (<=2 layers, d_model<=128, <=4
experts top-2; an encdec model 2 encoder layers over 64 frames, a vlm
model a cross layer every 2nd over 16 patches)."""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..models.config import ModelConfig
from . import (granite_moe_1b, hymba_1_5b, llama_3_2_vision_11b,
               mamba2_1_3b, minitron_4b, phi3_mini_3_8b, starcoder2_7b,
               testbed, whisper_base)

ARCHS: Dict[str, ModelConfig] = {
    "mamba2-1.3b": mamba2_1_3b.CONFIG,
    "minitron-4b": minitron_4b.CONFIG,
    "phi3-mini-3.8b": phi3_mini_3_8b.CONFIG,
    "hymba-1.5b": hymba_1_5b.CONFIG,
    "starcoder2-7b": starcoder2_7b.CONFIG,
    "granite-moe-1b-a400m": granite_moe_1b.CONFIG,
    "whisper-base": whisper_base.CONFIG,
    "llama-3.2-vision-11b": llama_3_2_vision_11b.CONFIG,
    "testbed-base": testbed.BASE,
    "testbed-small": testbed.SMALL,
}

# the JAX package's other architectures, with their families and why the
# port does not serve them
NOT_PORTED: Dict[str, Tuple[str, str]] = {
    "qwen3-moe-235b-a22b": (
        "moe", "235 B parameters are ~940 GB in fp32 and ~470 GB in bf16, "
        "beyond one 80 GB card; the port has no expert or tensor "
        "parallelism for moe (ROADMAP queue 1 item 8)"),
    "yi-34b": ("dense", "it needs bf16 weights"),
}

ASSIGNED: List[str] = [k for k in ARCHS if not k.startswith("testbed")]


def get(arch: str) -> ModelConfig:
    if arch in NOT_PORTED:
        family, why = NOT_PORTED[arch]
        raise KeyError(f"arch {arch!r} ({family} family) is not ported "
                       f"({why}); the port has {sorted(ARCHS)}")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; the port has "
                       f"{sorted(ARCHS)}, not ported: {sorted(NOT_PORTED)}")
    return ARCHS[arch]


def reduced(arch: str) -> ModelConfig:
    return get(arch).reduced()
