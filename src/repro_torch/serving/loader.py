"""Load the testbed engine pair from npz checkpoints, or build a
random-init engine for a registry architecture.

The port cannot train: a missing checkpoint is an error.  Checkpoints
come from the JAX package's trainer or, for driving the machinery with
random weights, from ``save_random_testbed``.  ``random_engine`` draws a
registry architecture's weights from a seed, for driving the machinery
at an architecture's published widths.  Engines take ``Engine``'s
decode-loop default: the fused loop for a dense model, the per-token
loop for an ssm model.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

from .. import device as devices
from ..checkpoint.checkpoint import load_checkpoint, save_checkpoint
from ..configs import registry, testbed
from ..models.config import ModelConfig
from ..models.model import Model
from ..tokenizer import toy as tk
from .engine import Engine

PAIR = (("base", testbed.BASE), ("small", testbed.SMALL))


def checkpoint_path(ckpt_dir: str, cfg) -> str:
    return os.path.join(ckpt_dir, f"{cfg.name}.npz")


def load_testbed_engines(ckpt_dir: str = "exp/ckpt", device="cuda",
                         max_len: int = 1024) -> Tuple[Engine, Engine]:
    dev = devices.resolve(device)
    engines = []
    for which, cfg in PAIR:
        path = checkpoint_path(ckpt_dir, cfg)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} is missing and the PyTorch port cannot train: "
                "write the pair with the JAX package's trainer "
                "(python -m repro.launch.train) or random weights with "
                "repro_torch.serving.loader.save_random_testbed")
        model = Model(cfg)
        shapes = {k: s.shape for k, s in model.spec().items()}
        params = load_checkpoint(path, dev, expect=shapes)
        engines.append(Engine(model, params, max_len=max_len,
                              name=f"testbed-{which}"))
    return engines[0], engines[1]


def save_random_testbed(ckpt_dir: str, seed: int = 0) -> None:
    """Write a random-init BASE/SMALL pair (seeds ``seed`` and
    ``seed + 1``), drawn by the port's own init on the CPU."""
    for i, (_, cfg) in enumerate(PAIR):
        params = Model(cfg).init(seed + i, device="cpu")
        save_checkpoint(checkpoint_path(ckpt_dir, cfg), params,
                        meta={"init": "random", "seed": seed + i})


def arch_config(arch: str, reduced: bool = False) -> ModelConfig:
    """The registry's config for ``arch`` (its ``reduced()`` smoke variant
    when asked) with one cut: ``vocab_size`` is the toy tokenizer's 64,
    so that the controller's token ids mean the same to every model."""
    cfg = registry.reduced(arch) if reduced else registry.get(arch)
    return dataclasses.replace(cfg, vocab_size=tk.VOCAB_SIZE, name=arch)


def random_engine(arch: str, device="cuda", seed: int = 0) -> Engine:
    """An Engine over ``arch_config(arch)`` with weights drawn by the
    port's init from ``seed`` (on the CPU, so the same on every device)
    and moved to ``device``."""
    model = Model(arch_config(arch))
    params = model.init(seed, device=devices.resolve(device))
    return Engine(model, params, name=arch)


def decode_loops(*engines: Engine) -> str:
    """Which loop each engine's ``generate`` runs by default, for a log
    line: "name fused, name eager"."""
    return ", ".join(f"{e.name} {'fused' if e.fused else 'eager'}"
                     for e in engines)
