"""Load the testbed engine pair from npz checkpoints.

The port cannot train: a missing checkpoint is an error.  Checkpoints
come from the JAX package's trainer or, for driving the machinery with
random weights, from ``save_random_testbed``.
"""

from __future__ import annotations

import os
from typing import Tuple

from .. import device as devices
from ..checkpoint.checkpoint import load_checkpoint, save_checkpoint
from ..configs import testbed
from ..models.model import Model
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
