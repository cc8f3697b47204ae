"""Load (or lazily train) the testbed engine pair from npz checkpoints,
or build a random-init engine for a registry architecture.

A missing checkpoint is trained, as the JAX package's loader does: the
port's trainer (``launch/train.py``) runs ``auto_train_steps`` steps on
the loader's device and writes the npz that the loader then reads.
Checkpoints from the JAX package's trainer load as they are;
``save_random_testbed`` writes a random-init pair for driving the
machinery without training.  ``random_engine`` draws a registry
architecture's weights from a seed, for driving the machinery at an
architecture's published widths.  Engines take ``Engine``'s decode-loop
default: the fused loop, for every family (dense, windowed or not, moe,
ssm, hybrid, encdec and vlm).  ``attach_cross_source`` gives a
cross-attention engine (encdec, vlm) the stub source its front end
would make, as the JAX package's ``examples/multiarch_smoke.py`` does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch

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


def ensure_testbed(ckpt_dir: str, device, auto_train_steps: int = 500
                   ) -> None:
    """Train each missing model of the pair for ``auto_train_steps``
    steps on ``device`` and write it to ``ckpt_dir``."""
    dev = devices.resolve(device)
    for which, cfg in PAIR:
        path = checkpoint_path(ckpt_dir, cfg)
        if not os.path.exists(path):
            from ..launch.train import train_testbed_model
            print(f"[loader] {path} missing: training {which} "
                  f"({auto_train_steps} steps on {dev})", flush=True)
            train_testbed_model(which, auto_train_steps, ckpt_dir,
                                device=dev)


def load_testbed_engines(ckpt_dir: str = "exp/ckpt", device="cuda",
                         max_len: int = 1024, auto_train_steps: int = 500
                         ) -> Tuple[Engine, Engine]:
    """The (base, small) engines from ``ckpt_dir``; a missing model is
    first trained for ``auto_train_steps`` steps on ``device`` and
    written there."""
    dev = devices.resolve(device)
    ensure_testbed(ckpt_dir, dev, auto_train_steps)
    engines = []
    for which, cfg in PAIR:
        path = checkpoint_path(ckpt_dir, cfg)
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


def cross_src_len(cfg: ModelConfig) -> int:
    """The source tokens a cross-attention ``cfg`` attends over (encoder
    frames, image patches); 0 for the other families."""
    if cfg.family == "encdec":
        return cfg.encoder_seq_len
    if cfg.family == "vlm":
        return cfg.n_image_tokens
    return 0


# the stub front end's seed, the JAX package's examples/multiarch_smoke.py's
STUB_SEED = 7


def stub_source(cfg: ModelConfig) -> Optional[torch.Tensor]:
    """The stub front end's output for a cross-attention ``cfg``: N(0, 1)
    x 0.1 of shape (1, ``cross_src_len(cfg)``, d_model), drawn on the
    CPU from STUB_SEED (the same on every device); None for the other
    families."""
    n = cross_src_len(cfg)
    if not n:
        return None
    gen = torch.Generator().manual_seed(STUB_SEED)
    return torch.randn((1, n, cfg.d_model), generator=gen) * 0.1


def attach_cross_source(engine: Engine,
                        src: Optional[torch.Tensor] = None) -> Engine:
    """Make every session of a cross-attention ``engine`` attend to
    ``src`` (default ``stub_source(cfg)``): its ``new_session`` passes
    the source on, so the controller and the schemes drive it
    unchanged.  Other families' engines are returned as they are."""
    if src is None:
        src = stub_source(engine.model.cfg)
    if src is None:
        return engine
    src = src.to(engine.device)
    orig = engine.new_session

    def new_session(batch: int = 1, capacity: Optional[int] = None):
        return orig(batch, capacity, cross_src=src)
    engine.new_session = new_session
    return engine
