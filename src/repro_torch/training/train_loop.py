"""Training driver for the toy testbed models (base and small LRMs): the
port of the JAX package's ``training/train_loop.py``, on the card by
default (``device="cpu"`` on the CPU).

A real training loop (step, metrics, periodic log lines, checkpoint) that
produces the pair every SpecReason measurement serves.  Parameters start
from the port's ``Model.init(seed)``, which draws other numbers than the
JAX package's ``jax.random`` init, so a pair trained here is not the pair
the JAX trainer makes from the same seed; given the same starting
parameters and batches the two trainers agree step for step (held on the
CPU by the tests).  The checkpoint is the JAX package's format (flat npz
keys, ``.meta.json``), so either package loads it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from .. import device as devices
from ..checkpoint.checkpoint import save_checkpoint
from ..data.pipeline import BatchSpec, batch_iterator
from ..models.config import ModelConfig
from ..models.model import Model, flatten, unflatten
from .loss import make_train_step
from .optimizer import AdamWConfig, init as opt_init


@dataclasses.dataclass
class TrainConfig:
    steps: int = 600
    batch_size: int = 16
    seq_len: int = 128
    seed: int = 0
    kind: str = "mixed"                 # "mixed" (base) | "cot" (small)
    style_mix: Tuple[float, float] = (0.9, 0.05)
    score_frac: float = 0.35
    min_steps: int = 2
    max_steps: int = 5
    log_every: int = 50
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def train(cfg: ModelConfig, tcfg: TrainConfig,
          ckpt_path: Optional[str] = None,
          log: Callable[[str], None] = print, device="cuda") -> Dict:
    """Train ``cfg`` for ``tcfg.steps`` steps on ``device`` from
    ``Model.init(tcfg.seed)``.  Returns {"params": the trained parameters
    (detached, no grad), "history": the logged metrics, "model": the
    Model}."""
    dev = devices.resolve(device)
    model = Model(cfg)
    params = model.init(tcfg.seed, device=dev)
    for t in flatten(params).values():
        t.requires_grad_()
    opt_state = opt_init(params)
    opt = dataclasses.replace(tcfg.opt, total_steps=tcfg.steps)
    step_fn = make_train_step(model, opt)

    spec = BatchSpec(tcfg.batch_size, tcfg.seq_len)
    it = batch_iterator(spec, tcfg.seed, tcfg.kind, tcfg.style_mix,
                        tcfg.score_frac, tcfg.min_steps, tcfg.max_steps)

    n_params = sum(t.numel() for t in flatten(params).values())
    log(f"[train] {cfg.name}: {n_params/1e6:.2f}M params, "
        f"{tcfg.steps} steps x {tcfg.batch_size}x{tcfg.seq_len}")

    history = []
    t0 = time.perf_counter()
    for step in range(tcfg.steps):
        inp, tgt, wgt = next(it)
        batch = {"tokens": torch.from_numpy(inp).to(dev),
                 "targets": torch.from_numpy(tgt).to(dev),
                 "weights": torch.from_numpy(wgt).to(dev)}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % tcfg.log_every == 0 or step == tcfg.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            log(f"[train] {cfg.name} step {step:5d} "
                f"loss={m['loss']:.4f} ce={m['ce_loss']:.4f} "
                f"gnorm={m['grad_norm']:.2f} ({dt:.1f}s)")
            history.append({"step": step, **m})

    params = unflatten({k: t.detach() for k, t in flatten(params).items()})
    if ckpt_path:
        save_checkpoint(ckpt_path, params,
                        meta={"config": dataclasses.asdict(cfg),
                              "steps": tcfg.steps})
        log(f"[train] saved {ckpt_path}")
    return {"params": params, "history": history, "model": model}
