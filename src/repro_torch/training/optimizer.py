"""AdamW with a cosine schedule, warmup and global-norm clipping, over the
port's params dict: the port of the JAX package's
``training/optimizer.py``.

State is ``(step, m, v)``: the host step count and two params-shaped
dicts of float32 tensors.  ``update`` follows the JAX arithmetic in the
same order (clip by the global norm, float32 bias corrections from the
incremented step, decoupled weight decay on every tensor) and returns the
``grad_norm`` and ``lr`` metrics.  Where JAX returns new arrays, the port
writes the new moments and parameters into the tensors it was given, so a
step allocates no second copy of them.  The schedule and the bias
corrections are float32 scalars computed on the host from the step count,
as JAX computes them in float32; the norm and the clip scale stay on the
parameters' device, so a step reads nothing back.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Tuple

import torch

from ..models.model import flatten, unflatten

Params = Dict[str, object]


class AdamWState(NamedTuple):
    step: int
    m: Params
    v: Params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def schedule(cfg: AdamWConfig, step: int) -> float:
    """The learning rate at ``step``: linear warmup, then a cosine decay
    to ``min_lr_frac``; float32 arithmetic, as the JAX schedule."""
    s = _f32(step)
    warm = torch.minimum(s / max(cfg.warmup_steps, 1), _f32(1.0))
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi) * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return float(cfg.lr * warm * frac)


def init(params: Params) -> AdamWState:
    """Zero moments in float32 on the parameters' device."""
    def zeros():
        return unflatten({k: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device)
                          for k, p in flatten(params).items()})
    return AdamWState(0, zeros(), zeros())


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum over tensors of each tensor's sum of squares, in
    float32 (a 0-d tensor on the tensors' device)."""
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(x.float()))
         for x in flatten(tree).values()])))


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Params, state: AdamWState,
           params: Params) -> Tuple[Params, AdamWState, dict]:
    """One AdamW step: clips ``grads`` by their global norm and writes the
    new moments into ``state``'s tensors and the new parameters into
    ``params``'s.  Returns (params, the state at step + 1, metrics
    ``grad_norm`` (0-d tensor) and ``lr`` (float))."""
    keys = list(flatten(params))
    p, g, m, v = ([flatten(tree)[k] for k in keys]
                  for tree in (params, grads, state.m, state.v))
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    g = torch._foreach_mul([x.float() for x in g], scale)

    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = float(1 - _f32(cfg.b1) ** _f32(step))
    b2c = float(1 - _f32(cfg.b2) ** _f32(step))

    # m = b1 * m + (1 - b1) * g;  v = b2 * v + (1 - b2) * g * g
    torch._foreach_mul_(m, cfg.b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
    torch._foreach_mul_(v, cfg.b2)
    gg = torch._foreach_mul(g, 1 - cfg.b2)
    torch._foreach_mul_(gg, g)
    torch._foreach_add_(v, gg)

    # p = p - lr * (m / b1c / (sqrt(v / b2c) + eps) + wd * p)
    denom = torch._foreach_div(v, b2c)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    upd = torch._foreach_div(m, b1c)
    torch._foreach_div_(upd, denom)
    torch._foreach_add_(upd, torch._foreach_mul([x.float() for x in p],
                                                cfg.weight_decay))
    torch._foreach_mul_(upd, lr)
    torch._foreach_sub_(p, upd)
    return params, AdamWState(step, state.m, state.v), \
        {"grad_norm": gnorm, "lr": lr}
