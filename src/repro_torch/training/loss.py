"""Weighted next-token cross-entropy and the train step: the port of the
JAX package's ``training/loss.py``.

Gradients come from torch autograd over ``Model.forward``.  On the card
the forward's attention is kernel #2 and its gradient the hand-written
backward kernel (``kernels/flash_attention_bwd.py``, through
``ops.flash_attention``); on the CPU both are the plain versions.  A moe
model adds the JAX package's router aux loss (``models.moe.aux_loss``)
and its metrics; its experts' gradient is autograd of their torch
products.  The vlm and encdec families are not ported (ROADMAP queue 1
item 7): ``Model`` refuses them and so does ``loss_fn``; the hybrid
family does not train yet (queue 2 J).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..models import moe
from ..models.model import Model, flatten, unflatten
from .optimizer import AdamWConfig, AdamWState, update

Params = Dict[str, object]
Batch = Dict[str, torch.Tensor]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """logits (B,S,V), targets (B,S) int, weights (B,S) float: the
    weighted mean of -log p(target), logsumexp in float32, the mean over
    max(sum(weights), 1)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, targets[..., None].long(),
                                dim=-1)[..., 0]
    nll = logz - gold
    denom = torch.clamp(torch.sum(weights), min=1.0)
    return torch.sum(nll * weights) / denom


def loss_fn(model: Model, params: Params, batch: Batch
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics ``ce_loss`` and ``loss``) of ``batch`` (``tokens``,
    ``targets``, ``weights``); a moe model's loss adds ``aux_loss``, and
    its metrics ``aux_load_balance``, ``aux_router_z``,
    ``aux_dropped_frac`` and ``aux_loss``."""
    family = model.cfg.family
    if family == "hybrid":
        raise NotImplementedError(
            "training the 'hybrid' family is not ported yet: on the card "
            "the SSD scan (#5) has no backward (ROADMAP queue 2 J) and the "
            "attention backward (2b) takes no sliding window")
    if family not in ("dense", "moe", "ssm"):
        raise NotImplementedError(
            f"training the {family!r} family is not ported yet "
            "(ROADMAP queue 1 item 7: vlm, encdec)")
    logits, aux = model.forward_aux(params, batch["tokens"])
    loss = cross_entropy(logits, batch["targets"], batch["weights"])
    metrics = {"ce_loss": loss.detach()}
    if aux:
        al = moe.aux_loss(aux, model.cfg)
        metrics.update({f"aux_{k}": v.detach() for k, v in aux.items()})
        metrics["aux_loss"] = al.detach()
        loss = loss + al
    metrics["loss"] = loss.detach()
    return loss, metrics


def _grads_of(model: Model, params: Params, batch: Batch):
    """(metrics, grads as a flat '/'-keyed dict) of one batch."""
    flat = flatten(params)
    loss, metrics = loss_fn(model, params, batch)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return metrics, dict(zip(flat, grads))


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    n_microbatches: int = 1
                    ) -> Callable[[Params, AdamWState, Batch],
                                  Tuple[Params, AdamWState,
                                        Dict[str, torch.Tensor]]]:
    """A step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``params`` are leaf tensors that require grad; the step
    writes the update into them (``optimizer.update``).  With
    ``n_microbatches`` > 1 the batch is split on dim 0 and the grads and
    metrics are the means over the microbatches (gradient accumulation,
    in float32)."""

    def train_step(params, opt_state, batch):
        if n_microbatches == 1:
            metrics, grads = _grads_of(model, params, batch)
        else:
            b = batch["tokens"].shape[0]
            assert b % n_microbatches == 0, (b, n_microbatches)
            micro = {k: x.reshape((n_microbatches, b // n_microbatches)
                                  + x.shape[1:]) for k, x in batch.items()}
            grads = {k: torch.zeros(t.shape, dtype=torch.float32,
                                    device=t.device)
                     for k, t in flatten(params).items()}
            metrics = None
            for i in range(n_microbatches):
                m, g = _grads_of(model, params,
                                 {k: x[i] for k, x in micro.items()})
                for k, acc in grads.items():
                    acc.add_(g[k].float() / n_microbatches)
                m = {k: v / n_microbatches for k, v in m.items()}
                metrics = m if metrics is None else {
                    k: metrics[k] + m[k] for k in metrics}
        params, opt_state, opt_metrics = update(opt_cfg, unflatten(grads),
                                                opt_state, params)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step
