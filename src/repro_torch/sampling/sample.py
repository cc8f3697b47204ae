"""Token sampling: greedy / temperature / top-k / top-p.

A sampled token is argmax(adjusted logits + Gumbel noise), the draw
``jax.random.categorical`` makes.  The noise comes from a
``torch.Generator`` (one per request, seeded from the CLI's ``--seed``),
so sampled tokens differ from the JAX package's, which draws from
``jax.random`` keys; greedy tokens do not depend on the noise.  Tests
hold the sampling rule itself to the JAX package's by handing both the
same noise (``categorical``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0     # 0 => greedy
    top_k: int = 0               # 0 => disabled
    top_p: float = 1.0           # 1 => disabled


def adjust_logits(logits: torch.Tensor,
                  params: SamplingParams) -> torch.Tensor:
    """Apply temperature / top-k / top-p filtering; returns adjusted
    logits."""
    if params.temperature <= 0.0:
        return logits
    logits = logits / params.temperature
    if params.top_k:
        kth = torch.sort(logits, dim=-1).values[..., -params.top_k][..., None]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if params.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # smallest set with cumulative prob >= top_p
        cutoff_idx = torch.sum(cum < params.top_p, dim=-1, keepdim=True)
        cutoff_idx = cutoff_idx.clamp(max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return logits


def probs_from_logits(logits: torch.Tensor,
                      params: SamplingParams) -> torch.Tensor:
    """Post-adjustment probabilities; greedy is the one-hot of the
    argmax."""
    if params.temperature <= 0.0:
        return torch.nn.functional.one_hot(
            torch.argmax(logits, dim=-1), logits.shape[-1]).float()
    return torch.softmax(adjust_logits(logits, params).float(), dim=-1)


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, -log(E) with E ~ Exp(1), from ``generator``
    (which must live on ``device``)."""
    e = torch.empty(shape, dtype=torch.float32, device=device)
    return -torch.log(e.exponential_(generator=generator))


def categorical(adjusted: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The Gumbel-max draw: argmax(adjusted logits + noise)."""
    return torch.argmax(adjusted + noise, dim=-1)


def sample(logits: torch.Tensor, params: SamplingParams,
           generator: torch.Generator) -> torch.Tensor:
    """logits (..., V) -> token ids (...).  Greedy draws no noise."""
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    return categorical(adjust_logits(logits, params),
                       gumbel(logits.shape, generator, logits.device))


def sample_rows(logits: torch.Tensor, params: SamplingParams,
                generators: Sequence[torch.Generator]) -> torch.Tensor:
    """Batched ``sample``: logits (R, V) -> token ids (R,), row r drawing
    its Gumbel noise from ``generators[r]`` (its own request's), exactly
    the draw ``sample`` makes for that row alone, so a batched row takes
    the tokens the sequential path takes from the same generator."""
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    v = logits.shape[-1]
    noise = torch.stack([gumbel((v,), g, logits.device) for g in generators])
    return categorical(adjust_logits(logits, params), noise)
