"""Batching/padding pipeline for the synthetic testbed (a copy of the
JAX package's ``data/pipeline.py``: the same batches for the same spec,
seed, kind and mixes).

Produces fixed-shape (tokens, targets, weights) batches: ``targets`` are
the next-token labels, ``weights`` the per-position loss mask (teacher
forcing only on CoT/answer/score positions — prompt tokens get no loss).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Iterator, List, Tuple

import numpy as np

from ..tokenizer import toy as tk
from .tasks import Example, cot_example, score_example


@dataclasses.dataclass
class BatchSpec:
    batch_size: int = 16
    seq_len: int = 128


def pack(example: Example, seq_len: int) -> Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray]:
    toks = example.tokens[:seq_len + 1]
    mask = example.loss_mask[:seq_len + 1]
    # inputs = toks[:-1], targets = toks[1:], weights = mask[1:]
    inp = np.full(seq_len, tk.PAD, np.int32)
    tgt = np.full(seq_len, tk.PAD, np.int32)
    wgt = np.zeros(seq_len, np.float32)
    n = len(toks) - 1
    if n <= 0:
        return inp, tgt, wgt
    inp[:n] = toks[:-1]
    tgt[:n] = toks[1:]
    wgt[:n] = mask[1:]
    return inp, tgt, wgt


def example_stream(seed: int, kind: str = "mixed",
                   style_mix: Tuple[float, float] = (0.9, 0.05),
                   score_frac: float = 0.35,
                   min_steps: int = 2, max_steps: int = 5
                   ) -> Iterator[Example]:
    """kind: "cot" (small model), "mixed" (base model: CoT + score
    supervision)."""
    rng = random.Random(seed)
    while True:
        if kind == "mixed" and rng.random() < score_frac:
            yield score_example(rng, min_steps, max_steps)
        else:
            yield cot_example(rng, style_mix, min_steps, max_steps)


def batch_iterator(spec: BatchSpec, seed: int, kind: str = "mixed",
                   style_mix: Tuple[float, float] = (0.9, 0.05),
                   score_frac: float = 0.35,
                   min_steps: int = 2, max_steps: int = 5
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    stream = example_stream(seed, kind, style_mix, score_frac,
                            min_steps, max_steps)
    while True:
        inps, tgts, wgts = [], [], []
        for _ in range(spec.batch_size):
            i, t, w = pack(next(stream), spec.seq_len)
            inps.append(i)
            tgts.append(t)
            wgts.append(w)
        yield (np.stack(inps), np.stack(tgts), np.stack(wgts))
