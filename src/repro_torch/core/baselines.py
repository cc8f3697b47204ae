"""Baseline the paper compares against (§5.1): vanilla inference with one
model (the base model for accuracy, the small model for latency).

Returns the controller's result shape so the serving CLI treats every
scheme alike.  The token-level speculative-decoding baseline waits for
``spec_decode`` to be ported.
"""

from __future__ import annotations

import time
from typing import Sequence

import torch

from ..sampling.sample import SamplingParams
from ..serving.engine import Engine
from ..tokenizer import toy as tk
from .controller import SpecReasonResult, StepRecord


def vanilla_reason(engine: Engine, prompt_ids: Sequence[int],
                   generator: torch.Generator, token_budget: int = 256,
                   sampling: SamplingParams = SamplingParams(temperature=0.6),
                   answer_max_tokens: int = 8) -> SpecReasonResult:
    """Plain autoregressive reasoning with one model: think until
    ``</think>`` / ``<eos>`` or the budget, close the thinking phase if
    needed, then answer."""
    engine.meter.reset()
    t0 = time.perf_counter()
    sess = engine.extend(engine.new_session(), list(prompt_ids))
    thinking, sess, _ = engine.generate(sess, token_budget,
                                        [tk.THINK_END, tk.EOS], sampling,
                                        generator)
    if not thinking or thinking[-1] != tk.THINK_END:
        sess = engine.extend(sess, [tk.THINK_END])
        thinking = thinking + [tk.THINK_END]
    answer, sess, _ = engine.generate(sess, answer_max_tokens, [tk.EOS],
                                      sampling, generator)
    return SpecReasonResult(
        thinking_ids=thinking, answer_ids=answer,
        steps=[StepRecord(engine.name, 9.0, True, thinking)],
        wall_time=time.perf_counter() - t0,
        meters={engine.name: engine.meter.as_dict()})
