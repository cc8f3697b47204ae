"""Baselines the paper compares against (§5.1): vanilla inference with one
model (the base model for accuracy, the small model for latency), and
token-level speculative decoding over the whole generation.

Return the controller's result shape so the serving CLI treats every
scheme alike.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import torch

from ..sampling.sample import SamplingParams
from ..serving.engine import Engine
from ..tokenizer import toy as tk
from .controller import SpecReasonResult, StepRecord
from .spec_decode import SpecDecodeStats, spec_decode


def vanilla_reason(engine: Engine, prompt_ids: Sequence[int],
                   generator: torch.Generator, token_budget: int = 256,
                   sampling: SamplingParams = SamplingParams(temperature=0.6),
                   answer_max_tokens: int = 8,
                   fused: Optional[bool] = None) -> SpecReasonResult:
    """Plain autoregressive reasoning with one model: think until
    ``</think>`` / ``<eos>`` or the budget, close the thinking phase if
    needed, then answer.  ``fused`` picks the decode loop (None: the
    engine's default)."""
    engine.meter.reset()
    t0 = time.perf_counter()
    sess = engine.extend(engine.new_session(), list(prompt_ids))
    thinking, sess, _ = engine.generate(sess, token_budget,
                                        [tk.THINK_END, tk.EOS], sampling,
                                        generator, fused=fused)
    if not thinking or thinking[-1] != tk.THINK_END:
        sess = engine.extend(sess, [tk.THINK_END])
        thinking = thinking + [tk.THINK_END]
    answer, sess, _ = engine.generate(sess, answer_max_tokens, [tk.EOS],
                                      sampling, generator, fused=fused)
    return SpecReasonResult(
        thinking_ids=thinking, answer_ids=answer,
        steps=[StepRecord(engine.name, 9.0, True, thinking)],
        wall_time=time.perf_counter() - t0,
        meters={engine.name: engine.meter.as_dict()})


def spec_decode_reason(base: Engine, small: Engine,
                       prompt_ids: Sequence[int], generator: torch.Generator,
                       token_budget: int = 256,
                       sampling: SamplingParams = SamplingParams(
                           temperature=0.6),
                       gamma: int = 4,
                       answer_max_tokens: int = 8,
                       fused: Optional[bool] = None) -> SpecReasonResult:
    """Token-level speculative decoding over the whole generation: the
    paper's "SpecDecode" baseline (exact with respect to the base
    model).  ``fused`` picks the draft's decode loop."""
    base.meter.reset()
    small.meter.reset()
    t0 = time.perf_counter()
    stats = SpecDecodeStats()
    b = base.extend(base.new_session(), list(prompt_ids))
    s = small.extend(small.new_session(), list(prompt_ids))
    thinking, b, s = spec_decode(base, small, b, s, token_budget,
                                 [tk.THINK_END, tk.EOS], sampling, generator,
                                 gamma=gamma, stats=stats, fused=fused)
    if not thinking or thinking[-1] != tk.THINK_END:
        b = base.extend(b, [tk.THINK_END])
        s = small.extend(s, [tk.THINK_END])
        thinking = thinking + [tk.THINK_END]
    answer, b, s = spec_decode(base, small, b, s, answer_max_tokens,
                               [tk.EOS], sampling, generator, gamma=gamma,
                               stats=stats, fused=fused)
    return SpecReasonResult(
        thinking_ids=thinking, answer_ids=answer,
        steps=[StepRecord("base", 9.0, True, thinking)],
        wall_time=time.perf_counter() - t0,
        meters={"base": base.meter.as_dict(),
                "small": small.meter.as_dict()}, spec_stats=stats)
