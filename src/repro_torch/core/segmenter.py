"""Reasoning-step boundary detection over token streams.

The paper defines a reasoning step as a "semantically self-contained unit
such as a complete sentence or logical step".  In the synthetic testbed the
LRM emits an explicit ``<step>`` delimiter (mirroring the `\\n\\n` /
sentence boundaries real LRMs produce); the segmenter also recognizes the
end-of-thinking token and hard caps step length so a rambling speculator
cannot stall verification."""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from ..tokenizer import toy as tk


@dataclasses.dataclass(frozen=True)
class SegmenterConfig:
    step_delims: Tuple[int, ...] = (tk.STEP,)
    think_end: int = tk.THINK_END
    eos: int = tk.EOS
    max_step_tokens: int = 24


class StepSegmenter:
    def __init__(self, cfg: SegmenterConfig = SegmenterConfig()):
        self.cfg = cfg

    @property
    def stop_ids(self) -> List[int]:
        return list(self.cfg.step_delims) + [self.cfg.think_end, self.cfg.eos]

    def split_stream(self, ids: Sequence[int]) -> List[List[int]]:
        """Split a decoded thinking stream into steps (delimiters dropped)."""
        steps, cur = [], []
        for t in ids:
            if t in self.cfg.step_delims or t == self.cfg.think_end:
                if cur:
                    steps.append(cur)
                cur = []
                if t == self.cfg.think_end:
                    break
            else:
                cur.append(t)
        if cur:
            steps.append(cur)
        return steps

    def classify_end(self, ids: Sequence[int]) -> str:
        """How did a speculated step terminate?
        'step'   — clean <step> boundary
        'final'  — </think> (reasoning finished)
        'eos'    — eos mid-thought
        'runaway'— hit max_step_tokens without a boundary"""
        if not ids:
            return "runaway"
        last = ids[-1]
        if last in self.cfg.step_delims:
            return "step"
        if last == self.cfg.think_end:
            return "final"
        if last == self.cfg.eos:
            return "eos"
        return "runaway"

    def body(self, ids: Sequence[int]) -> List[int]:
        """Step tokens without the trailing delimiter."""
        if ids and (ids[-1] in self.cfg.step_delims
                    or ids[-1] in (self.cfg.think_end, self.cfg.eos)):
            return list(ids[:-1])
        return list(ids)
