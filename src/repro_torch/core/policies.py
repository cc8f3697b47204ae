"""Acceptance policies for speculated reasoning steps.

The paper's mechanism is a *static threshold* over a single-token utility
score (0-9) decoded from the base model after a templated score prompt.
The framework also ships two beyond-paper policies the paper names as
future work: a logprob-margin policy (zero extra prompt tokens) and a
dynamic threshold that tracks a target acceptance rate."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Verdict:
    accept: bool
    utility: float            # 0-9 scale (whatever the policy derives)
    detail: str = ""


class AcceptancePolicy:
    def judge(self, utility: float) -> Verdict:  # pragma: no cover
        raise NotImplementedError

    def observe(self, verdict: Verdict) -> None:
        pass


@dataclasses.dataclass
class StaticThreshold(AcceptancePolicy):
    """Paper §4.1: accept iff utility score >= threshold (default 7/9)."""
    threshold: float = 7.0

    def judge(self, utility: float) -> Verdict:
        return Verdict(utility >= self.threshold, utility,
                       f"static tau={self.threshold}")


@dataclasses.dataclass
class DynamicThreshold(AcceptancePolicy):
    """Beyond-paper: adapt the threshold to hold a target acceptance rate.

    A simple integral controller: if we accept more often than the target,
    tighten; if less often, relax — bounded to [lo, hi]."""
    target_accept: float = 0.6
    threshold: float = 7.0
    lo: float = 3.0
    hi: float = 9.0
    gain: float = 0.3

    def judge(self, utility: float) -> Verdict:
        return Verdict(utility >= self.threshold, utility,
                       f"dynamic tau={self.threshold:.2f}")

    def observe(self, verdict: Verdict) -> None:
        err = (1.0 if verdict.accept else 0.0) - self.target_accept
        self.threshold = float(np.clip(self.threshold + self.gain * err,
                                       self.lo, self.hi))


@dataclasses.dataclass
class LogprobMargin(AcceptancePolicy):
    """Beyond-paper (paper's "future work"): utility = mean base-model
    token logprob of the speculated step, mapped onto the 0-9 scale.  Uses
    the logits of the same verification prefill — no score-prompt tokens at
    all, so verification is ~70 tokens cheaper per step."""
    min_logprob: float = -4.0          # maps to 0
    max_logprob: float = -0.05         # maps to 9
    threshold: float = 6.0

    def utility_from_logprob(self, mean_lp: float) -> float:
        span = self.max_logprob - self.min_logprob
        return float(np.clip((mean_lp - self.min_logprob) / span, 0, 1) * 9)

    def judge(self, utility: float) -> Verdict:
        return Verdict(utility >= self.threshold, utility,
                       f"logprob tau={self.threshold}")
