"""Base-model verification of speculated reasoning steps.

The speculated step body is appended to the base model's context with
one prefill pass, then the score prompt (the single ``<score>`` token) in
a second; the next-token distribution over the digit tokens 0-9 is the
utility score.  The body pass's logits also give the step's mean
logprob, for the LogprobMargin policy.

State discipline: ``verify`` hands back the base session positioned
after the step body.  The score token was written into that session's
cache at the slot just past the body, and is masked by position: the
controller's next extend (the delimiter, on acceptance) overwrites it.
On rejection the controller restores the pre-step snapshot.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..serving.engine import Engine, Session
from ..tokenizer import toy as tk


def mean_body_logprob(prev_logits: torch.Tensor, body_logits: torch.Tensor,
                      body: List[int]) -> float:
    """Mean base-model logprob of ``body`` given the prior context.

    ``prev_logits``: the (V,) or (1, V) logits at the context's last token
    (they predict the first body token); ``body_logits``: the (n, V)
    logits at every body position."""
    if not body:
        return 0.0
    prev = prev_logits if prev_logits.dim() == 2 else prev_logits[None]
    all_logits = torch.cat([prev, body_logits[:-1]], dim=0)
    logp = torch.log_softmax(all_logits.float(), dim=-1)
    idx = torch.tensor(body, dtype=torch.long, device=logp.device)
    return float(logp.gather(1, idx[:, None])[:, 0].mean())


@dataclasses.dataclass
class VerifyResult:
    utility: float              # digit-expectation utility score, 0-9
    argmax_score: int           # argmax digit (the paper's readout)
    mean_logprob: float         # base logprob of the step body
    session_after_step: Session # base session incl. step, excl. score prompt


class Verifier:
    def __init__(self, engine: Engine, score_token: int = tk.SCORE,
                 digit_ids: Optional[List[int]] = None,
                 readout: str = "expect"):
        """readout: 'argmax' (the paper's single-token readout) or 'expect'
        (expectation over the digit distribution)."""
        self.engine = engine
        self.score_token = score_token
        self.digit_ids = digit_ids or tk.DIGIT_IDS
        self.readout = readout

    def utility_from_score_logits(self, score_logits: torch.Tensor
                                  ) -> Tuple[float, int]:
        """(V,) next-token logits after the score prompt -> (utility,
        argmax digit)."""
        digit_logits = score_logits[torch.tensor(self.digit_ids,
                                                 device=score_logits.device)]
        probs = torch.softmax(digit_logits.float(), dim=-1).cpu().numpy()
        argmax_score = int(np.argmax(probs))
        expect = float(np.dot(probs, np.arange(10)))
        utility = expect if self.readout == "expect" else float(argmax_score)
        return utility, argmax_score

    def verify(self, base: Session, step_body: List[int]) -> VerifyResult:
        """Score ``step_body`` as the next reasoning step after ``base``.

        The score token follows the body directly, as in training; the
        caller appends the step delimiter only on acceptance."""
        body = list(step_body)
        logits_body, after_body = self.engine.extend_logits(base, body)
        mean_lp = mean_body_logprob(base.last_logits, logits_body, body) \
            if base.last_logits is not None else 0.0
        score_logits, _ = self.engine.extend_logits(after_body,
                                                    [self.score_token])
        utility, argmax_score = self.utility_from_score_logits(
            score_logits[-1])
        return VerifyResult(utility, argmax_score, mean_lp, after_body)
