"""The SpecReason controller (paper §4.1), sequential.

Per reasoning step:
  1. the small model *speculates* the next step (decode until <step> /
     </think> / cap),
  2. the base model *verifies* it with a prefill-only utility-score pass,
  3. accept (keep the step in both contexts) or reject (restore both
     contexts and let the base model regenerate the step).

One request is a state machine over :class:`SpecReasonStepState` --
phases ``speculate -> verify -> (fallback) -> ... -> close -> answer ->
done`` -- advanced one phase at a time by :meth:`SpecReason.advance`, as
in the JAX package.  Random draws come from one ``torch.Generator`` per
request, in place of the JAX package's key splits, so sampled runs are
not token-identical to the JAX package's; greedy runs are.

With ``use_spec_decode`` (SpecReason+Decode, §4.2) every base-model
regeneration and the final answer run token-level speculative decoding
(``core.spec_decode``).  The continuous-batching scheduler
(``serving.scheduler``) drives the same state machine and reuses the
decision helpers here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..sampling.sample import SamplingParams
from ..serving.engine import Engine, Session
from ..tokenizer import toy as tk
from .policies import AcceptancePolicy, LogprobMargin, StaticThreshold, \
    Verdict
from .segmenter import SegmenterConfig, StepSegmenter
from .spec_decode import SpecDecodeStats, spec_decode
from .verifier import Verifier


@dataclasses.dataclass
class SpecReasonConfig:
    # acceptance
    policy: AcceptancePolicy = dataclasses.field(
        default_factory=StaticThreshold)
    # force the first n steps onto the base model (paper Fig 6)
    first_n_base: int = 0
    # thinking-token budget
    token_budget: int = 256
    max_steps: int = 24
    # hierarchical speculation: token-level spec decode inside base
    # regeneration and the final answer (SpecReason+Decode, §4.2)
    use_spec_decode: bool = False
    spec_gamma: int = 4
    # draft step k+1 while step k is verified (the paper's pipelining
    # future work); the sequential runtime measures the overlap-eligible
    # seconds in SpecReasonResult.overlapped_s
    overlapped: bool = False
    # decode loop of every generate call, and of the continuous
    # scheduler's batched rows: fused (one CUDA graph replay a chunk of
    # tokens), eager (the per-token loop), or None for each engine's
    # default (fused, for the dense and ssm families)
    fused_decode: Optional[bool] = None
    sampling: SamplingParams = dataclasses.field(
        default_factory=lambda: SamplingParams(temperature=0.6))
    answer_max_tokens: int = 8
    segmenter: SegmenterConfig = dataclasses.field(
        default_factory=SegmenterConfig)


@dataclasses.dataclass
class StepRecord:
    source: str                 # "small" | "base"
    utility: float
    accepted: bool
    tokens: List[int]


@dataclasses.dataclass
class SpecReasonResult:
    thinking_ids: List[int]
    answer_ids: List[int]
    steps: List[StepRecord]
    wall_time: float
    meters: Dict[str, Dict[str, float]]
    overlapped_s: float = 0.0
    spec_stats: SpecDecodeStats = dataclasses.field(
        default_factory=SpecDecodeStats)

    @property
    def critical_path_s(self) -> float:
        return max(self.wall_time - self.overlapped_s, 0.0)

    @property
    def n_thinking_tokens(self) -> int:
        return len(self.thinking_ids)

    @property
    def accept_rate(self) -> float:
        judged = [s for s in self.steps if s.source == "small"]
        if not judged:
            return 0.0
        return sum(s.accepted for s in judged) / len(judged)

    @property
    def small_step_frac(self) -> float:
        if not self.steps:
            return 0.0
        return (sum(1 for s in self.steps if s.source == "small"
                    and s.accepted) / len(self.steps))


@dataclasses.dataclass
class SpecReasonStepState:
    """One request's resumable control state.  The sequential path
    keeps the engine context in ``base_sess``/``small_sess``; the
    continuous scheduler leaves them None and keeps row handles."""
    generator: torch.Generator
    phase: str = "speculate"   # speculate|verify|fallback|close|answer|done
    base_sess: Optional[Session] = None
    small_sess: Optional[Session] = None
    thinking: List[int] = dataclasses.field(default_factory=list)
    steps: List[StepRecord] = dataclasses.field(default_factory=list)
    step_idx: int = 0
    done_thinking: bool = False
    answer_ids: List[int] = dataclasses.field(default_factory=list)
    overlapped_s: float = 0.0
    spec_stats: SpecDecodeStats = dataclasses.field(
        default_factory=SpecDecodeStats)
    started_at: float = dataclasses.field(default_factory=time.perf_counter)
    # transient, valid between speculate and verify:
    draft_ids: Optional[List[int]] = None
    pending: Optional[Tuple[List[int], Session]] = None
    b_snap: Optional[Session] = None
    s_snap: Optional[Session] = None


class SpecReason:
    """Drives one request across a (base, small) engine pair."""

    def __init__(self, base: Engine, small: Engine,
                 cfg: Optional[SpecReasonConfig] = None):
        self.base = base
        self.small = small
        self.cfg = cfg or SpecReasonConfig()
        self.segmenter = StepSegmenter(self.cfg.segmenter)
        self.verifier = Verifier(base)

    # ------------------------------------------------------------------ run
    def run(self, prompt_ids: Sequence[int],
            generator: torch.Generator) -> SpecReasonResult:
        self.base.meter.reset()
        self.small.meter.reset()
        st = self.begin(prompt_ids, generator)
        while st.phase != "done":
            self.advance(st)
        return self.result(st)

    # ---------------------------------------------------- state machine api
    def begin(self, prompt_ids: Sequence[int],
              generator: torch.Generator) -> SpecReasonStepState:
        st = SpecReasonStepState(generator=generator)
        st.base_sess = self.base.extend(self.base.new_session(),
                                        list(prompt_ids))
        st.small_sess = self.small.extend(self.small.new_session(),
                                          list(prompt_ids))
        st.phase = self.think_phase(st)
        return st

    def advance(self, st: SpecReasonStepState) -> SpecReasonStepState:
        """Execute the request's current phase and move it to the next."""
        step = {"speculate": self.step_speculate,
                "verify": self.step_verify,
                "fallback": self.step_fallback,
                "close": self.step_close,
                "answer": self.step_answer}[st.phase]
        step(st)
        return st

    def result(self, st: SpecReasonStepState,
               meters: Optional[Dict[str, Dict[str, float]]] = None
               ) -> SpecReasonResult:
        """Package a finished state.  ``meters`` overrides the sequential
        engines' meters (the continuous scheduler passes its batched
        engines' aggregate meters)."""
        assert st.phase == "done"
        return SpecReasonResult(
            thinking_ids=st.thinking, answer_ids=st.answer_ids,
            steps=st.steps, wall_time=time.perf_counter() - st.started_at,
            meters=meters if meters is not None else
            {"base": self.base.meter.as_dict(),
             "small": self.small.meter.as_dict()},
            overlapped_s=st.overlapped_s, spec_stats=st.spec_stats)

    # ----------------------------------------------------- decision helpers
    def think_phase(self, st: SpecReasonStepState) -> str:
        """Where does this request go after completing a step (or at the
        start)?"""
        cfg = self.cfg
        if st.done_thinking or st.step_idx >= cfg.max_steps \
                or len(st.thinking) >= cfg.token_budget:
            return "close"
        return "speculate" if st.step_idx >= cfg.first_n_base else "fallback"

    def max_step_tokens(self, st: SpecReasonStepState) -> int:
        return min(self.segmenter.cfg.max_step_tokens,
                   self.cfg.token_budget - len(st.thinking))

    def judge_draft(self, utility: float, mean_logprob: float
                    ) -> Tuple[Verdict, float]:
        """Policy judgment on a verified draft; returns (verdict, the
        utility actually judged -- remapped for logprob policies)."""
        cfg = self.cfg
        if isinstance(cfg.policy, LogprobMargin):
            utility = cfg.policy.utility_from_logprob(mean_logprob)
        verdict = cfg.policy.judge(utility)
        cfg.policy.observe(verdict)
        return verdict, utility

    def note_accept(self, st: SpecReasonStepState, body: List[int],
                    end: str, utility: float) -> int:
        """Record an accepted speculated step; returns the delimiter the
        caller appends to the base context."""
        delim = tk.THINK_END if end == "final" else tk.STEP
        st.thinking += body + [delim]
        st.steps.append(StepRecord("small", utility, True, body))
        st.step_idx += 1
        if end == "final":
            st.done_thinking = True
        st.draft_ids = st.b_snap = st.s_snap = None
        st.phase = self.think_phase(st)
        return delim

    def note_reject(self, st: SpecReasonStepState, body: List[int],
                    utility: float) -> None:
        """Record a rejected (or malformed) speculated step; the caller has
        already restored both contexts.  Falls through to base
        regeneration within the same reasoning step."""
        st.steps.append(StepRecord("small", utility, False, body))
        st.draft_ids = st.b_snap = st.s_snap = None
        st.pending = None
        st.phase = "fallback"

    def note_base_step(self, st: SpecReasonStepState, ids: List[int]
                       ) -> None:
        """Record a base-model-produced step (fallback or first-n)."""
        end = self.segmenter.classify_end(ids)
        st.thinking += ids
        st.pending = None   # base regeneration invalidates any pre-draft
        st.steps.append(StepRecord("base", 9.0, True,
                                   self.segmenter.body(ids)))
        st.step_idx += 1
        if end in ("final", "eos"):
            st.done_thinking = True
        st.phase = self.think_phase(st)

    # --------------------------------------------------- phase executors
    def step_speculate(self, st: SpecReasonStepState) -> None:
        cfg = self.cfg
        st.s_snap = st.small_sess.snapshot()
        st.b_snap = st.base_sess.snapshot()
        if st.pending is not None:
            # pre-drafted during the previous step's verification
            ids, small_after = st.pending
            st.pending = None
            st.small_sess = small_after
        else:
            ids, st.small_sess, _ = self.small.generate(
                st.small_sess, self.max_step_tokens(st),
                self.segmenter.stop_ids, cfg.sampling, st.generator,
                fused=cfg.fused_decode)
        st.draft_ids = ids
        end = self.segmenter.classify_end(ids)

        if cfg.overlapped and end == "step":
            # draft step k+1 now -- on two-stream hardware this runs
            # concurrently with the base model's verification
            t_ov = time.perf_counter()
            nids, nsess, _ = self.small.generate(
                st.small_sess, self.segmenter.cfg.max_step_tokens,
                self.segmenter.stop_ids, cfg.sampling, st.generator,
                fused=cfg.fused_decode)
            st.overlapped_s += time.perf_counter() - t_ov
            st.pending = (nids, nsess)
        st.phase = "verify"

    def step_verify(self, st: SpecReasonStepState) -> None:
        ids = st.draft_ids
        end = self.segmenter.classify_end(ids)
        body = self.segmenter.body(ids)

        # a draft that hit max_step_tokens ("runaway") is verified like a
        # clean <step> boundary
        if body and end in ("step", "final", "runaway"):
            vr = self.verifier.verify(st.base_sess, body)
            verdict, utility = self.judge_draft(vr.utility, vr.mean_logprob)
            if verdict.accept:
                delim = self.note_accept(st, body, end, utility)
                st.base_sess = self.base.extend(vr.session_after_step,
                                                [delim])
                return
            # rejected: restore both models to the step boundary (a
            # pre-drafted next step built on the rejected one drops too)
            st.small_sess = st.s_snap
            st.base_sess = st.b_snap
            self.note_reject(st, body, utility)
        else:
            # malformed speculation (empty body / eos mid-thought)
            st.small_sess = st.s_snap
            st.base_sess = st.b_snap
            self.note_reject(st, body, 0.0)

    def step_fallback(self, st: SpecReasonStepState) -> None:
        cfg = self.cfg
        max_step = self.max_step_tokens(st)
        if cfg.use_spec_decode:
            ids, st.base_sess, st.small_sess = spec_decode(
                self.base, self.small, st.base_sess, st.small_sess,
                max_step, self.segmenter.stop_ids, cfg.sampling,
                st.generator, gamma=cfg.spec_gamma, stats=st.spec_stats,
                fused=cfg.fused_decode)
        else:
            ids, st.base_sess, _ = self.base.generate(
                st.base_sess, max_step, self.segmenter.stop_ids,
                cfg.sampling, st.generator, fused=cfg.fused_decode)
            # keep the small model's context in sync
            st.small_sess = self.small.extend(st.small_sess, ids)
        self.note_base_step(st, ids)

    def step_close(self, st: SpecReasonStepState) -> None:
        if not st.done_thinking:
            # budget exhausted: close the thinking phase so the answer is
            # still produced
            close = [tk.THINK_END]
            st.base_sess = self.base.extend(st.base_sess, close)
            st.small_sess = self.small.extend(st.small_sess, close)
            st.thinking += close
        st.phase = "answer"

    def step_answer(self, st: SpecReasonStepState) -> None:
        # the final answer always comes from the base model
        cfg = self.cfg
        if cfg.use_spec_decode:
            st.answer_ids, st.base_sess, st.small_sess = spec_decode(
                self.base, self.small, st.base_sess, st.small_sess,
                cfg.answer_max_tokens, [tk.EOS], cfg.sampling, st.generator,
                gamma=cfg.spec_gamma, stats=st.spec_stats,
                fused=cfg.fused_decode)
        else:
            st.answer_ids, st.base_sess, _ = self.base.generate(
                st.base_sess, cfg.answer_max_tokens, [tk.EOS], cfg.sampling,
                st.generator, fused=cfg.fused_decode)
        st.phase = "done"
