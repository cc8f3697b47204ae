"""Continuous batching of SpecReason requests over a paged KV store.

The port of the JAX package's ``ContinuousScheduler``
(``serving/scheduler.py``).  Every request is a resumable
``SpecReasonStepState``; each ``tick`` admits what fits, runs one
bounded chunked-prefill batch, then groups the running requests by
phase and runs each group as one batched engine call:

    speculate-batch : every drafting request  -> one small-model
                      ``generate_rows``
    verify-batch    : every verifying request -> one base-model scoring
                      extend ([body..., <score>] per row; the score token
                      is then dropped from every context)
    delim/close     : owed step delimiters + </think> closers -> one
                      merged base extend
    fallback/answer : rejected-step regenerations and final answers ->
                      one base ``generate_rows`` with per-row stop sets
                      (+ one small-model sync extend), or with ``spec``
                      on, batched token-level speculative decoding
                      (``serving.spec_engine``)

Admission is by block count over pools sized from the ``KVManager``'s
static partition; when a pool runs dry the youngest other request is
preempted (blocks freed, request requeued for recompute).  A rejected
step rolls back with an O(1) row restore plus a block-table restore.

Where the JAX package's batched rows are dense slabs and its pools only
account, here the pools' block tables are the physical layout of both
engines' KV (``PagedKVStore``).  So:

  * the pages a call writes must be in the row's table before it runs:
    each phase reserves its call's worst case through ``_grow`` (the
    step budget, the answer budget, the verify chunk + 1, the prefill
    chunk) and truncates the table to the real length afterwards.  The
    JAX package grows after each call by the real length, so under pool
    pressure the two can preempt at different moments; outputs stay
    token-identical;
  * every copy-on-write copy a table emits runs on the store
    (``BatchEngine.append_seq`` / ``truncate_seq``): a step snapshot
    shares the row's partial tail block, and the draft written after it
    lands in a copy, so a rejection reads back the pre-snapshot K/V.

Not ported yet, each raising ``NotImplementedError``: the radix prefix
cache (``prefix_cache=False`` is required; ROADMAP queue 1, item 4),
deadlines, shedding and the degradation ladder, fault injection and
audits, tracing, metrics, monitors and the admin plane, the compile and
memory watches (item 6), tensor parallelism (item 8), and overlapped
mode.
"""

from __future__ import annotations

import dataclasses
import time
import uuid
from collections import deque
from typing import Callable, Deque, List, Optional, Tuple

import torch

from ..core.controller import (SpecReason, SpecReasonResult,
                               SpecReasonStepState)
from ..core.verifier import mean_body_logprob
from ..data.tasks import Task, question_tokens
from ..tokenizer import toy as tk
from .batch_engine import BatchEngine, RowSnapshot
from .kv_manager import KVManager
from .paged_kv import (BlockTableSnapshot, PagedKVPool, PagedSeq,
                       PoolExhausted)
from .resilience import (STATUS_OK, TERMINAL_STATUSES, OverloadController,
                         ResilienceConfig, TickConfig)
from .spec_engine import BatchSpecEngine, SpecLedger, SpecRow
from .telemetry import SchedEvent

# Per-tick prompt-prefill token budget (chunked prefill), as in the JAX
# package.
DEFAULT_MAX_PREFILL_TOKENS = 64


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1, "
                               f"item {item})")


@dataclasses.dataclass
class Request:
    """One submitted task's serving handle: identity, its generator,
    timing milestones (submission, admission, prefill completion, first
    output token, finish) and the outcome."""
    task: Task
    request_id: str = dataclasses.field(
        default_factory=lambda: uuid.uuid4().hex[:8])
    submitted_at: float = dataclasses.field(default_factory=time.perf_counter)
    generator: Optional[torch.Generator] = None
    # the generator's state at first admission: a preempted request
    # restarts from it, so its recompute draws what the first run drew
    generator_state: Optional[torch.Tensor] = None
    result: Optional[SpecReasonResult] = None
    finished_at: Optional[float] = None
    status: str = "queued"      # queued -> running -> ok
    priority: int = 0
    arrival_idx: int = -1
    blocked_reason: Optional[str] = None
    admitted_at: Optional[float] = None
    prefill_done_at: Optional[float] = None
    first_token_at: Optional[float] = None

    @property
    def e2e_latency(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    @property
    def ttft(self) -> Optional[float]:
        """Time to first output token (seconds since submission)."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def prefill_stall_s(self) -> Optional[float]:
        """Seconds between (last) admission and prompt-prefill
        completion."""
        if self.prefill_done_at is None or self.admitted_at is None:
            return None
        return self.prefill_done_at - self.admitted_at

    def tpot(self, n_output_tokens: int) -> Optional[float]:
        """Decode seconds per generated token after the first (None until
        finished)."""
        if self.first_token_at is None or self.finished_at is None:
            return None
        return (self.finished_at - self.first_token_at) \
            / max(n_output_tokens - 1, 1)

    @property
    def terminal(self) -> bool:
        return self.status in TERMINAL_STATUSES


@dataclasses.dataclass
class _Active:
    """One admitted request's serving-side handles."""
    req: Request
    state: SpecReasonStepState
    base_row: int
    small_row: int
    base_seq: PagedSeq
    small_seq: PagedSeq
    alive: bool = True
    # chunked prefill: the full prompt and how many of its tokens are in
    # the engine rows so far; the request sits in the serving-side
    # ``prefill`` phase while ``cursor < len(prompt)``
    prompt: List[int] = dataclasses.field(default_factory=list)
    cursor: int = 0
    # step-boundary rollback points (speculate -> verify window)
    b_snap: Optional[RowSnapshot] = None
    s_snap: Optional[RowSnapshot] = None
    b_seq_snap: Optional[BlockTableSnapshot] = None
    s_seq_snap: Optional[BlockTableSnapshot] = None
    # transient verify-phase scratch
    end: str = ""
    body: List[int] = dataclasses.field(default_factory=list)
    mean_lp: float = 0.0
    # base-context tokens owed before this row's next base op (accepted
    # step delimiters, </think> closers), flushed once per tick
    pending_base: List[int] = dataclasses.field(default_factory=list)


class _SchedulerLedger(SpecLedger):
    """Bridges the spec engine's in-flight table growth and rollback to
    the scheduler's pools: every call's pages are reserved before it runs
    (may preempt the youngest request, observed through ``alive``), and
    every rollback truncates the table, running the copy a shared kept
    tail emits."""

    def __init__(self, sched: "ContinuousScheduler", acts: List[_Active]):
        self.sched = sched
        self.acts = acts

    def alive(self, i: int) -> bool:
        return self.acts[i].alive

    def reserve(self, i: int, which: str, end: int) -> None:
        self.sched._reserve(self.acts[i], _engine(which), end)

    def truncate(self, i: int, which: str, length: int) -> None:
        self.sched._truncate(self.acts[i], _engine(which), length)


def _engine(which: str) -> str:
    return "base" if which == "base" else "small"


class ContinuousScheduler:
    """Step-interleaved continuous batching over a SpecReason pair on
    paged KV.  Per ``tick``: one bounded chunked-prefill batch, then
    every running request's current phase as per-phase batched calls.
    Outputs are token-identical per request to the sequential
    controller (greedy, and sampled with the same generators), and
    chunked prefill to unchunked.

    ``on_event`` receives admission / chunk-progress / preemption events
    as :class:`telemetry.SchedEvent` (the serve CLI's ``--verbose``)."""

    def __init__(self, controller: SpecReason, kv: KVManager,
                 max_batch: int = 8, context_capacity: int = 256,
                 engine_capacity: Optional[int] = None,
                 spec_decode: Optional[bool] = None,
                 gamma: Optional[int] = None,
                 prefix_cache: bool = True,
                 chunked_prefill: bool = True,
                 max_prefill_tokens: int = DEFAULT_MAX_PREFILL_TOKENS,
                 on_event: Optional[Callable[[str], None]] = None,
                 resilience: Optional[ResilienceConfig] = None,
                 seed: int = 0):
        cfg = controller.cfg
        if cfg.overlapped:
            raise NotImplementedError(
                "continuous batching covers the speculate/verify/fallback "
                "pipeline with optional hierarchical spec decode; use the "
                "sequential controller for overlapped mode")
        if prefix_cache:
            raise _not_ported("the radix prefix cache over paged rows "
                              "(pass prefix_cache=False, --no-prefix-cache)",
                              4)
        self.controller = controller
        self.kv = kv
        self.spec = cfg.use_spec_decode if spec_decode is None \
            else spec_decode
        self.gamma = gamma if gamma is not None else cfg.spec_gamma
        # engine capacity defaults to the sequential engines' max_len
        engine_capacity = engine_capacity or controller.base.max_len
        if context_capacity > engine_capacity:
            raise ValueError("context_capacity exceeds engine capacity")
        self.context_capacity = context_capacity
        self.pools = {
            "base": PagedKVPool(max(kv.capacity_blocks("base"), 1),
                                kv.block_size),
            "small": PagedKVPool(max(kv.capacity_blocks("small"), 1),
                                 kv.block_size),
        }
        # the batched decode loop follows the controller's
        # ``fused_decode`` (None: the engines' default, fused)
        self.base_be = BatchEngine(controller.base.model,
                                   controller.base.params, max_batch,
                                   engine_capacity,
                                   name=f"cb-{controller.base.name}",
                                   pool=self.pools["base"],
                                   fused=cfg.fused_decode)
        self.small_be = BatchEngine(controller.small.model,
                                    controller.small.params, max_batch,
                                    engine_capacity,
                                    name=f"cb-{controller.small.name}",
                                    pool=self.pools["small"],
                                    fused=cfg.fused_decode)
        self.engines = {"base": self.base_be, "small": self.small_be}
        self.spec_be = BatchSpecEngine(self.base_be, self.small_be,
                                       self.gamma) if self.spec else None
        if max_prefill_tokens < 1:
            raise ValueError("max_prefill_tokens must be >= 1")
        self.chunked = chunked_prefill
        self.max_prefill_tokens = max_prefill_tokens
        self.on_event = on_event
        self.seed = seed
        self.queue: Deque[Request] = deque()
        self.active: List[_Active] = []
        self.done: List[Request] = []
        self.preemptions = 0
        self.ticks = 0
        self.prefill_chunks = 0      # chunked-prefill batches dispatched
        self.res = OverloadController(
            resilience if resilience is not None else ResilienceConfig(),
            TickConfig(gamma=self.gamma, spec_decode=self.spec,
                       max_prefill_tokens=max_prefill_tokens,
                       cache_insert=False))
        self._submitted = 0

    # ------------------------------------------------------------- intake
    def submit(self, task: Task, generator: Optional[torch.Generator] = None,
               deadline_s: Optional[float] = None,
               priority: int = 0) -> Request:
        """Queue a task; ``generator`` pins the request's random draws
        (same generator seed, same tokens, sequential or continuous).  Without one,
        admission seeds a generator on the engines' device from the
        scheduler's ``seed`` and the arrival index."""
        if deadline_s is not None:
            raise _not_ported("request deadlines", 6)
        req = Request(task, generator=generator, priority=priority,
                      arrival_idx=self._submitted)
        self._submitted += 1
        self.queue.append(req)
        return req

    def _headroom_blocks(self) -> int:
        seg = self.controller.segmenter.cfg
        return self.kv.headroom_blocks(seg.max_step_tokens,
                                       self.gamma if self.spec else 0)

    def _worst_case_tokens(self, prompt_len: int) -> int:
        """Upper bound on one request's context length (the JAX
        package's rule)."""
        cfg = self.controller.cfg
        seg = self.controller.segmenter.cfg
        spec_slack = (self.gamma + 1) if self.spec else 0
        return (prompt_len + cfg.token_budget + 2 * seg.max_step_tokens
                + cfg.answer_max_tokens + 2 + 32 + spec_slack)

    def _emit(self, kind: str, msg: str, **fields) -> None:
        if self.on_event is not None:
            self.on_event(SchedEvent(kind, msg, fields))

    def _admit(self, tc: TickConfig) -> None:
        admitted: List[_Active] = []
        # highest priority first, FIFO within a priority class; a blocked
        # candidate stops the loop so nothing jumps it
        order = [r for _, r in sorted(
            enumerate(self.queue), key=lambda t: (-t[1].priority, t[0]))]
        for req in order:
            if not (self.base_be.free_rows and self.small_be.free_rows):
                break
            prompt = question_tokens(req.task)
            worst = self._worst_case_tokens(len(prompt))
            if worst > self.base_be.capacity:
                raise RuntimeError(
                    f"request {req.request_id} can never be served: "
                    f"worst-case context {worst} tokens exceeds the "
                    f"engine capacity {self.base_be.capacity}; raise "
                    f"engine_capacity or lower the token budget")
            first = len(prompt)
            if self.chunked:
                first = min(first, tc.max_prefill_tokens)
            need = self.kv.chunk_blocks(0, first) + self._headroom_blocks()
            min_blocks = max(
                self.pools["base"].blocks_for_tokens(len(prompt))
                + self._headroom_blocks(),
                self.pools["base"].blocks_for_tokens(
                    min(self.context_capacity, worst)))
            too_big = [w for w in ("base", "small")
                       if min_blocks > self.pools[w].num_blocks]
            if too_big:
                raise RuntimeError(
                    f"request {req.request_id} can never be admitted: "
                    f"needs {min_blocks} blocks, pool(s) {too_big} hold "
                    f"{[self.pools[w].num_blocks for w in too_big]}; "
                    f"provision a larger KV budget or lower "
                    f"context_capacity")
            short = [w for w in ("base", "small")
                     if self.pools[w].num_free < need]
            if short:
                req.blocked_reason = "; ".join(
                    f"blocked: need {need} {w} blocks, have "
                    f"{self.pools[w].num_free}" for w in short)
                break
            if req.generator is None:
                req.generator = torch.Generator(
                    device=self.base_be.device).manual_seed(
                        1000003 * self.seed + req.arrival_idx)
            if req.generator_state is None:
                req.generator_state = req.generator.get_state()
            else:
                req.generator.set_state(req.generator_state)
            st = SpecReasonStepState(generator=req.generator)
            st.started_at = time.perf_counter()
            base_seq = PagedSeq(self.pools["base"])
            small_seq = PagedSeq(self.pools["small"])
            a = _Active(req=req, state=st,
                        base_row=self.base_be.alloc_row(base_seq),
                        small_row=self.small_be.alloc_row(small_seq),
                        base_seq=base_seq, small_seq=small_seq)
            self.queue.remove(req)
            req.blocked_reason = None
            req.status = "running"
            req.admitted_at = time.perf_counter()
            req.prefill_done_at = None
            a.prompt = list(prompt)
            # reserve the first chunk's blocks now (the `need` check above
            # guaranteed them); later chunks grow at their prefill ticks
            self.base_be.append_seq(base_seq, first)
            self.small_be.append_seq(small_seq, first)
            admitted.append(a)
            self._emit("admit",
                       f"admit {req.request_id}: prompt={len(prompt)} "
                       f"cached=0 first_chunk={first}"
                       + ("" if first >= len(prompt) else
                          f" (chunked, {len(prompt)} suffix tokens over >= "
                          f"{-(-len(prompt) // max(first, 1))} ticks)"),
                       request=req.request_id, prompt=len(prompt),
                       cached=0, first_chunk=first)
        for a in admitted:
            a.state.phase = "prefill"
            self.active.append(a)

    # ----------------------------------------------------------- prefill
    def _prefill_tick(self, tc: TickConfig) -> int:
        """The tick's bounded chunked-prefill batch: FIFO budget packing
        over mid-prefill rows, at most ``max_prefill_tokens`` prompt
        tokens per tick (unbounded when chunking is off), one
        ``prefill_rows`` call per engine.  Returns the tokens spent."""
        acts = [a for a in self.active
                if a.alive and a.state.phase == "prefill"]
        if not acts:
            return 0
        budget = tc.max_prefill_tokens if self.chunked else None
        chunks: List[Tuple[_Active, int]] = []
        spent = 0
        for a in acts:
            if not a.alive:          # preempted by an earlier chunk's grow
                continue
            rest = len(a.prompt) - a.cursor
            take = rest if budget is None else min(rest, budget - spent)
            if take <= 0:
                continue
            self._reserve(a, "base", a.cursor + take)
            self._reserve(a, "small", a.cursor + take)
            if a.alive:
                chunks.append((a, take))
                spent += take
        chunks = [(a, t) for a, t in chunks if a.alive]
        if not chunks:
            return 0
        for be, rows in ((self.base_be, [a.base_row for a, _ in chunks]),
                         (self.small_be, [a.small_row for a, _ in chunks])):
            be.prefill_rows(rows,
                            [a.prompt[a.cursor:a.cursor + t]
                             for a, t in chunks],
                            [a.cursor for a, _ in chunks])
        self.prefill_chunks += 1
        spent = sum(t for _, t in chunks)
        for a, take in chunks:
            a.cursor += take
            if a.cursor == len(a.prompt):
                a.req.prefill_done_at = time.perf_counter()
                a.state.phase = self.controller.think_phase(a.state)
                if a.cursor > take:
                    self._emit("prefill",
                               f"prefill {a.req.request_id}: done "
                               f"({a.cursor} tokens)",
                               request=a.req.request_id, cursor=a.cursor,
                               prompt=len(a.prompt), done=True)
            else:
                self._emit("prefill",
                           f"prefill {a.req.request_id}: "
                           f"{a.cursor}/{len(a.prompt)} tokens",
                           request=a.req.request_id, cursor=a.cursor,
                           prompt=len(a.prompt), done=False)
        return spent

    # ------------------------------------------------------------ blocks
    def _seq(self, a: _Active, which: str) -> PagedSeq:
        return a.base_seq if which == "base" else a.small_seq

    def _grow(self, a: _Active, which: str, n_tokens: int) -> None:
        """Grow a request's block table by n tokens (running the CoW
        copy it emits); preempt the youngest other request while the
        pool is exhausted.  A request already preempted is skipped."""
        if n_tokens <= 0 or not a.alive:
            return
        seq = self._seq(a, which)
        while True:
            try:
                self.engines[which].append_seq(seq, n_tokens)
                return
            except PoolExhausted:
                victim = next((v for v in reversed(self.active)
                               if v is not a and v.alive), None)
                if victim is None:
                    raise RuntimeError(
                        f"{which} KV pool exhausted by a single request "
                        f"({self.pools[which].num_blocks} blocks, "
                        f"block_size {self.kv.block_size}); provision a "
                        f"larger budget or lower the token budget") from None
                self._preempt(victim)

    def _reserve(self, a: _Active, which: str, end: int) -> None:
        """Make the table cover ``end`` tokens before a call writes
        them."""
        if a.alive:
            self._grow(a, which, end - self._seq(a, which).length)

    def _truncate(self, a: _Active, which: str, length: int) -> None:
        if a.alive:
            self.engines[which].truncate_seq(self._seq(a, which), length)

    def _settle(self, a: _Active, which: str) -> None:
        """After a call, shrink the table from the reserved worst case to
        the row's real length."""
        row = a.base_row if which == "base" else a.small_row
        self._truncate(a, which, int(self.engines[which].pos[row]))

    def _preempt(self, victim: _Active) -> None:
        self._release(victim)
        victim.req.blocked_reason = "preempted: KV block pool exhausted"
        victim.req.status = "queued"
        self.queue.appendleft(victim.req)
        self.preemptions += 1
        mid = f" (mid-prefill at {victim.cursor}/{len(victim.prompt)})" \
            if victim.state.phase == "prefill" else ""
        self._emit("preempt",
                   f"preempt {victim.req.request_id}: KV block pool "
                   f"exhausted{mid}; requeued for recompute",
                   request=victim.req.request_id,
                   phase=victim.state.phase, cursor=victim.cursor)

    def _release(self, a: _Active) -> None:
        """Release everything an admitted request holds: its block-table
        snapshots, both sequences and both engine rows.  Idempotent
        (``alive`` is the exactly-once latch)."""
        if not a.alive:
            return
        a.alive = False
        for snap, seq in ((a.b_seq_snap, a.base_seq),
                          (a.s_seq_snap, a.small_seq)):
            if snap is not None:
                seq.discard_snapshot(snap)
        a.b_seq_snap = a.s_seq_snap = None
        a.base_seq.free()
        a.small_seq.free()
        self.base_be.free_row(a.base_row)
        self.small_be.free_row(a.small_row)
        self.active = [x for x in self.active if x is not a]

    # -------------------------------------------------------------- tick
    def tick(self) -> bool:
        """One continuous-batching turn: admit, run the bounded
        chunked-prefill batch, then every running request's current phase
        as per-phase batched calls.  Returns True while there is work
        left."""
        self.ticks += 1
        tc = self.res.tick_config()
        self._admit(tc)
        self._prefill_tick(tc)
        self._phase_acts("speculate", self._speculate_batch)
        self._phase_acts("verify", self._verify_batch)
        self._flush_close_batch()
        fall = [a for a in self.active if a.state.phase == "fallback"]
        ans = [a for a in self.active if a.state.phase == "answer"]
        if fall or ans:
            self._base_decode_batch(fall, ans, tc)
        # TTFT: the first tick that left output tokens in a request's
        # trace stamps its first-token time (tick-granular)
        now = time.perf_counter()
        for a in self.active:
            if a.req.first_token_at is None and (a.state.thinking or
                                                 a.state.answer_ids):
                a.req.first_token_at = now
        self._finish()
        return bool(self.active or self.queue)

    def _phase_acts(self, phase: str, fn) -> None:
        acts = [a for a in self.active if a.state.phase == phase]
        if acts:
            fn(acts)

    def drain(self) -> List[Request]:
        """Tick until queue and batch are empty; returns the requests
        finished by this drain."""
        done_before = len(self.done)
        while self.tick():
            pass
        return self.done[done_before:]

    def _finish(self) -> None:
        meters = {"base": self.base_be.meter.as_dict(),
                  "small": self.small_be.meter.as_dict()}
        for a in [x for x in self.active if x.state.phase == "done"]:
            a.req.result = self.controller.result(a.state, meters=meters)
            a.req.status = STATUS_OK
            a.req.finished_at = time.perf_counter()
            self.done.append(a.req)
            self._release(a)

    # ------------------------------------------------------ phase batches
    def _speculate_batch(self, acts: List[_Active]) -> None:
        ctrl, cfg = self.controller, self.controller.cfg
        acts = [a for a in acts if a.alive]
        for a in acts:
            a.b_snap = self.base_be.snapshot_row(a.base_row)
            a.s_snap = self.small_be.snapshot_row(a.small_row)
            a.b_seq_snap = a.base_seq.snapshot()
            a.s_seq_snap = a.small_seq.snapshot()
        budgets = {id(a): ctrl.max_step_tokens(a.state) for a in acts}
        # the draft lands past the snapshot: reserving it copies the
        # shared partial tail block first (CoW)
        for a in acts:
            self._reserve(a, "small", int(self.small_be.pos[a.small_row])
                          + budgets[id(a)])
        acts = [a for a in acts if a.alive]
        outs = self.small_be.generate_rows(
            [a.small_row for a in acts], [budgets[id(a)] for a in acts],
            ctrl.segmenter.stop_ids, cfg.sampling,
            [a.state.generator for a in acts])
        for a, ids in zip(acts, outs):
            a.state.draft_ids = ids
            a.state.phase = "verify"
            self._settle(a, "small")

    def _verify_batch(self, acts: List[_Active]) -> None:
        ctrl = self.controller
        seg = ctrl.segmenter
        verifier = ctrl.verifier
        acts = [a for a in acts if a.alive]
        judge: List[_Active] = []
        for a in acts:
            ids = a.state.draft_ids
            a.end = seg.classify_end(ids)
            a.body = seg.body(ids)
            if a.body and a.end in ("step", "final", "runaway"):
                judge.append(a)
            else:
                self._reject(a, 0.0)
        # ONE batched scoring extend: each row takes [body..., <score>];
        # the per-position logits give the body logprobs and the score
        # readout, then the score token is dropped from every row
        for a in judge:
            self._reserve(a, "base", int(self.base_be.pos[a.base_row])
                          + len(a.body) + 1)
        judge = [a for a in judge if a.alive]
        if not judge:
            return
        rows = [a.base_row for a in judge]
        prev_logits = [self.base_be.last_logits[r].clone() for r in rows]
        all_logits = self.base_be.extend_rows(
            rows, [a.body + [verifier.score_token] for a in judge],
            want_logits=True)
        for a, prev, al in zip(judge, prev_logits, all_logits):
            body_logits, score_row = al[:-1], al[-1]
            a.mean_lp = mean_body_logprob(prev, body_logits, a.body)
            self.base_be.pos[a.base_row] -= 1
            self.base_be.last_logits[a.base_row] = body_logits[-1]
            self._settle(a, "base")
            utility, _ = verifier.utility_from_score_logits(score_row)
            verdict, utility = ctrl.judge_draft(utility, a.mean_lp)
            if verdict.accept:
                delim = ctrl.note_accept(a.state, a.body, a.end, utility)
                a.base_seq.discard_snapshot(a.b_seq_snap)
                a.small_seq.discard_snapshot(a.s_seq_snap)
                a.b_seq_snap = a.s_seq_snap = None
                a.pending_base.append(delim)
            else:
                self._reject(a, utility)

    def _reject(self, a: _Active, utility: float) -> None:
        """Roll both contexts back to the step boundary: O(1) row restore
        + block-table restore (frees the orphaned draft blocks)."""
        self.base_be.restore_row(a.base_row, a.b_snap)
        self.small_be.restore_row(a.small_row, a.s_snap)
        a.base_seq.restore(a.b_seq_snap)
        a.small_seq.restore(a.s_seq_snap)
        a.b_seq_snap = a.s_seq_snap = None
        self.controller.note_reject(a.state, a.body, utility)

    def _base_decode_batch(self, fall: List[_Active], ans: List[_Active],
                           tc: TickConfig) -> None:
        """The tick's base-model decode: fallback regenerations (stop at
        step boundaries) and final answers (stop at eos) in one call with
        per-row stop sets and budgets, or in spec mode through batched
        token-level speculative decoding."""
        ctrl, cfg = self.controller, self.controller.cfg
        fall = [a for a in fall if a.alive]
        ans = [a for a in ans if a.alive]
        acts = fall + ans
        if not acts:
            return
        budgets = [ctrl.max_step_tokens(a.state) for a in fall] \
            + [cfg.answer_max_tokens] * len(ans)
        stops = [ctrl.segmenter.stop_ids] * len(fall) + [[tk.EOS]] * len(ans)
        outs: List[Optional[List[int]]] = [None] * len(acts)

        if self.spec_be is not None and tc.spec_decode:
            items = [SpecRow(a.base_row, a.small_row, budgets[i], stops[i],
                             a.state.generator)
                     for i, a in enumerate(acts)]
            s_outs, round_stats = self.spec_be.decode_rows(
                items, cfg.sampling, _SchedulerLedger(self, acts))
            for i, (ids, s) in enumerate(zip(s_outs, round_stats)):
                if acts[i].alive:
                    outs[i] = ids
                    acts[i].state.spec_stats.merge(s)
                    self._settle(acts[i], "base")
                    self._settle(acts[i], "small")
        else:
            for a, b in zip(acts, budgets):
                self._reserve(a, "base",
                              int(self.base_be.pos[a.base_row]) + b)
            plain = [i for i in range(len(acts)) if acts[i].alive]
            p_outs = self.base_be.generate_rows(
                [acts[i].base_row for i in plain],
                [budgets[i] for i in plain], [], cfg.sampling,
                [acts[i].state.generator for i in plain],
                stop_ids_rows=[stops[i] for i in plain])
            for i, ids in zip(plain, p_outs):
                outs[i] = ids
                self._settle(acts[i], "base")
            # keep the small model's context in sync, batched
            sync = [i for i in plain if i < len(fall)]
            for i in sync:
                self._reserve(acts[i], "small",
                              int(self.small_be.pos[acts[i].small_row])
                              + len(outs[i]))
            sync = [i for i in sync if acts[i].alive]
            if sync:
                self.small_be.extend_rows([acts[i].small_row for i in sync],
                                          [outs[i] for i in sync])
        for i, a in enumerate(fall):
            if a.alive and outs[i] is not None:
                ctrl.note_base_step(a.state, outs[i])
        for i, a in enumerate(ans):
            ids = outs[len(fall) + i]
            if a.alive and ids is not None:
                a.state.answer_ids = ids
                a.state.phase = "done"

    def _flush_close_batch(self) -> None:
        """Move closing requests to the answer phase and flush every owed
        base-context token (accepted-step delimiters, budget </think>
        closers) in one merged base extend.  The small context is not
        closed: a closed request never drafts again."""
        items: List[_Active] = []
        for a in self.active:
            if a.state.phase == "close":
                if not a.state.done_thinking:
                    a.state.thinking += [tk.THINK_END]
                    a.pending_base.append(tk.THINK_END)
                a.state.phase = "answer"
            if a.pending_base:
                items.append(a)
        for a in items:
            self._reserve(a, "base", int(self.base_be.pos[a.base_row])
                          + len(a.pending_base))
        items = [a for a in items if a.alive]
        if not items:
            return
        self.base_be.extend_rows([a.base_row for a in items],
                                 [a.pending_base for a in items])
        for a in items:
            a.pending_base = []

    # ------------------------------------------------------------- stats
    def store_bytes(self):
        """Real bytes of each engine's page store (fp32 pages: twice the
        KVManager's 2-byte accounting of the same blocks, plus the
        store's scratch page)."""
        return {w: be.store.nbytes for w, be in self.engines.items()}
