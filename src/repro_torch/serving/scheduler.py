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
    lands in a copy, so a rejection reads back the pre-snapshot K/V;
  * the radix prefix cache (``serving/prefix_cache.py``, on by default
    as in the JAX package) is zero-copy: a cached block is a pool block
    the cache holds a reference on.  A hit adopts the cached blocks into
    the new row's table (``PagedSeq.adopt``, ``BatchEngine.adopt_row``)
    and the row's prefill starts at the cached length, its suffix's span
    attention reading the cached pages; an insert retains the row's own
    freshly prefilled full prompt blocks.  The JAX package copies cached
    KV into a page store of its own and back into the dense rows.

Admission is cached-prefix-aware as in the JAX package: the common
block-aligned hit of both engines' caches is adopted and only the suffix
is prefilled; a queued request whose prefix an in-flight prefill is
about to insert defers a tick (``defer`` event) and admits as a hit;
each chunk's full prompt blocks are inserted as it lands, so best-of-N
siblings and preempted requests (whose prompt blocks survive in the
cache) skip the repeated prefill.  Under pool pressure idle cached
blocks are evicted LRU-first, before an admission is declared blocked
and before a live request is preempted.

**Failure model** (``serving/resilience.py``, ``serving/faults.py``),
as in the JAX package: every request ends in a terminal ``status`` of
ok, timeout, shed or failed, a non-ok one with a structured
``RequestError``; deadlines cancel rows queued or mid-flight (mid
chunked prefill, and between spec-decode rounds through the ledger's
``alive``) through an idempotent release; an overload controller folds
pool occupancy, busy rows and the finishes' TTFT / TPOT / service EWMAs
into a pressure that drives an admission throttle, a priority and
best-of-N aware shed policy, and the degradation ladder, whose rung's
``TickConfig`` is applied every tick (gamma to the spec engine, spec
decode off, the prefill budget, prefix-cache insertion); fault guards
quarantine poisoned rows (NaN logits, a raised engine call), retry them
once without speculation and fail them with a structured error on the
next hit; ``audit=True`` reconciles every pool's refcounts against its
holders each tick.  A ``raise`` fault fires where the phase collects
its rows, before it reserves pages or calls an engine, so a raising
phase has nothing reserved to give back: the admission's first-chunk
pages of a prefill row belong to its sequence and go with its release.

**Observability** (``serving/telemetry.py``): a ``tracer`` records
per-request span timelines (queued, prefill chunks, the phases,
spec-decode rounds, verdicts, terminal instants), per-tick scheduler
spans and counters and the engines' call brackets; ``metrics`` feeds
the Prometheus-style registry.  Both are None by default and every
recording site is guarded on that.

Tensor parallelism (``tp``, a ``serving.tp.TPContext``): every rank
process runs this scheduler on the same host state, one context shared
by both engines, their page stores and both prefix caches, and the
ranks stay in lockstep because every decision is taken from replicated
state and whole logits.  A decision that reads a clock is taken on rank
0 and broadcast: arrivals in ``workload.run_workload``, and, in one
broadcast on each tick with an SLO set or a request with a deadline,
the requests that expire, those shed as infeasible (by arrival index),
and the overload controller's EWMAs, pressure and rung (from which the
admission throttle follows).  So under tp a deadline is checked at the
tick's sweep only, not between spec-decode rounds.  Injected stalls
sleep on every rank.  At the end of each drain the ranks' statuses,
error codes and tokens are compared (``check_lockstep``), and a
mismatch raises.

Not ported yet, each raising ``NotImplementedError``: the monitors, the
admin plane's status board and tick callback, the compile and memory
watches (ROADMAP queue 1, item 6: monitors, admin and device plane),
and overlapped mode.
"""

from __future__ import annotations

import dataclasses
import time
import uuid
from collections import deque
from typing import (Callable, Collection, Deque, Dict, List, Optional,
                    Tuple)

import torch

from ..core.controller import (SpecReason, SpecReasonResult,
                               SpecReasonStepState)
from ..core.verifier import mean_body_logprob
from ..data.tasks import Task, question_tokens
from ..tokenizer import toy as tk
from .batch_engine import BatchEngine, RowSnapshot
from .faults import (AuditViolation, FaultInjector, InjectedEngineError,
                     audit_scheduler)
from .kv_manager import KVManager
from .paged_kv import (BlockTableSnapshot, PagedKVPool, PagedSeq,
                       PoolExhausted)
from .prefix_cache import RadixCache
from .resilience import (STATUS_FAILED, STATUS_OK, STATUS_SHED,
                         STATUS_TIMEOUT, TERMINAL_STATUSES,
                         OverloadController, RequestError, ResilienceConfig,
                         TickConfig)
from .spec_engine import BatchSpecEngine, SpecLedger, SpecRow
from .telemetry import (TRACK_SCHED, SchedEvent, ServingMetrics, Tracer,
                        request_track)
from .tp import TPContext

# Per-tick prompt-prefill token budget (chunked prefill), as in the JAX
# package.
DEFAULT_MAX_PREFILL_TOKENS = 64


# the scheduler arguments of the JAX package this slice leaves out
LIVE_PLANE = ("monitors", "status_board", "on_tick", "compile_watch",
              "memory_watch")
LIVE_PLANE_ITEM = "ROADMAP queue 1, item 6 (monitors, admin and device plane)"

# the overload controller's state that rank 0 broadcasts under tp
_RES_STATE = ("level", "pressure", "transitions", "_hot", "_cool")
_RES_EWMAS = ("ewma_tpot", "ewma_ttft", "ewma_service")


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
    # failure lifecycle (serving/resilience.py): "queued" -> "running" ->
    # one of ok | timeout | shed | failed, every non-ok one with a
    # structured error.  ``deadline_s`` is a wall-clock budget from
    # submission (None: none); higher ``priority`` admits first and sheds
    # last; ``group`` marks best-of-N siblings for the shed policy
    status: str = "queued"
    error: Optional[RequestError] = None
    deadline_s: Optional[float] = None
    priority: int = 0
    group: Optional[str] = None
    # submission order (the fault plan's target key) and the fault
    # guard's retry state: ``quarantined`` sends every later decode down
    # the plain (speculation-free) path
    arrival_idx: int = -1
    retries: int = 0
    quarantined: bool = False
    blocked_reason: Optional[str] = None
    # radix prefix cache: prompt length and how many of its tokens were
    # served from cached blocks (set at admission, the last one for a
    # preempted request; zero with the cache off)
    prompt_tokens: int = 0
    cache_hit_tokens: int = 0
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

    def expired(self, now: Optional[float] = None) -> bool:
        """True when the request's wall-clock deadline has passed."""
        if self.deadline_s is None:
            return False
        now = time.perf_counter() if now is None else now
        return now - self.submitted_at > self.deadline_s


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
        # deadline checks ride the engine's liveness probes: a request
        # whose deadline passes during a multi-round spec decode is
        # cancelled between rounds (its pages released, the engine drops
        # the row as after a preemption).  Under tp the clock is rank 0's
        # alone, so the tick's sweep decides (module docstring)
        a = self.acts[i]
        if a.alive and self.sched.tp is None:
            self.sched._check_deadline(a)
        return a.alive

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
    controller (greedy, and sampled with the same generators), chunked
    prefill to unchunked, and the prefix cache on to off.

    ``on_event`` receives admission / chunk-progress / preemption /
    quarantine / degradation / terminal events as
    :class:`telemetry.SchedEvent` (the serve CLI's ``--verbose``);
    ``resilience``, ``faults``, ``audit``, ``tracer`` and ``metrics``
    are the failure model and observability of the module docstring."""

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
                 faults: Optional[FaultInjector] = None,
                 audit: bool = False,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[ServingMetrics] = None,
                 seed: int = 0, tp: Optional[TPContext] = None,
                 **live_plane):
        """``tp``: this rank's context (None, or a degree of 1, serves on
        one device).  ``live_plane``: the JAX package's ``monitors``,
        ``status_board``, ``on_tick``, ``compile_watch`` and
        ``memory_watch``, which raise: they are not ported yet."""
        for name, value in live_plane.items():
            if name not in LIVE_PLANE:
                raise TypeError(f"unexpected argument {name!r}")
            if value is not None:
                raise NotImplementedError(
                    f"{name}= is not ported yet ({LIVE_PLANE_ITEM})")
        cfg = controller.cfg
        if cfg.overlapped:
            raise NotImplementedError(
                "continuous batching covers the speculate/verify/fallback "
                "pipeline with optional hierarchical spec decode; use the "
                "sequential controller for overlapped mode")
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
        # one context for both engines, their stores and both caches
        self.tp = tp if tp is not None and tp.tp_size > 1 else None
        # the batched decode loop follows the controller's
        # ``fused_decode`` (None: the engines' default, fused; the
        # per-token loop under tp)
        self.tracer = tracer
        self.metrics = metrics
        self.base_be = BatchEngine(controller.base.model,
                                   controller.base.params, max_batch,
                                   engine_capacity,
                                   name=f"cb-{controller.base.name}",
                                   pool=self.pools["base"],
                                   fused=cfg.fused_decode, tp=self.tp,
                                   tracer=tracer)
        self.small_be = BatchEngine(controller.small.model,
                                    controller.small.params, max_batch,
                                    engine_capacity,
                                    name=f"cb-{controller.small.name}",
                                    pool=self.pools["small"],
                                    fused=cfg.fused_decode, tp=self.tp,
                                    tracer=tracer)
        self.engines = {"base": self.base_be, "small": self.small_be}
        self.spec_be = BatchSpecEngine(self.base_be, self.small_be,
                                       self.gamma) if self.spec else None
        # one radix prefix cache per engine pool, its cached blocks pool
        # blocks (zero-copy), capped by KVManager.prefix_cache_blocks as
        # the JAX package caps its store
        self.caches: Optional[Dict[str, RadixCache]] = None
        if prefix_cache:
            self.caches = {
                which: RadixCache(self.pools[which],
                                  kv.prefix_cache_blocks(which),
                                  meter=be.meter,
                                  kv_heads=be.model.cfg.n_kv_heads,
                                  tp=self.tp)
                for which, be in self.engines.items()}
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
        # resilience: a default (inert) config keeps the exact behaviour
        # of a scheduler without it; the injector and the per-tick audits
        # are debug machinery, off in production serving
        self.res_cfg = resilience if resilience is not None \
            else ResilienceConfig()
        self.res = OverloadController(self.res_cfg, TickConfig(
            gamma=self.gamma, spec_decode=self.spec,
            max_prefill_tokens=max_prefill_tokens, cache_insert=True))
        self.faults = faults
        self.audit_enabled = audit
        self._submitted = 0          # arrival_idx assignment
        self.timeouts = 0            # requests past deadline
        self.shed_requests = 0       # dropped by the shed policy
        self.quarantines = 0         # fault-guard hits
        self.retries = 0             # quarantine readmissions
        self.failures = 0            # terminal ``failed`` outcomes
        self.stalled_ticks = 0       # injected stall ticks
        self.audit_violations = 0    # should stay 0; audits raise

    # ------------------------------------------------------------- intake
    def submit(self, task: Task, generator: Optional[torch.Generator] = None,
               deadline_s: Optional[float] = None, priority: int = 0,
               group: Optional[str] = None) -> Request:
        """Queue a task; ``generator`` pins the request's random draws
        (same generator seed, same tokens, sequential or continuous).
        Without one, admission seeds a generator on the engines' device
        from the scheduler's ``seed`` and the arrival index.
        ``deadline_s`` is a wall-clock budget from submission (expiry
        cancels the request, queued or mid-flight, with status
        ``timeout``); ``priority`` orders admission and protects against
        shedding; ``group`` marks best-of-N siblings for the shed
        policy."""
        req = Request(task, generator=generator, deadline_s=deadline_s,
                      priority=priority, group=group,
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

    def _common_block_prefix(self, p: List[int], q: List[int]) -> int:
        """Longest block-aligned common prefix of two prompts that the
        cache could serve ``p`` from once ``q`` is inserted: whole equal
        blocks only, at most ``p``'s cacheable length."""
        bs = self.kv.block_size
        limit = min(self._cacheable_len(len(p)), (len(q) // bs) * bs)
        n = 0
        while n + bs <= limit and p[n:n + bs] == q[n:n + bs]:
            n += bs
        return n

    def _cacheable_len(self, prompt_len: int) -> int:
        """Longest prefix of a prompt the cache could ever serve: whole
        blocks, never the entire prompt (one token is always
        prefilled)."""
        nb = prompt_len // self.kv.block_size
        if nb * self.kv.block_size == prompt_len:
            nb -= 1
        return max(nb, 0) * self.kv.block_size

    def _emit(self, kind: str, msg: str, **fields) -> None:
        """One structured event to ``on_event`` and, as an instant on the
        owning track, to the tracer; a no-op with neither attached."""
        if self.on_event is None and self.tracer is None:
            return
        ev = SchedEvent(kind, msg, fields)
        if self.on_event is not None:
            self.on_event(ev)
        if self.tracer is not None:
            self.tracer.event(ev)

    def _admit(self, tc: TickConfig, quota: Optional[int] = None) -> None:
        admitted: List[_Active] = []
        # wait-for-prefix: prompts whose prefill will insert new cached
        # blocks (chunked prefills in flight, then this round's cold
        # admissions).  A queued request whose cacheable prefix one of
        # them extends defers a tick and admits as a deeper hit instead
        # of duplicating the prefill (keyed on real block overlap)
        fresh_prompts: List[List[int]] = [
            a.prompt for a in self.active
            if a.state.phase == "prefill"] if self.caches is not None \
            else []
        # highest priority first, FIFO within a priority class; a blocked
        # candidate stops the loop so nothing jumps it
        order = [r for _, r in sorted(
            enumerate(self.queue), key=lambda t: (-t[1].priority, t[0]))]
        for req in order:
            if quota is not None and len(admitted) >= quota:
                break
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
            # the common block-aligned hit of both engines' caches, so one
            # suffix drives both prefills
            cached = 0
            cacheable = self._cacheable_len(len(prompt))
            if self.caches is not None and cacheable:
                cached = min(c.peek(prompt) for c in self.caches.values())
                if cached < cacheable and any(
                        self._common_block_prefix(prompt, q) > cached
                        for q in fresh_prompts):
                    req.blocked_reason = ("deferred: waiting for shared "
                                          "prefix insert")
                    self._emit("defer",
                               f"defer {req.request_id}: waiting for "
                               f"shared prefix insert (hit {cached}"
                               f"/{cacheable} cacheable tokens)",
                               request=req.request_id, hit=cached,
                               cacheable=cacheable)
                    continue
            first = len(prompt) - cached
            if self.chunked:
                first = min(first, tc.max_prefill_tokens)
            need = self.kv.chunk_blocks(cached, first) \
                + self._headroom_blocks()
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
            seqs = {w: PagedSeq(self.pools[w]) for w in ("base", "small")}
            if cached:
                # adopt the shared chain before any eviction below: its
                # blocks are then in flight (refcount >= 2), so pressure
                # eviction cannot take the chain this admission rests on
                for w, c in self.caches.items():
                    seqs[w].adopt(c.acquire(prompt, cached), cached)
            short = []
            for w in ("base", "small"):
                if self.pools[w].num_free < need and self.caches:
                    # idle cached blocks are reclaimable: evict LRU-first
                    # before declaring the pool short
                    self.caches[w].evict(need - self.pools[w].num_free)
                if self.pools[w].num_free < need:
                    short.append(w)
            if short:
                for seq in seqs.values():
                    seq.free()
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
            # a hit's rows start at the cached length over the adopted
            # pages; nothing is copied
            a = _Active(req=req, state=st,
                        base_row=self.base_be.adopt_row(seqs["base"]),
                        small_row=self.small_be.adopt_row(seqs["small"]),
                        base_seq=seqs["base"], small_seq=seqs["small"])
            self.queue.remove(req)
            req.blocked_reason = None
            req.status = "running"
            req.admitted_at = time.perf_counter()
            req.prefill_done_at = None
            a.prompt = list(prompt)
            a.cursor = cached
            if self.caches is not None:
                req.prompt_tokens = len(prompt)
                req.cache_hit_tokens = cached
                for c in self.caches.values():
                    c.record(len(prompt), cached)
                if cached < cacheable:
                    fresh_prompts.append(prompt)
            # reserve the first chunk's blocks now (the `need` check above
            # guaranteed them); later chunks grow at their prefill ticks
            self.base_be.append_seq(a.base_seq, first)
            self.small_be.append_seq(a.small_seq, first)
            admitted.append(a)
            if self.tracer is not None:
                # the request's wait for admission, on its track
                self.tracer.span(request_track(req.request_id), "queued",
                                 req.submitted_at, req.admitted_at)
            self._emit("admit",
                       f"admit {req.request_id}: prompt={len(prompt)} "
                       f"cached={cached} first_chunk={first}"
                       + ("" if first >= len(prompt) - cached else
                          f" (chunked, {len(prompt) - cached} suffix "
                          f"tokens over >= "
                          f"{-(-(len(prompt) - cached) // max(first, 1))} "
                          f"ticks)"),
                       request=req.request_id, prompt=len(prompt),
                       cached=cached, first_chunk=first)
        for a in admitted:
            a.state.phase = "prefill"
            self.active.append(a)

    # ----------------------------------------------------------- prefill
    def _prefill_tick(self, tc: TickConfig) -> int:
        """The tick's bounded chunked-prefill batch: FIFO budget packing
        over mid-prefill rows, at most ``max_prefill_tokens`` prompt
        tokens per tick (unbounded when chunking is off), one
        ``prefill_rows`` call per engine.  Returns the tokens spent."""
        acts = self._guard("prefill", [a for a in self.active
                                       if a.state.phase == "prefill"])
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
        tr, mt = self.tracer, self.metrics
        t0 = time.perf_counter() if (tr is not None or mt is not None) \
            else 0.0
        for be, rows in ((self.base_be, [a.base_row for a, _ in chunks]),
                         (self.small_be, [a.small_row for a, _ in chunks])):
            be.prefill_rows(rows,
                            [a.prompt[a.cursor:a.cursor + t]
                             for a, t in chunks],
                            [a.cursor for a, _ in chunks])
        self.prefill_chunks += 1
        spent = sum(t for _, t in chunks)
        if tr is not None or mt is not None:
            t1 = time.perf_counter()
            if mt is not None:
                mt.chunk_latency.observe(t1 - t0)
                mt.prefill_tokens.inc(spent)
            if tr is not None:
                for a, take in chunks:       # cursors not yet advanced
                    tr.span(request_track(a.req.request_id), "prefill",
                            t0, t1, {"from": a.cursor,
                                     "to": a.cursor + take,
                                     "prompt": len(a.prompt)})
        bs = self.kv.block_size
        for a, take in chunks:
            a.cursor += take
            # cache_insert=False is the ladder's deepest rung: stop
            # inserting fresh prefixes (lookups still serve hits; outputs
            # unchanged)
            if self.caches is not None and tc.cache_insert:
                # cache every full prompt block not cached yet: the cache
                # retains the row's own freshly written pool blocks, so a
                # preempted request and waiting siblings find them
                nb_full = a.cursor // bs
                if nb_full:
                    for w, c in self.caches.items():
                        c.insert(a.prompt[:nb_full * bs],
                                 self._seq(a, w).blocks[:nb_full])
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
                # cheapest relief first: evict idle cached blocks (only
                # the cache holds them) before preempting a live request
                if self.caches is not None and self.caches[which].evict(
                        self.pools[which].blocks_for_tokens(n_tokens) + 1):
                    continue
                victim = next((v for v in reversed(self.active)
                               if v is not a and v.alive), None)
                if victim is None:
                    if self.faults is not None \
                            and self.faults.holding(which):
                        # transient exhaustion (an injected hold owns the
                        # pool): requeue this request for recompute once
                        # the hold releases; a request too big for the
                        # pool is refused at admission
                        self._preempt(a)
                        return
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
        if self.metrics is not None:
            self.metrics.preemptions.inc()
        mid = f" (mid-prefill at {victim.cursor}/{len(victim.prompt)})" \
            if victim.state.phase == "prefill" else ""
        self._emit("preempt",
                   f"preempt {victim.req.request_id}: KV block pool "
                   f"exhausted{mid}; requeued for recompute",
                   request=victim.req.request_id,
                   phase=victim.state.phase, cursor=victim.cursor)

    def _release(self, a: _Active) -> None:
        """Release everything an admitted request holds: its block-table
        snapshots, both sequences (their own references only: a hit's
        adopted cached blocks drop the row's reference exactly once, the
        cache's survives) and both engine rows.  Idempotent (``alive`` is
        the exactly-once latch)."""
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

    # ------------------------------------------------ failure lifecycle
    def _finalize(self, req: Request, status: str, code: str,
                  message: str) -> None:
        """Stamp a terminal non-ok outcome and move the request to
        ``done`` (the caller has detached it from queue / active)."""
        req.status = status
        req.error = RequestError(code, message, self.ticks)
        req.finished_at = time.perf_counter()
        req.blocked_reason = None
        self.done.append(req)
        meter = self.base_be.meter
        if status == STATUS_TIMEOUT:
            self.timeouts += 1
            meter.req_timeouts += 1
        elif status == STATUS_SHED:
            self.shed_requests += 1
            meter.req_shed += 1
        elif status == STATUS_FAILED:
            self.failures += 1
            meter.req_failed += 1
        if self.metrics is not None:
            self.metrics.requests.inc(status=status)
        self._emit(status, f"{status} {req.request_id}: {message}",
                   request=req.request_id, code=code)

    def _cancel(self, a: _Active, status: str, code: str,
                message: str) -> None:
        """Cancel an in-flight request whatever it is doing (chunked
        prefill, a spec-decode call between rounds, decode): release its
        pages, tables and radix references and stamp the terminal
        outcome.  Idempotent."""
        if not a.alive:
            return
        self._release(a)
        self._finalize(a.req, status, code, message)

    def _time_out(self, a: _Active) -> None:
        self._cancel(a, STATUS_TIMEOUT, "deadline",
                     f"deadline {a.req.deadline_s:g}s exceeded "
                     f"mid-flight (phase {a.state.phase})")

    def _check_deadline(self, a: _Active) -> None:
        """Mid-flight deadline check, from the spec ledger's ``alive``
        (between rounds)."""
        if a.alive and a.req.expired():
            self._time_out(a)

    def _expire_deadlines(self, expired: Optional[Collection[int]] = None
                          ) -> List[int]:
        """Time out every expired request, in flight then queued.
        ``expired``: the arrival indices rank 0 decided (under tp; a
        request's id is drawn per process, its arrival index is the same
        on every rank); None reads the clock.  Returns the arrival
        indices timed out."""
        now = time.perf_counter()

        def due(r: Request) -> bool:
            return r.expired(now) if expired is None \
                else r.arrival_idx in expired
        out = []
        for a in list(self.active):
            if a.alive and due(a.req):
                out.append(a.req.arrival_idx)
                self._time_out(a)
        for req in [r for r in self.queue if due(r)]:
            out.append(req.arrival_idx)
            self.queue.remove(req)
            self._finalize(req, STATUS_TIMEOUT, "deadline",
                           f"deadline {req.deadline_s:g}s exceeded "
                           f"while queued")
        return out

    def _group_survivors(self, req: Request) -> int:
        """How many OTHER members of ``req``'s best-of-N group are still
        viable (queued, in flight, or finished ok): the shed policy keeps
        at least ``min_group_survivors`` so the vote keeps ballots."""
        if req.group is None:
            return 0
        return (sum(1 for r in self.queue
                    if r is not req and r.group == req.group)
                + sum(1 for a in self.active if a.req.group == req.group)
                + sum(1 for r in self.done
                      if r.group == req.group and r.status == STATUS_OK))

    def _shed_victim(self) -> Optional[Request]:
        """Shed order: lowest priority first; within a priority class,
        best-of-N siblings whose group keeps enough survivors before
        singletons (drop a ballot, not a request); youngest first breaks
        the last tie."""
        cfg = self.res_cfg
        best, best_key = None, None
        for i, r in enumerate(self.queue):
            covered = r.group is not None \
                and self._group_survivors(r) >= cfg.min_group_survivors
            sort_key = (r.priority, 0 if covered else 1, -i)
            if best_key is None or sort_key < best_key:
                best, best_key = r, sort_key
        return best

    def _shed(self, infeasible: Optional[Collection[int]] = None
              ) -> List[int]:
        """The tick's shed pass (policy "priority"): drop queued requests
        that can no longer turn capacity into goodput -- first those
        whose remaining deadline budget is below the EWMA service time,
        then, while the queue is deeper than ``max_queue``, the shed
        order above.  ``infeasible``: the arrival indices rank 0 decided
        (under tp); None reads the clock.  Returns the arrival indices
        shed as infeasible."""
        cfg = self.res_cfg
        out: List[int] = []
        if cfg.shed_policy == "none" or not self.queue:
            return out
        now = time.perf_counter()
        for req in [r for r in self.queue if r.deadline_s is not None]:
            remaining = req.deadline_s - (now - req.submitted_at)
            if (self.res.infeasible(remaining) if infeasible is None
                    else req.arrival_idx in infeasible):
                out.append(req.arrival_idx)
                self.queue.remove(req)
                self._finalize(req, STATUS_SHED, "shed_infeasible",
                               f"remaining deadline budget "
                               f"{remaining:.3f}s below the estimated "
                               f"service time")
        while cfg.max_queue is not None \
                and len(self.queue) > cfg.max_queue:
            victim = self._shed_victim()
            if victim is None:
                break
            self.queue.remove(victim)
            self._finalize(victim, STATUS_SHED, "shed_overload",
                           f"queue depth {len(self.queue) + 1} above "
                           f"max_queue={cfg.max_queue}")
        return out

    # ------------------------------------------------------ fault guards
    def _guard(self, phase: str, acts: List[_Active]) -> List[_Active]:
        """Guard a phase batch against injected engine-call failures: a
        ``raise`` fault aimed at a row of the batch fires as the phase
        collects its rows, before any page is reserved or engine called;
        the row is quarantined and the rest of the batch proceeds."""
        if self.faults is None or not acts:
            return [a for a in acts if a.alive]
        while True:
            try:
                self.faults.maybe_raise(phase,
                                        [a.req for a in acts if a.alive])
                break
            except InjectedEngineError as e:
                victim = next(a for a in acts
                              if a.req.request_id == e.request_id)
                self._quarantine(victim, "engine_error", str(e))
        return [a for a in acts if a.alive]

    def _quarantine(self, a: _Active, code: str, message: str) -> None:
        """The fault guard's contract: a first hit releases the row and
        requeues the request for a recompute without speculation (from
        its generator's state at first admission: the same tokens); a hit
        past ``max_retries`` ends it ``failed``."""
        if not a.alive:
            return
        req = a.req
        self.quarantines += 1
        self.base_be.meter.req_quarantines += 1
        if req.retries >= self.res_cfg.max_retries:
            self._cancel(a, STATUS_FAILED, code,
                         f"{message} (retries exhausted after "
                         f"{req.retries})")
            return
        req.retries += 1
        self.retries += 1
        self.base_be.meter.req_retries += 1
        req.quarantined = True
        self._release(a)
        req.status = "queued"
        req.blocked_reason = f"quarantined: {code}; retrying without " \
                             f"speculation"
        self.queue.appendleft(req)
        self._emit("quarantine",
                   f"quarantine {req.request_id}: {code} — requeued, "
                   f"speculation disabled (retry {req.retries})",
                   request=req.request_id, code=code, retry=req.retries)

    def _health_scan(self) -> None:
        """The per-tick health guard: a live row whose ``last_logits``
        went non-finite (a corrupted engine step, or the injector's
        ``nan_logits``) is quarantined before anything samples from it.
        One reduction an engine over the live rows and one copy to the
        host a tick, outside any captured graph."""
        acts = [a for a in self.active if a.alive]
        if not acts:
            return
        n = len(acts)
        ok = torch.cat([
            self.base_be.finite_mask([a.base_row for a in acts]),
            self.small_be.finite_mask([a.small_row for a in acts])]).tolist()
        for a, fb, fs in zip(acts, ok[:n], ok[n:]):
            if not (fb and fs):
                which = "base" if not fb else "small"
                self._quarantine(a, "nan_logits",
                                 f"non-finite logits in the {which} "
                                 f"engine row")

    def _audit(self) -> None:
        """The per-tick invariant audit (``audit=True``): any divergence
        of the pools' refcounts, the tables or the radix caches from
        their holders raises ``AuditViolation``."""
        viols = audit_scheduler(self)
        if viols:
            self.audit_violations += len(viols)
            raise AuditViolation(f"tick {self.ticks}: " + "; ".join(viols))

    # ---------------------------------------------------- overload sweep
    def _res_state(self) -> dict:
        return {**{k: getattr(self.res, k) for k in _RES_STATE},
                **{k: getattr(self.res, k).value for k in _RES_EWMAS}}

    def _load_res_state(self, state: dict) -> None:
        for k in _RES_STATE:
            setattr(self.res, k, state[k])
        for k in _RES_EWMAS:
            getattr(self.res, k).value = state[k]

    def _reads_clock(self) -> bool:
        """Whether this tick's sweep can take a decision from a clock: an
        SLO (the ladder's strain and the admission throttle read the
        latency EWMAs) or a request with a deadline (expiry, feasibility
        shedding).  Every rank computes it from replicated state."""
        c = self.res_cfg
        return (c.slo_tpot_s is not None or c.slo_ttft_s is not None
                or any(r.deadline_s is not None for r in self.queue)
                or any(a.req.deadline_s is not None for a in self.active))

    def _sweep(self) -> float:
        """The tick's sweeps, before admission: expire deadlines, shed,
        then fold this tick's signals into the overload controller
        (emitting its ladder transitions).  Under tp, on a tick whose
        sweep reads a clock, rank 0 takes the decisions and broadcasts
        them with the controller's state (one broadcast) and the other
        ranks apply them; on any other tick every rank computes the same
        sweep from replicated state, with no collective.  Returns the
        pool occupancy the controller saw."""
        tp = self.tp if self.tp is not None and self._reads_clock() \
            else None
        if tp is not None and tp.rank != 0:
            got = tp.broadcast(None)
            self._expire_deadlines(got["expired"])
            self._shed(got["infeasible"])
            self._load_res_state(got["res"])
            events = got["events"]
            occ = got["occupancy"]
        else:
            expired = self._expire_deadlines()
            infeasible = self._shed()
            occ = max(p.num_used / p.num_blocks for p in self.pools.values())
            # row pressure is demand (busy rows plus waiting arrivals)
            # against capacity: this sweep runs before admission, so a
            # row freed by last tick's finish must not read as idle
            busy = self.base_be.batch - min(self.base_be.free_rows,
                                            self.small_be.free_rows)
            rows_busy = min(1.0, (busy + len(self.queue))
                            / self.base_be.batch)
            events = self.res.observe_tick(self.ticks, occ, rows_busy,
                                           len(self.queue))
            if tp is not None:
                tp.broadcast({"expired": expired, "infeasible": infeasible,
                              "res": self._res_state(), "events": events,
                              "occupancy": occ})
        for ev in events:
            # ladder transitions, rendered by the controller
            self._emit("degrade", ev, tick=self.ticks,
                       level=self.res.level,
                       pressure=round(self.res.pressure, 4))
        return occ

    # -------------------------------------------------------------- tick
    def tick(self) -> bool:
        """One continuous-batching turn: arm the tick's faults, run the
        deadline / shed / overload sweeps (also on a stalled tick), admit,
        run the bounded chunked-prefill batch, then every running
        request's current phase as per-phase batched calls; then the
        health scan and the audit.  Returns True while there is work
        left."""
        self.ticks += 1
        tr, mt = self.tracer, self.metrics
        t_tick0 = time.perf_counter() if tr is not None else 0.0
        # faults first: pool holds claim / release and stall windows open
        # before the rest of the tick; a stalled tick skips admission,
        # prefill and the phases but still runs the failure lifecycle
        stalled = False
        if self.faults is not None:
            stalled = self.faults.begin_tick(self.ticks, self)
            if stalled:
                self.stalled_ticks += 1
        occ = self._sweep()
        tc = self.res.tick_config()
        spent = 0
        comp: Dict[str, int] = {}
        if not stalled:
            self._admit(tc, quota=self.res.admit_quota(len(self.active)))
            if tr is not None:
                for a in self.active:
                    comp[a.state.phase] = comp.get(a.state.phase, 0) + 1
            spent = self._prefill_tick(tc)
            self._phase_acts("speculate", self._speculate_batch)
            self._phase_acts("verify", self._verify_batch)
            self._flush_close_batch()
            fall = self._guard("fallback", [a for a in self.active
                                            if a.state.phase == "fallback"])
            ans = self._guard("answer", [a for a in self.active
                                         if a.state.phase == "answer"])
            if fall or ans:
                self._base_decode_batch(fall, ans, tc)
        # the health guard: injected NaNs land here (this tick's engine
        # step corrupting a row), then the scan quarantines every
        # non-finite row before the finish or the next tick reads it
        if self.faults is not None:
            self.faults.poison(self)
        self._health_scan()
        # TTFT: the first tick that left output tokens in a request's
        # trace stamps its first-token time (tick-granular)
        now = time.perf_counter()
        for a in self.active:
            if a.req.first_token_at is None and (a.state.thinking or
                                                 a.state.answer_ids):
                a.req.first_token_at = now
        self._finish()
        if self.audit_enabled:
            self._audit()
        if mt is not None:
            mt.ticks.inc()
            mt.queue_depth.set(len(self.queue))
            mt.pressure.set(self.res.pressure)
            mt.degrade_level.set(self.res.level)
            for w, p in self.pools.items():
                mt.pool_occupancy.set(p.num_used / p.num_blocks, pool=w)
        if tr is not None:
            t_tick1 = time.perf_counter()
            tr.span(TRACK_SCHED, "tick", t_tick0, t_tick1, {
                "tick": self.ticks, "queue": len(self.queue),
                "active": len(self.active), "batch": comp,
                "occupancy": round(occ, 4),
                "pressure": round(self.res.pressure, 4),
                "level": self.res.level, "prefill_tokens": spent})
            tr.counter("kv_occupancy",
                       {w: round(p.num_used / p.num_blocks, 4)
                        for w, p in self.pools.items()}, t=t_tick1)
            tr.counter("pressure",
                       {"pressure": round(self.res.pressure, 4),
                        "level": float(self.res.level)}, t=t_tick1)
            tr.counter("queue_depth",
                       {"queued": float(len(self.queue)),
                        "active": float(len(self.active))}, t=t_tick1)
        working = bool(self.active or self.queue)
        if not working and self.faults is not None:
            # end of run: drop holds whose expiry the workload never
            # reached, so drained pools reconcile to zero
            self.faults.release_all(self)
        return working

    def _phase_acts(self, phase: str, fn) -> None:
        acts = self._guard(phase, [a for a in self.active
                                   if a.state.phase == phase])
        if not acts:
            return
        tr = self.tracer
        if tr is None:
            fn(acts)
            return
        t0 = time.perf_counter()
        fn(acts)
        t1 = time.perf_counter()
        for a in acts:
            tr.span(request_track(a.req.request_id), phase, t0, t1)

    def drain(self) -> List[Request]:
        """Tick until queue and batch are empty; returns the requests
        finished by this drain."""
        done_before = len(self.done)
        while self.tick():
            pass
        self.check_lockstep(self.done[done_before:])
        return self.done[done_before:]

    def check_lockstep(self, requests: List[Request]) -> None:
        """Under tp: raise unless every rank finished ``requests`` with the
        same statuses, error codes and tokens (the ranks run on
        replicated state, so a difference means they drifted apart)."""
        if self.tp is None:
            return
        mine = [(r.status, r.error.code if r.error is not None else None,
                 None if r.result is None else
                 (list(r.result.thinking_ids), list(r.result.answer_ids)))
                for r in requests]
        ranks = self.tp.all_objects(mine)
        bad = [i for i, t in enumerate(ranks) if t != ranks[0]]
        if bad:
            raise RuntimeError(f"tensor-parallel ranks {bad} finished "
                               f"{len(requests)} requests with other "
                               "statuses or tokens than rank 0")

    def _finish(self) -> None:
        meters = {"base": self.base_be.meter.as_dict(),
                  "small": self.small_be.meter.as_dict()}
        for a in [x for x in self.active if x.state.phase == "done"]:
            req = a.req
            req.result = self.controller.result(a.state, meters=meters)
            req.status = STATUS_OK
            req.finished_at = time.perf_counter()
            n_out = len(req.result.thinking_ids) + len(req.result.answer_ids)
            # the service estimate is admission -> finish (execution, not
            # e2e): feasibility shedding compares a queued request's
            # remaining budget with it, and queue wait in it would feed
            # back on itself under overload
            service = req.finished_at - req.admitted_at \
                if req.admitted_at is not None else req.e2e_latency
            self.res.observe_finish(req.ttft, req.tpot(n_out), service)
            if self.tracer is not None:
                self.tracer.instant(request_track(req.request_id), "done",
                                    {"status": STATUS_OK, "tokens": n_out,
                                     "steps": len(a.state.steps)},
                                    t=req.finished_at)
            if self.metrics is not None:
                mt = self.metrics
                mt.requests.inc(status=STATUS_OK)
                mt.output_tokens.inc(n_out)
                if req.ttft is not None:
                    mt.ttft.observe(req.ttft)
                tpot = req.tpot(n_out)
                if tpot is not None:
                    mt.tpot.observe(tpot)
            self.done.append(req)
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
                if self.tracer is not None:
                    self.tracer.instant(
                        request_track(a.req.request_id), "accept",
                        {"utility": round(utility, 4),
                         "tokens": len(a.body)})
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
        if self.tracer is not None:
            self.tracer.instant(request_track(a.req.request_id), "reject",
                                {"utility": round(utility, 4),
                                 "tokens": len(a.body)})

    def _base_decode_batch(self, fall: List[_Active], ans: List[_Active],
                           tc: TickConfig) -> None:
        """The tick's base-model decode: fallback regenerations (stop at
        step boundaries) and final answers (stop at eos) in one call with
        per-row stop sets and budgets, or in spec mode through batched
        token-level speculative decoding at the rung's gamma.  Quarantined
        rows (retrying after a fault) always take the plain path, and the
        ladder can turn the spec path off for every row: greedy tokens
        are the same either way."""
        ctrl, cfg = self.controller, self.controller.cfg
        fall = [a for a in fall if a.alive]
        ans = [a for a in ans if a.alive]
        acts = fall + ans
        if not acts:
            return
        tr, mt = self.tracer, self.metrics
        t_dec0 = time.perf_counter() if tr is not None else 0.0
        budgets = [ctrl.max_step_tokens(a.state) for a in fall] \
            + [cfg.answer_max_tokens] * len(ans)
        stops = [ctrl.segmenter.stop_ids] * len(fall) + [[tk.EOS]] * len(ans)
        outs: List[Optional[List[int]]] = [None] * len(acts)

        use_spec = self.spec_be is not None and tc.spec_decode
        spec_idx = [i for i, a in enumerate(acts)
                    if use_spec and not a.req.quarantined]
        if spec_idx:
            sub = [acts[i] for i in spec_idx]
            items = [SpecRow(a.base_row, a.small_row, budgets[i], stops[i],
                             a.state.generator)
                     for i, a in zip(spec_idx, sub)]
            on_round = None
            if tr is not None or mt is not None:
                # one span a judged row a round on its request's track,
                # one accepted-length observation a row a round
                def on_round(rnd, rt0, rt1, infos, _sub=sub):
                    for j, proposed, accepted in infos:
                        if tr is not None:
                            tr.span(request_track(_sub[j].req.request_id),
                                    "spec_round", rt0, rt1,
                                    {"round": rnd, "proposed": proposed,
                                     "accepted": accepted})
                        if mt is not None:
                            mt.accepted_length.observe(accepted)
                            mt.spec_rounds.inc()
            s_outs, round_stats = self.spec_be.decode_rows(
                items, cfg.sampling, _SchedulerLedger(self, sub),
                gamma=tc.gamma, on_round=on_round)
            for i, ids, st in zip(spec_idx, s_outs, round_stats):
                if acts[i].alive:
                    outs[i] = ids
                    acts[i].state.spec_stats.merge(st)
                    self._settle(acts[i], "base")
                    self._settle(acts[i], "small")
        spec_set = set(spec_idx)
        rest = [i for i in range(len(acts)) if i not in spec_set]
        if rest:
            for i in rest:
                self._reserve(acts[i], "base",
                              int(self.base_be.pos[acts[i].base_row])
                              + budgets[i])
            plain = [i for i in rest if acts[i].alive]
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
        if tr is not None:
            t_dec1 = time.perf_counter()
            for a in fall:
                tr.span(request_track(a.req.request_id), "fallback",
                        t_dec0, t_dec1)
            for a in ans:
                tr.span(request_track(a.req.request_id), "answer",
                        t_dec0, t_dec1)

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
        tr = self.tracer
        t0 = time.perf_counter() if tr is not None else 0.0
        self.base_be.extend_rows([a.base_row for a in items],
                                 [a.pending_base for a in items])
        if tr is not None:
            t1 = time.perf_counter()
            for a in items:
                tr.span(request_track(a.req.request_id), "close", t0, t1,
                        {"tokens": len(a.pending_base)})
        for a in items:
            a.pending_base = []

    # ------------------------------------------------------------- stats
    def store_bytes(self):
        """Real bytes of each engine's page store (fp32 pages: twice the
        KVManager's 2-byte accounting of the same blocks, plus the
        store's scratch page)."""
        return {w: be.store.nbytes for w, be in self.engines.items()}

    def resilience_stats(self) -> Dict[str, object]:
        """The run's failure-lifecycle and overload-control counters (the
        serve CLI's ``[resilience]`` line)."""
        out: Dict[str, object] = {
            "timeouts": self.timeouts,
            "shed": self.shed_requests,
            "quarantines": self.quarantines,
            "retries": self.retries,
            "failed": self.failures,
            "preemptions": self.preemptions,
            "stalled_ticks": self.stalled_ticks,
            "audit_violations": self.audit_violations,
        }
        out.update(self.res.as_dict())
        if self.faults is not None:
            out["faults"] = self.faults.as_dict()
        return out

    def pool_utilization(self) -> Dict[str, float]:
        """Fraction of each engine's block pool claimed (live sequences,
        snapshots and cached prefixes)."""
        return {w: p.num_used / p.num_blocks for w, p in self.pools.items()}

    def cache_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-engine prefix-cache counters (empty with the cache off)."""
        if self.caches is None:
            return {}
        return {w: c.stats.as_dict() for w, c in self.caches.items()}

    def clear_prefix_cache(self) -> int:
        """Drop every idle cached prefix (entries adopted by live rows
        survive); returns the blocks freed.  After a drain the pools are
        then empty: the cache's references were the last ones."""
        if self.caches is None:
            return 0
        return sum(c.clear() for c in self.caches.values())
