"""Deterministic fault injection + invariant audits for the continuous
scheduler: the port of the JAX package's ``serving/faults.py``.

A :class:`FaultPlan` is a seeded, fully-deterministic list of
:class:`Fault` events keyed by scheduler tick:

  ``nan_logits``    poison one request's ``last_logits`` row after the
                    tick's phase batches (simulating an engine step that
                    produced NaN/Inf): the engine's own device tensor,
                    the one the next sample reads, never a snapshot's
                    copy; the scheduler's health scan quarantines the
                    row before anything samples from it
  ``raise``         raise :class:`InjectedEngineError` from the next
                    phase batch containing the target request — BEFORE
                    the engine call mutates any state, so the rest of
                    the batch simply re-collects next tick
  ``pool_exhaust``  claim every free block of one engine's pool for
                    ``duration`` ticks (the injector's holds are part of
                    the audit's expected refcounts) — exercising
                    eviction, preemption and admission-blocking under
                    genuine transient exhaustion
  ``stall``         freeze the scheduler for ``duration`` ticks (no
                    admission, no prefill, no phases — deadline expiry
                    and audits still run), optionally sleeping
                    ``stall_s`` wall seconds per tick so wall-clock
                    deadlines genuinely expire

The injector is *passive*: the scheduler calls ``begin_tick`` /
``maybe_raise`` / ``poison`` at fixed points in its tick, so the same
plan over the same workload replays identically.  A fault whose target
is not in flight at its tick is recorded as skipped, not rescheduled —
determinism beats coverage here; the property test samples many plans.

:func:`audit_scheduler` is the paired invariant checker: it reconstructs
every pool's expected per-block refcount from all enumerable holders
(live sequences, outstanding block-table snapshots, radix-cache nodes,
injector holds) and reconciles against ``PagedKVPool.refcounts()``,
alongside block-table/length consistency, cache-node sanity and
free-list agreement.  Any divergence is a leak or a double-free the
normal test assertions (which only see pool totals after a drain) could
miss mid-flight.

The port's pools are the physical layout of the engines' KV, so the
audit also holds the port's own invariants: every table covers its
row's position (a call writes only pages reserved ahead of it), a row
past its prefill holds no page beyond its position at a tick boundary
(what a phase reserved ahead of its call was given back), and no table
holds the page store's scratch or moe shadow pages (they lie past
``pool.num_blocks`` and the pool never hands them out).  A zero-copy
radix node holds a pool reference on the very block rows adopt, so the
holders are the same enumeration as the JAX package's."""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

FAULT_KINDS = ("nan_logits", "raise", "pool_exhaust", "stall")


class InjectedEngineError(RuntimeError):
    """The exception a ``raise`` fault throws from a phase batch; carries
    the target so the scheduler's guard can quarantine exactly that row."""

    def __init__(self, request_id: str, phase: str):
        super().__init__(f"injected engine error for request {request_id} "
                         f"in {phase} batch")
        self.request_id = request_id
        self.phase = phase


class AuditViolation(AssertionError):
    """Raised by the scheduler when a per-tick audit finds divergence."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault event."""
    tick: int                      # scheduler tick (1-based) it fires at
    kind: str                      # one of FAULT_KINDS
    target: Optional[int] = None   # request submission index (row faults)
    which: str = "base"            # engine pool ("nan_logits"/"pool_exhaust")
    duration: int = 1              # ticks held ("pool_exhaust"/"stall")
    stall_s: float = 0.0           # wall seconds slept per stalled tick

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind in ("nan_logits", "raise") and self.target is None:
            raise ValueError(f"{self.kind} fault needs a target")
        if self.duration < 1:
            raise ValueError("duration must be >= 1")


@dataclasses.dataclass
class FaultPlan:
    """A deterministic fault schedule (sorted by tick)."""
    faults: List[Fault] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        self.faults = sorted(self.faults, key=lambda f: f.tick)

    @classmethod
    def random(cls, seed: int, n_faults: int, n_requests: int,
               max_tick: int = 40,
               kinds: Sequence[str] = FAULT_KINDS) -> "FaultPlan":
        """Seeded random plan: ``n_faults`` events over ticks
        ``[1, max_tick]`` targeting submission indices
        ``[0, n_requests)``.  Same seed, same plan — the chaos property
        test's sole source of randomness."""
        rng = random.Random(seed)
        faults = []
        for _ in range(n_faults):
            kind = rng.choice(list(kinds))
            faults.append(Fault(
                tick=rng.randint(1, max_tick),
                kind=kind,
                target=rng.randrange(n_requests)
                if kind in ("nan_logits", "raise") else None,
                which=rng.choice(("base", "small")),
                duration=rng.randint(1, 3)))
        return cls(faults)


class FaultInjector:
    """Replays a :class:`FaultPlan` against a ContinuousScheduler.  One
    injector drives one run; build a fresh one per run (it holds
    consumed-fault state and pool holds)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._by_tick: Dict[int, List[Fault]] = {}
        for f in plan.faults:
            self._by_tick.setdefault(f.tick, []).append(f)
        # pending row faults for the CURRENT tick only (leftovers whose
        # target never appeared are recorded skipped at the next tick)
        self._raise_pending: List[Fault] = []
        self._nan_pending: List[Fault] = []
        self._holds: List[List] = []        # [expire_tick, which, [blocks]]
        self._stall_until = 0
        self.injected: Dict[str, int] = {k: 0 for k in FAULT_KINDS}
        self.skipped = 0

    # ------------------------------------------------------------- holds
    def held_blocks(self, which: str) -> List[int]:
        """Blocks the injector currently holds in pool ``which`` — part
        of the audit's expected refcounts."""
        out: List[int] = []
        for _, w, blocks in self._holds:
            if w == which:
                out.extend(blocks)
        return out

    def holding(self, which: str) -> bool:
        return any(w == which and blocks
                   for _, w, blocks in self._holds)

    def busy(self, tick: int) -> bool:
        """True while the injector is blocking progress that a FUTURE
        tick will unblock on its own (outstanding pool holds, or an
        active stall window) — lets the workload loop tell injected
        backpressure apart from a genuine scheduler stall."""
        return bool(self._holds) or tick < self._stall_until

    def _release_expired(self, tick: int, sched) -> None:
        keep = []
        for hold in self._holds:
            expire, which, blocks = hold
            if tick >= expire:
                for b in blocks:
                    sched.pools[which].release(b)
            else:
                keep.append(hold)
        self._holds = keep

    def release_all(self, sched) -> None:
        """Drop every outstanding hold (end-of-run cleanup so drained
        pools reconcile to zero regardless of where the plan ended)."""
        for _, which, blocks in self._holds:
            for b in blocks:
                sched.pools[which].release(b)
        self._holds = []

    # -------------------------------------------------------------- tick
    def begin_tick(self, tick: int, sched) -> bool:
        """Arm this tick's faults; returns True when the tick is stalled.
        Row faults left un-consumed from the previous tick (target not in
        flight) are counted skipped."""
        self.skipped += len(self._raise_pending) + len(self._nan_pending)
        self._raise_pending = []
        self._nan_pending = []
        self._release_expired(tick, sched)
        stall_sleep = 0.0
        for f in self._by_tick.get(tick, ()):
            if f.kind == "raise":
                self._raise_pending.append(f)
            elif f.kind == "nan_logits":
                self._nan_pending.append(f)
            elif f.kind == "stall":
                self._stall_until = max(self._stall_until,
                                        tick + f.duration)
                stall_sleep = max(stall_sleep, f.stall_s)
                self.injected["stall"] += 1
            elif f.kind == "pool_exhaust":
                pool = sched.pools[f.which]
                blocks = []
                while pool.num_free:
                    blocks.append(pool.alloc())
                self._holds.append([tick + f.duration, f.which, blocks])
                self.injected["pool_exhaust"] += 1
        stalled = tick < self._stall_until
        if stalled and stall_sleep > 0:
            time.sleep(stall_sleep)
        return stalled

    # ------------------------------------------------------- row faults
    def maybe_raise(self, phase: str, reqs: Sequence) -> None:
        """Raise for the first pending ``raise`` fault whose target is in
        this phase batch (consuming the fault).  Called by the scheduler
        BEFORE the phase's engine call."""
        for f in list(self._raise_pending):
            victim = next((r for r in reqs
                           if r.arrival_idx == f.target), None)
            if victim is not None:
                self._raise_pending.remove(f)
                self.injected["raise"] += 1
                raise InjectedEngineError(victim.request_id, phase)

    def poison(self, sched) -> List[str]:
        """Write NaN into pending targets' ``last_logits`` rows (both the
        simulated engine-step corruption and the audit's smoking gun);
        returns the poisoned request ids."""
        hit = []
        for f in list(self._nan_pending):
            a = next((x for x in sched.active
                      if x.alive and x.req.arrival_idx == f.target), None)
            if a is not None:
                be = sched.base_be if f.which == "base" else sched.small_be
                row = a.base_row if f.which == "base" else a.small_row
                # in place: the engine's tensor is what the next sample
                # (and a captured graph) reads
                be.last_logits[row] = float("nan")
                self._nan_pending.remove(f)
                self.injected["nan_logits"] += 1
                hit.append(a.req.request_id)
        return hit

    def as_dict(self) -> dict:
        return {"injected": dict(self.injected), "skipped": self.skipped,
                "held_blocks": {w: len(self.held_blocks(w))
                                for w in ("base", "small")}}


# ---------------------------------------------------------------------------
# Invariant audits
# ---------------------------------------------------------------------------


def audit_scheduler(sched) -> List[str]:
    """Reconcile every pool's refcount ledger against all enumerable
    holders and check block-table + cache consistency.  Returns violation
    strings (empty = clean).  Run at a tick boundary — mid-phase the
    transient spec-draft blocks are legitimately in flux."""
    viols: List[str] = []
    for which, pool in sched.pools.items():
        exp = np.zeros(pool.num_blocks, np.int64)
        be = sched.engines[which]
        for a in sched.active:
            seq = a.base_seq if which == "base" else a.small_seq
            snap = a.b_seq_snap if which == "base" else a.s_seq_snap
            row = a.base_row if which == "base" else a.small_row
            rid = a.req.request_id
            held = list(seq.blocks) + (list(snap.blocks) if snap else [])
            outside = [b for b in held if not 0 <= b < pool.num_blocks]
            if outside:
                viols.append(f"{which}: request {rid} holds pages "
                             f"{outside} outside the pool's "
                             f"{pool.num_blocks} blocks (scratch or "
                             f"shadow pages)")
                continue
            for b in held:
                exp[b] += 1
            if pool.blocks_for_tokens(seq.length) != len(seq.blocks):
                viols.append(
                    f"{which}: request {rid} block table "
                    f"holds {len(seq.blocks)} blocks for length "
                    f"{seq.length} (expected "
                    f"{pool.blocks_for_tokens(seq.length)})")
            pos = int(be.pos[row])
            if seq.length < pos:
                viols.append(f"{which}: request {rid} table covers "
                             f"{seq.length} tokens, its row sits at {pos}")
            elif seq.length > pos and a.state.phase != "prefill":
                viols.append(f"{which}: request {rid} holds pages "
                             f"reserved for {seq.length - pos} tokens past "
                             f"its position {pos} (phase "
                             f"{a.state.phase}): a reservation was not "
                             f"given back")
        cache = sched.caches.get(which) if sched.caches else None
        if cache is not None:
            seen = set()
            for node in cache.iter_nodes():
                exp[node.block] += 1
                if node.block in seen:
                    viols.append(f"{which}: cache holds block "
                                 f"{node.block} in two nodes")
                seen.add(node.block)
                if pool.refcount(node.block) < 1:
                    viols.append(f"{which}: cached block {node.block} "
                                 f"has pool refcount 0")
            if len(seen) != cache.cached_blocks:
                viols.append(f"{which}: cache node count "
                             f"{cache.cached_blocks} != walked {len(seen)}")
        if getattr(sched, "faults", None) is not None:
            for b in sched.faults.held_blocks(which):
                exp[b] += 1
        ref = pool.refcounts().astype(np.int64)
        bad = np.nonzero(ref != exp)[0]
        for b in bad[:8]:
            viols.append(f"{which}: block {int(b)} refcount "
                         f"{int(ref[b])} != expected {int(exp[b])}")
        if len(bad) > 8:
            viols.append(f"{which}: ... and {len(bad) - 8} more "
                         f"refcount mismatches")
        n_zero = int((ref == 0).sum())
        if pool.num_free != n_zero:
            viols.append(f"{which}: free list holds {pool.num_free} "
                         f"blocks but {n_zero} have refcount 0")
    return viols
