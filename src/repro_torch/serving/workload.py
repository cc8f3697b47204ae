"""Workload driving for the serve CLI: Poisson (or burst) arrivals pumped
through the continuous scheduler, plus summary statistics (req/s, tok/s,
latency, TTFT and TPOT percentiles, spec-decode acceptance).

The port of the JAX package's ``serving/workload.py``, with best-of-N
expansion, the majority vote and prompt-template task families.
Requests carry ``torch.Generator``s in place of PRNG keys: a best-of-N
sample's generator is seeded from its task generator's seed and the
sample index (``sample_seed``), where the JAX package folds the index
into the task's key.
"""

from __future__ import annotations

import dataclasses
import random
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..data.tasks import Task, sample_task
from .scheduler import ContinuousScheduler, Request


def poisson_arrivals(n: int, rate: float, rng: random.Random) -> List[float]:
    """Cumulative arrival offsets (seconds).  rate <= 0 => burst at t=0."""
    if rate <= 0:
        return [0.0] * n
    t, out = 0.0, []
    for _ in range(n):
        t += rng.expovariate(rate)
        out.append(t)
    return out


def run_workload(sched: ContinuousScheduler,
                 pairs: Sequence[Tuple[Task, Optional[torch.Generator]]],
                 arrivals: Sequence[float],
                 opts: Optional[Sequence[dict]] = None) -> List[Request]:
    """Submit ``pairs`` at their arrival offsets and tick ``sched`` until
    every request is terminal (ok, timeout, shed or failed).  Returns the
    handles in submission order; a queue that stays admission-blocked
    with nothing in flight raises with the head requests' reasons (an
    injected pool hold or stall is waited out).  ``opts[i]`` are extra
    submit arguments of request i (``deadline_s``, ``priority``,
    ``group``).  Under tensor parallelism rank 0 reads the clock and
    broadcasts how many requests have arrived each tick, and the ranks'
    statuses and tokens are compared at the end."""
    assert len(pairs) == len(arrivals)
    assert opts is None or len(opts) == len(pairs)
    t0 = time.perf_counter()
    handles: List[Request] = []
    i = 0
    while True:
        now = time.perf_counter() - t0
        due = i
        while due < len(pairs) and arrivals[due] <= now:
            due += 1
        if sched.tp is not None:
            due = sched.tp.broadcast(due)
        while i < due:
            task, gen = pairs[i]
            handles.append(sched.submit(
                task, generator=gen, **(opts[i] if opts is not None else {})))
            i += 1
        if i >= len(pairs) and all(h.terminal for h in handles):
            sched.check_lockstep(handles)
            return handles
        done_before = len(sched.done)
        sched.tick()
        if sched.active or len(sched.done) > done_before:
            continue
        if sched.faults is not None and sched.faults.busy(sched.ticks):
            # injected backpressure (a pool hold, a stall window) that a
            # later tick releases on its own
            continue
        if i < len(pairs):
            # idle until the next arrival
            wait = arrivals[i] - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(min(wait, 0.05))
        elif sched.queue:
            blocked = [h.blocked_reason for h in handles
                       if not h.terminal and h.blocked_reason]
            raise RuntimeError(
                f"scheduler stalled: {blocked or 'unknown reason'}")


def sample_seed(task_seed: int, j: int) -> int:
    """The seed of best-of-N sample ``j`` of a task whose generator was
    seeded with ``task_seed``: distinct for every sample, the same on
    every run."""
    return (1000003 * task_seed + j + 1) % (1 << 63)


def expand_best_of_n(pairs: Sequence[Tuple[Task, torch.Generator]],
                     n: int) -> List[Tuple[Task, torch.Generator]]:
    """Self-consistency expansion: each (task, generator) becomes ``n``
    requests, sample ``j`` drawing from a new generator on the task
    generator's device, seeded ``sample_seed(generator.initial_seed(),
    j)``.  The ``n`` samples of one task are adjacent in the returned
    list (and so in arrival order), which lets the scheduler's
    wait-for-prefix admission turn them into one cold prefill plus n-1
    cache hits."""
    if n < 1:
        raise ValueError("best-of-N needs n >= 1")
    return [(task, torch.Generator(device=gen.device).manual_seed(
        sample_seed(gen.initial_seed(), j)))
        for task, gen in pairs for j in range(n)]


@dataclasses.dataclass
class VoteResult:
    """Majority vote over one task's N sampled answers."""
    task: Task
    samples: List[Request]
    winner_ids: List[int]              # the most-voted answer token ids
    counts: Dict[Tuple[int, ...], int]

    @property
    def n(self) -> int:
        return len(self.samples)

    @property
    def survivors(self) -> int:
        """Samples that produced an answer."""
        return sum(c for c in self.counts.values())

    @property
    def agreement(self) -> float:
        """Fraction of samples that voted for the winner (0.0 when no
        sample voted)."""
        return self.counts.get(tuple(self.winner_ids), 0) / max(self.n, 1)


def majority_vote(handles: Sequence[Request], n: int) -> List[VoteResult]:
    """Group ``expand_best_of_n``-ordered handles back into their tasks
    and majority-vote each group's answer token sequences; a tie goes to
    the earliest sample.  A sample without a result does not vote, and a
    group with no vote has an empty winner."""
    assert len(handles) % n == 0, (len(handles), n)
    out = []
    for i in range(0, len(handles), n):
        group = list(handles[i:i + n])
        answers = [tuple(h.result.answer_ids) for h in group
                   if h.result is not None]
        counts = Counter(answers)
        winner = max(answers,
                     key=lambda a: (counts[a], -answers.index(a))) \
            if answers else ()
        out.append(VoteResult(task=group[0].task, samples=group,
                              winner_ids=list(winner), counts=dict(counts)))
    return out


def template_task_family(rng: random.Random, n: int, shared_ops: int = 8,
                         extra_min: int = 1, extra_max: int = 3
                         ) -> List[Task]:
    """``n`` tasks sharing one op-chain prefix (requests that share a
    prompt template): their question tokens agree for ``5 + 4 *
    shared_ops`` tokens (``data.tasks.question_tokens``), so the prefix
    cache serves every request after the first from shared blocks."""
    proto = sample_task(rng, min_steps=shared_ops, max_steps=shared_ops)
    out = []
    for _ in range(n):
        tail = sample_task(rng, min_steps=extra_min, max_steps=extra_max)
        out.append(Task(start=proto.start, ops=proto.ops + tail.ops))
    return out


def percentile(sorted_vals: List[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(int(round(p * (len(sorted_vals) - 1))), len(sorted_vals) - 1)
    return sorted_vals[idx]


def summarize(handles: Sequence[Request], wall_s: float,
              slo_tpot_s: Optional[float] = None) -> Dict[str, float]:
    """Aggregate one workload run: throughput (req/s, tok/s), end-to-end
    latency percentiles, TTFT / TPOT / prefill-stall percentiles, and
    spec-decode acceptance when the run used it.  Latency aggregates
    cover the completed (status ok) requests; the failure counters
    (timeouts / shed / failed / retries) and ``goodput_req_s`` --
    completions that also met their own deadline and ``slo_tpot_s``
    (when given), per second -- keep a run that sheds half its load from
    claiming the throughput of the half it kept."""
    ok = [h for h in handles if h.status == "ok"]
    lats = sorted(h.e2e_latency for h in ok if h.e2e_latency is not None)
    toks = sum(len(h.result.thinking_ids) + len(h.result.answer_ids)
               for h in ok if h.result is not None)
    n = len(lats)
    out = {
        "requests": n,
        "wall_s": round(wall_s, 4),
        "req_s": round(n / wall_s, 3) if wall_s > 0 else 0.0,
        "tok_s": round(toks / wall_s, 2) if wall_s > 0 else 0.0,
        "p50_latency_s": round(percentile(lats, 0.50), 4),
        "p95_latency_s": round(percentile(lats, 0.95), 4),
        "mean_latency_s": round(sum(lats) / n, 4) if n else 0.0,
    }
    # failure outcomes and goodput: a request counts toward goodput iff
    # it completed, beat its own deadline (when it carried one) and kept
    # TPOT within ``slo_tpot_s`` (when given)
    statuses = Counter(h.status for h in handles)
    out["timeouts"] = statuses.get("timeout", 0)
    out["shed"] = statuses.get("shed", 0)
    out["failed"] = statuses.get("failed", 0)
    out["retries"] = sum(h.retries for h in handles)
    good = 0
    for h in ok:
        if h.result is None:
            continue
        if h.deadline_s is not None and (
                h.e2e_latency is None or h.e2e_latency > h.deadline_s):
            continue
        if slo_tpot_s is not None:
            tp = h.tpot(len(h.result.thinking_ids) + len(h.result.answer_ids))
            if tp is not None and tp > slo_tpot_s:
                continue
        good += 1
    out["slo_met"] = good
    out["goodput_req_s"] = round(good / wall_s, 3) if wall_s > 0 else 0.0
    ttfts = sorted(h.ttft for h in handles if h.ttft is not None)
    if ttfts:
        out["p50_ttft_s"] = round(percentile(ttfts, 0.50), 4)
        out["p95_ttft_s"] = round(percentile(ttfts, 0.95), 4)
        out["mean_ttft_s"] = round(sum(ttfts) / len(ttfts), 4)
        tpots = sorted(
            t for t in (h.tpot(len(h.result.thinking_ids)
                               + len(h.result.answer_ids))
                        for h in handles if h.result is not None)
            if t is not None)
        if tpots:
            out["p50_tpot_s"] = round(percentile(tpots, 0.50), 5)
            out["p95_tpot_s"] = round(percentile(tpots, 0.95), 5)
        stalls = sorted(h.prefill_stall_s for h in handles
                        if h.prefill_stall_s is not None)
        if stalls:
            out["mean_prefill_stall_s"] = round(
                sum(stalls) / len(stalls), 4)
            out["p95_prefill_stall_s"] = round(percentile(stalls, 0.95), 4)
    spec = [h.result.spec_stats for h in handles
            if h.result is not None and h.result.spec_stats.rounds > 0]
    if spec:
        out["spec_requests"] = len(spec)
        out["spec_acceptance_rate"] = round(
            sum(s.acceptance_rate for s in spec) / len(spec), 4)
        out["spec_mean_accepted_len"] = round(
            sum(s.mean_accepted_len for s in spec) / len(spec), 4)
    # prefix cache: the prompt-token hit rate over the requests' last
    # admissions, and the engines' evictions (monotone counters: the
    # largest of the meter snapshots the results carry)
    prompt_toks = sum(h.prompt_tokens for h in handles)
    if prompt_toks:
        hit_toks = sum(h.cache_hit_tokens for h in handles)
        out["cache_hit_tokens"] = hit_toks
        out["cache_hit_rate"] = round(hit_toks / prompt_toks, 4)
        out["cache_evictions"] = max(
            (int(sum(m.get("cache_evictions", 0)
                     for m in h.result.meters.values()))
             for h in handles if h.result is not None), default=0)
    return out
