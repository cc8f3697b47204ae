"""Workload driving for the serve CLI: Poisson (or burst) arrivals pumped
through the continuous scheduler, plus summary statistics (req/s, tok/s,
latency, TTFT and TPOT percentiles, spec-decode acceptance).

The port of the JAX package's ``serving/workload.py`` (its best-of-N
expansion, majority vote and template families wait for the prefix
cache, ROADMAP queue 1, item 4).  Requests carry ``torch.Generator``s in
place of PRNG keys.
"""

from __future__ import annotations

import random
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..data.tasks import Task
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
                 arrivals: Sequence[float]) -> List[Request]:
    """Submit ``pairs`` at their arrival offsets and tick ``sched`` until
    every request is terminal.  Returns the handles in submission order;
    a queue that stays admission-blocked with nothing in flight raises
    with the head requests' reasons."""
    assert len(pairs) == len(arrivals)
    t0 = time.perf_counter()
    handles: List[Request] = []
    i = 0
    while True:
        now = time.perf_counter() - t0
        while i < len(pairs) and arrivals[i] <= now:
            task, gen = pairs[i]
            handles.append(sched.submit(task, generator=gen))
            i += 1
        if i >= len(pairs) and all(h.terminal for h in handles):
            return handles
        done_before = len(sched.done)
        sched.tick()
        if sched.active or len(sched.done) > done_before:
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


def percentile(sorted_vals: List[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(int(round(p * (len(sorted_vals) - 1))), len(sorted_vals) - 1)
    return sorted_vals[idx]


def summarize(handles: Sequence[Request], wall_s: float) -> Dict[str, float]:
    """Aggregate one workload run: throughput (req/s, tok/s), end-to-end
    latency percentiles, TTFT / TPOT / prefill-stall percentiles, and
    spec-decode acceptance when the run used it.  Latency aggregates
    cover the completed (status ok) requests."""
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
    # failure outcomes and goodput, as the JAX package reports them (no
    # deadline or SLO is ported, so every completion meets its SLO)
    statuses = Counter(h.status for h in handles)
    out["timeouts"] = statuses.get("timeout", 0)
    out["shed"] = statuses.get("shed", 0)
    out["failed"] = statuses.get("failed", 0)
    out["retries"] = 0
    out["slo_met"] = n
    out["goodput_req_s"] = out["req_s"]
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
    return out
