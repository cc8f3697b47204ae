"""Serving CLI of the port: serve reasoning requests through SpecReason
(or a baseline) on the testbed pair, printing per-request latency and
answers and a summary.

  PYTHONPATH=src python -m repro_torch.launch.serve --scheme specreason \\
      -n 3 --budget 128 --ckpt-dir exp/ckpt --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --scheduler continuous \\
      --batch 4 -n 8 --kv-budget-mb 64 [--spec-decode] \\
      --ckpt-dir exp/ckpt --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --scheduler continuous \\
      --num-samples 4 --vote -n 4 --ckpt-dir exp/ckpt --device cuda

The pair is read from ``--ckpt-dir`` (``testbed-base.npz``,
``testbed-small.npz``); a missing checkpoint is first trained there for
500 steps on ``--device`` (``serving/loader.py``).  Request i samples
from a ``torch.Generator`` seeded with ``1000 * seed + i``.

``--scheduler sequential`` (the default) serves one request at a time,
schemes base, small, specdecode, specreason and specreason+decode.
``--decode-loop`` picks the decode loop of both schedulers: ``fused``
(the default: chunks of tokens replayed as CUDA graphs on the card,
their body run eagerly on the CPU; ``serving/engine.py`` for the
sequential engines, ``serving/batch_engine.py`` for the continuous
scheduler's batched rows) or ``eager`` (the per-token loop).
``--scheduler continuous`` serves the specreason scheme through the
continuous-batching scheduler over paged KV (``--batch`` rows,
``--kv-budget-mb`` for the static KV partition, chunked admission
prefill, ``--spec-decode --gamma`` for hierarchical speculation,
``--arrival-rate`` for Poisson arrivals, ``--verbose`` for scheduler
events).  Its radix prefix cache over the paged pools is on by default
(``--no-prefix-cache`` turns it off): prompts sharing a block-aligned
prefix prefill only their suffix, the rest read from shared cached
blocks; each request line shows ``cache[hit=H/P]``.  ``--num-samples N
--vote`` serves every prompt N times (best-of-N self-consistency; the
N-1 repeated prefills are cache hits) and majority-votes the answers,
printing a ``[vote]`` line a task.  ``--tp N`` (continuous only)
serves with exact tensor parallelism over N rank processes
(``serving/tp.py``): spawned, a card each where the host has N cards,
else sharing the card (gloo), or on the CPU; every rank loads the pair
on the host and puts its shard on its device, and rank 0 prints the
same lines as ``--tp 1`` plus a ``[tp]`` line.  Under ``--tp`` the rows run the per-token loop
(``--decode-loop eager``, the default there; ``fused`` is refused).

Overload and faults (continuous scheduler, as the JAX CLI):
``--deadline S`` gives every request a wall-clock deadline (expired
requests are cancelled queued or mid-flight, status ``timeout``),
``--slo-tpot S`` a per-output-token SLO (the overload controller's
strain signal and the goodput count), ``--shed-policy priority`` sheds
queued requests that cannot meet their deadline or overflow the queue,
``--degrade`` turns on the degradation ladder (gamma halved, spec
decode off, a smaller prefill budget, no cache insertion, stepping
back up with hysteresis), ``--inject-faults SEED[:N]`` runs N seeded
faults (default 4: NaN logits, a raised engine call, pool exhaustion,
stalled ticks; faulted requests are quarantined and retried once
without speculation) and ``--audit`` reconciles the pools' refcounts
every tick.  The ``[resilience]`` line and each request's ``status=``
report the outcome.  ``--trace OUT.json`` records the per-request and
per-tick span timeline and the engines' call brackets into a ring of
``--trace-buffer`` events and writes it as Chrome trace-event JSON;
``--metrics-out OUT.prom`` writes the Prometheus-style exposition.
Both are written atomically after the run, also when it fails or is
interrupted with Ctrl-C.
The reference's ``--admin-port``, ``--admin-linger``,
``--snapshot-every``, ``--monitor-window`` and ``--xla-profile-dir``
are accepted and raise ``NotImplementedError``: ROADMAP queue 1, item 6
(monitors, admin and device plane).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import random
import time
from typing import List, Optional, Tuple

import torch

from .. import device as devices
from ..core.baselines import spec_decode_reason, vanilla_reason
from ..core.controller import SpecReason, SpecReasonConfig, SpecReasonResult
from ..core.policies import StaticThreshold
from ..data import tasks
from ..data.evaluate import is_correct
from ..sampling.sample import SamplingParams
from ..serving.engine import Engine
from ..serving.faults import FaultInjector, FaultPlan
from ..serving.kv_manager import KVBudget, KVManager
from ..serving.loader import (decode_loops, ensure_testbed,
                              load_testbed_engines)
from ..serving.resilience import ResilienceConfig
from ..serving.scheduler import LIVE_PLANE_ITEM, ContinuousScheduler
from ..serving.telemetry import ServingMetrics, Tracer, atomic_write
from ..serving.tp import TPContext, run_ranks
from ..serving.workload import (expand_best_of_n, majority_vote,
                                poisson_arrivals, run_workload, summarize)
from ..tokenizer import toy as tk

SCHEMES = ("base", "small", "specdecode", "specreason", "specreason+decode")

# the reference CLI's flags this slice leaves out: the live plane
NOT_PORTED = {
    "admin_port": "--admin-port",
    "admin_linger": "--admin-linger",
    "snapshot_every": "--snapshot-every",
    "monitor_window": "--monitor-window",
    "xla_profile_dir": "--xla-profile-dir",
}
# seeded fault plans target ticks 1..8, as the JAX CLI's
FAULT_MAX_TICK = 8


def run_scheme(scheme: str, base: Engine, small: Engine, task,
               generator: torch.Generator, budget: int, threshold: float,
               temperature: float, fused: Optional[bool] = None
               ) -> SpecReasonResult:
    """One request of ``scheme``; ``fused`` picks every generate call's
    decode loop (None: each engine's default)."""
    prompt = tasks.question_tokens(task)
    sp = SamplingParams(temperature=temperature)
    if scheme == "base":
        return vanilla_reason(base, prompt, generator, budget, sp,
                              fused=fused)
    if scheme == "small":
        return vanilla_reason(small, prompt, generator, budget, sp,
                              fused=fused)
    if scheme == "specdecode":
        return spec_decode_reason(base, small, prompt, generator, budget, sp,
                                  fused=fused)
    cfg = SpecReasonConfig(policy=StaticThreshold(threshold),
                           token_budget=budget, sampling=sp,
                           use_spec_decode=(scheme == "specreason+decode"),
                           fused_decode=fused)
    return SpecReason(base, small, cfg).run(prompt, generator)


def _meter_line(name: str, m: dict) -> str:
    dt, dc = m["decode_tokens"], m["decode_calls"]
    tok_s = dt / m["decode_time"] if m["decode_time"] else 0.0
    line = (f"    {name}: decode {dt} tok / {dc} calls ({tok_s:.0f} tok/s), "
            f"prefill {m['prefill_tokens']} tok / {m['prefill_calls']} "
            "calls")
    if m.get("spec_rounds"):
        line += (f", spec {m['spec_accepted']}/{m['spec_proposed']} "
                 f"accepted over {m['spec_rounds']} rounds")
    if m.get("cache_lookup_tokens"):
        line += (f", cache {m['cache_hit_tokens']}"
                 f"/{m['cache_lookup_tokens']} prompt tok "
                 f"({m.get('cache_evictions', 0)} evictions)")
    return line


def _spec_suffix(res: SpecReasonResult) -> str:
    """Per-request acceptance breakdown for hierarchical runs."""
    s = res.spec_stats
    if not s.rounds:
        return ""
    return (f" spec[acc={s.acceptance_rate:.2f} "
            f"len={s.mean_accepted_len:.1f}/{s.rounds}r]")


def _cache_suffix(h) -> str:
    """Per-request prefix-cache note: cached / all prompt tokens."""
    if not h.prompt_tokens:
        return ""
    return f" cache[hit={h.cache_hit_tokens}/{h.prompt_tokens}]"


@dataclasses.dataclass
class ServeReport:
    """What a run served: the engines, the decode loop and, per request,
    (scheme, request index, task, result); a continuous run also keeps
    its scheduler, the request handles, the summary and, with ``--vote``,
    the votes.  A ``--tp`` run keeps rank 0's runs and summary only (the
    engines lived in the rank processes)."""
    base: Optional[Engine]
    small: Optional[Engine]
    runs: List[Tuple[str, int, tasks.Task, SpecReasonResult]]
    decode_loop: str = "fused"
    sched: Optional[ContinuousScheduler] = None
    handles: Optional[list] = None
    stats: Optional[dict] = None
    votes: Optional[list] = None


def continuous_scheduler(args, base: Engine, small: Engine,
                         tp: Optional[TPContext] = None
                         ) -> ContinuousScheduler:
    """The continuous scheduler that ``args`` (``parse_args``) describe,
    over the pair (on rank ``tp.rank``'s shard under tp)."""
    cfg = SpecReasonConfig(policy=StaticThreshold(args.threshold),
                           token_budget=args.budget,
                           sampling=SamplingParams(
                               temperature=args.temperature),
                           use_spec_decode=args.spec_decode,
                           spec_gamma=args.gamma,
                           fused_decode=args.decode_loop == "fused")
    ctrl = SpecReason(base, small, cfg)
    kv = KVManager(base.model.cfg, small.model.cfg,
                   KVBudget(total_bytes=int(args.kv_budget_mb * (1 << 20))))
    lead = tp is None or tp.rank == 0
    injector = None
    if args.inject_faults:
        seed, _, nf = args.inject_faults.partition(":")
        injector = FaultInjector(FaultPlan.random(
            seed=int(seed), n_faults=int(nf) if nf else 4,
            n_requests=args.num_requests * args.num_samples,
            max_tick=FAULT_MAX_TICK))
    return ContinuousScheduler(
        ctrl, kv, max_batch=args.batch,
        context_capacity=min(base.max_len, args.budget + 64),
        prefix_cache=not args.no_prefix_cache,
        chunked_prefill=args.chunked_prefill,
        max_prefill_tokens=args.max_prefill_tokens,
        on_event=(lambda e: print(f"[sched] {e}"))
        if args.verbose and lead else None,
        resilience=ResilienceConfig(slo_tpot_s=args.slo_tpot,
                                    shed_policy=args.shed_policy,
                                    degrade=args.degrade),
        faults=injector, audit=args.audit,
        # rank 0 records and writes the artifacts
        tracer=Tracer(buffer=args.trace_buffer)
        if args.trace and lead else None,
        metrics=ServingMetrics() if args.metrics_out and lead else None,
        seed=args.seed, tp=tp)


def _quiet(*_, **__) -> None:
    """The print of a rank other than 0."""


def flush_artifacts(args, sched: ContinuousScheduler) -> None:
    """Write the ``--trace`` and ``--metrics-out`` artifacts (atomic
    renames: a reader never sees a truncated file)."""
    if sched.tracer is not None:
        sched.tracer.export(args.trace)
    if sched.metrics is not None:
        atomic_write(args.metrics_out, sched.metrics.render())


def serve_continuous(args, base: Engine, small: Engine, reqs,
                     dev: torch.device,
                     tp: Optional[TPContext] = None) -> ServeReport:
    """The continuous-batching path: paged-KV admission and per-tick
    speculate / verify / fallback batching; under tp one rank's part,
    rank 0 printing."""
    say = print if tp is None or tp.rank == 0 else _quiet
    sched = continuous_scheduler(args, base, small, tp)
    say(f"[serve] decode loop: {sched.base_be.name} {args.decode_loop}, "
        f"{sched.small_be.name} {args.decode_loop}"
        + (f" (--tp {tp.tp_size}: the per-token rows loop)"
           if tp is not None else ""), flush=True)
    rng = random.Random(args.seed)
    pairs = [(t, torch.Generator(device=dev).manual_seed(1000 * args.seed
                                                         + i))
             for i, t in enumerate(reqs)]
    if args.num_samples > 1:
        # best-of-N: every prompt becomes N sampled reasoning chains whose
        # prefills share one set of cached blocks
        pairs = expand_best_of_n(pairs, args.num_samples)
    # per-request submit options: the deadline, and the best-of-N group
    # (the shed policy prefers a sibling whose group keeps survivors)
    opts = [{"deadline_s": args.deadline,
             "group": f"task{i // args.num_samples}"
             if args.num_samples > 1 else None}
            for i in range(len(pairs))]
    arrivals = poisson_arrivals(len(pairs), args.arrival_rate, rng)
    try:
        t0 = time.perf_counter()
        handles = run_workload(sched, pairs, arrivals, opts=opts)
        wall = time.perf_counter() - t0
    finally:
        # the artifacts land also when the run fails or is interrupted
        # (Ctrl-C)
        flush_artifacts(args, sched)
        if sched.tracer is not None:
            say(f"[trace] {args.trace}: {len(sched.tracer.entries())} "
                f"events ({sched.tracer.dropped} dropped)", flush=True)
        if sched.metrics is not None:
            say(f"[metrics] {args.metrics_out}", flush=True)
    tag = "hierspec" if args.spec_decode else "continuous"
    report = ServeReport(base, small, [], args.decode_loop, sched, handles)
    for i, h in enumerate(handles):
        res = h.result
        if res is None:
            # timed out, shed or failed: no output to grade
            say(f"[{tag}] req{i}: --- status={h.status} ({h.error})",
                flush=True)
            continue
        ok = is_correct(h.task, res.answer_ids)
        report.runs.append((tag, i, h.task, res))
        say(f"[{tag}] req{i}: {'OK ' if ok else 'BAD'} "
            f"status={h.status} "
            f"lat={h.e2e_latency:.2f}s think={res.n_thinking_tokens}"
            f"{_spec_suffix(res)}{_cache_suffix(h)} "
            f"answer={tk.detok(res.answer_ids)}", flush=True)
        if args.meters:
            for name, m in res.meters.items():
                say(_meter_line(name, m))
    stats = summarize(handles, wall, slo_tpot_s=args.slo_tpot)
    graded = [h for h in handles if h.result is not None]
    accuracy = sum(is_correct(h.task, h.result.answer_ids)
                   for h in graded) / max(len(graded), 1)
    if args.vote:
        report.votes = majority_vote(handles, args.num_samples)
        for i, v in enumerate(report.votes):
            ok = is_correct(v.task, v.winner_ids)
            breakdown = ", ".join(
                f"{tk.detok(list(a))}x{c}"
                for a, c in sorted(v.counts.items(), key=lambda kv: -kv[1]))
            say(f"[vote] task{i}: {'OK ' if ok else 'BAD'} "
                f"agree={v.agreement:.2f} [{breakdown}] "
                f"-> {tk.detok(v.winner_ids)}", flush=True)
        accuracy = sum(is_correct(v.task, v.winner_ids)
                       for v in report.votes) / max(len(report.votes), 1)
    stats.update({
        "scheduler": "continuous", "device": str(dev), "batch": args.batch,
        "decode_loop": args.decode_loop,
        "spec_decode": args.spec_decode, "gamma": args.gamma,
        "arrival_rate": args.arrival_rate, "ticks": sched.ticks,
        "preemptions": sched.preemptions,
        "prefix_cache": not args.no_prefix_cache,
        "chunked_prefill": args.chunked_prefill,
        "max_prefill_tokens": args.max_prefill_tokens,
        "prefill_chunks": sched.prefill_chunks,
        "num_samples": args.num_samples, "vote": args.vote,
        "accuracy": accuracy,
        "kv_store_bytes": sched.store_bytes(),
        "kv_accounted_bytes": {
            w: p.num_blocks * sched.kv.block_bytes(w)
            for w, p in sched.pools.items()},
        "tp": 1 if tp is None else tp.tp_size,
    })
    if tp is not None:
        stats.update(tp_backend=tp.backend, tp_gathers=tp.gathers,
                     tp_gather_s=tp.gather_s)
        say(tp_line(tp, sched), flush=True)
    if "p95_ttft_s" in stats:
        say(f"[latency] ttft p50={stats['p50_ttft_s']:.3f}s "
            f"p95={stats['p95_ttft_s']:.3f}s | tpot "
            f"p50={stats.get('p50_tpot_s', 0.0) * 1e3:.1f}ms "
            f"p95={stats.get('p95_tpot_s', 0.0) * 1e3:.1f}ms | "
            f"prefill stall "
            f"mean={stats.get('mean_prefill_stall_s', 0.0):.3f}s "
            f"p95={stats.get('p95_prefill_stall_s', 0.0):.3f}s")
    rs = sched.resilience_stats()
    say(f"[resilience] goodput={stats['goodput_req_s']:.3f} req/s "
        f"(slo_met={stats['slo_met']}/{len(handles)}) | "
        f"timeout={rs['timeouts']} shed={rs['shed']} "
        f"failed={rs['failed']} | quarantines={rs['quarantines']} "
        f"retries={rs['retries']} stalled_ticks={rs['stalled_ticks']} | "
        f"degrade_level={rs['level']} pressure={rs['pressure']:.2f} "
        f"audit_violations={rs['audit_violations']}", flush=True)
    stats.update({f"resilience_{k}": v for k, v in rs.items()
                  if k in ("timeouts", "shed", "failed", "quarantines",
                           "retries", "stalled_ticks", "level",
                           "audit_violations")})
    say(json.dumps(stats), flush=True)
    report.stats = stats
    return report


def tp_line(tp: TPContext, sched: ContinuousScheduler) -> str:
    """The ``[tp]`` line: backend, devices, each engine's local heads and
    gathers a forward, and the gathers' host time so far."""
    heads = ", ".join(
        f"{be.name} {be.model.cfg.n_heads // tp.tp_size} query over "
        f"{be.model.cfg.n_kv_heads // tp.tp_size} kv heads, "
        f"{2 * be.model.cfg.n_layers} gathers a step"
        for be in (sched.base_be, sched.small_be))
    return (f"[tp] {tp.tp_size} ranks, backend {tp.backend}, devices "
            f"{list(tp.devices)}; per rank: {heads}; {tp.gathers} gathers "
            f"on rank {tp.rank} in {tp.gather_s:.3f} s")


def _serve_rank(tp: TPContext, args) -> Optional[tuple]:
    """One rank of ``--tp``: load the pair on the host, serve the
    continuous workload with the rank's shards on its device (the batch
    engines move only their shards there); rank 0 returns (runs,
    stats)."""
    base, small = load_testbed_engines(args.ckpt_dir, "cpu")
    rng = random.Random(args.seed)
    reqs = [tasks.sample_task(rng) for _ in range(args.num_requests)]
    report = serve_continuous(args, base, small, reqs, tp.device, tp)
    return (report.runs, report.stats) if tp.rank == 0 else None


def serve_tp(args, dev: torch.device) -> ServeReport:
    """``--tp N``: the continuous path in N rank processes (the pair is
    trained first where it is missing, once, on ``dev``)."""
    ensure_testbed(args.ckpt_dir, dev)
    threads = max(1, torch.get_num_threads() // args.tp) \
        if dev.type == "cpu" else None
    runs, stats = run_ranks(args.tp, str(dev), _serve_rank, (args,),
                            threads=threads)[0]
    return ServeReport(None, None, runs, args.decode_loop, stats=stats)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """The CLI's flags, checked (a flag the port does not take raises)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--scheme", choices=SCHEMES, default="specreason")
    ap.add_argument("-n", "--num-requests", type=int, default=8)
    ap.add_argument("--budget", type=int, default=160)
    ap.add_argument("--threshold", type=float, default=7.0)
    ap.add_argument("--temperature", type=float, default=0.6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="exp/ckpt")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--meters", action="store_true",
                    help="print the per-engine meter breakdown per request")
    ap.add_argument("--decode-loop", choices=("fused", "eager"),
                    default=None,
                    help="fused (the default without --tp) = chunks of "
                         "tokens a CUDA graph replay on the card (the body "
                         "runs eagerly on the CPU), eager (the default and "
                         "the only loop with --tp) = the per-token loop; "
                         "for the sequential engines and the continuous "
                         "scheduler's rows")
    ap.add_argument("--scheduler", choices=("sequential", "continuous"),
                    default="sequential",
                    help="sequential = one request start-to-finish; "
                         "continuous = step-interleaved continuous batching "
                         "over paged KV")
    ap.add_argument("--batch", type=int, default=8,
                    help="continuous scheduler: max concurrent rows")
    ap.add_argument("--tp", type=int, default=1, metavar="N",
                    help="continuous scheduler: exact tensor parallelism "
                         "over N rank processes (a card each where the "
                         "host has N, else sharing one over gloo, or the "
                         "CPU); N must divide both models' heads, kv heads "
                         "and ffn hidden; outputs are --tp 1's")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson arrival rate in req/s (0 = burst at t=0)")
    ap.add_argument("--kv-budget-mb", type=float, default=64,
                    help="continuous scheduler: device-memory budget of the "
                         "static base/small KV partition (accounted at 2 "
                         "bytes an element)")
    ap.add_argument("--spec-decode", action="store_true",
                    help="continuous scheduler: hierarchical speculation, "
                         "batched token-level spec decode for fallback "
                         "regenerations and final answers (§4.2)")
    ap.add_argument("--gamma", type=int, default=4,
                    help="spec decode: draft tokens per verification round")
    ap.add_argument("--num-samples", type=int, default=1,
                    help="best-of-N / self-consistency: sample N "
                         "reasoning chains per prompt (continuous "
                         "scheduler; the prefix cache makes the N-1 "
                         "extra prefills cache hits)")
    ap.add_argument("--vote", action="store_true",
                    help="majority-vote the N sampled answers per prompt "
                         "(accuracy is then per task, over the voted "
                         "answers)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="continuous scheduler: serve without the radix "
                         "prefix cache over the paged KV pools")
    ap.add_argument("--chunked-prefill", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="continuous scheduler: chunk admission prefill to "
                         "--max-prefill-tokens prompt tokens per tick")
    ap.add_argument("--max-prefill-tokens", type=int, default=64,
                    help="chunked prefill: per-tick prompt-prefill budget")
    ap.add_argument("--verbose", action="store_true",
                    help="log admission / chunk-progress / preemption "
                         "events (continuous scheduler)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="continuous scheduler: per-request deadline in "
                         "seconds from submission; a request still "
                         "unfinished is cancelled with status 'timeout' "
                         "and its KV pages reclaimed")
    ap.add_argument("--slo-tpot", type=float, default=None,
                    help="per-output-token latency SLO in seconds: the "
                         "overload controller's strain signal and the "
                         "goodput count")
    ap.add_argument("--shed-policy", choices=("none", "priority"),
                    default="none",
                    help="'priority' sheds queued requests that cannot "
                         "meet their deadline or overflow the queue "
                         "(lowest priority first, best-of-N siblings with "
                         "surviving group members preferred)")
    ap.add_argument("--degrade", action="store_true",
                    help="the degradation ladder: under sustained pressure "
                         "gamma halved -> token-level spec off -> smaller "
                         "prefill chunks -> no cache insertion, and back "
                         "up with hysteresis")
    ap.add_argument("--inject-faults", default=None, metavar="SEED[:N]",
                    help="inject N (default 4) seeded faults (NaN logits, "
                         "a raised engine call, pool exhaustion, stalled "
                         "ticks); faulted requests are quarantined and "
                         "retried once without speculation")
    ap.add_argument("--audit", action="store_true",
                    help="reconcile the pools' refcounts, the block tables "
                         "and the radix caches every tick; a violation "
                         "raises")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="continuous scheduler: record the per-request / "
                         "per-tick span timeline and write it as Chrome "
                         "trace-event JSON")
    ap.add_argument("--metrics-out", default=None, metavar="OUT.prom",
                    help="continuous scheduler: write the Prometheus-style "
                         "exposition of the serving metrics")
    ap.add_argument("--trace-buffer", type=int, default=65536,
                    help="tracer ring capacity in events (the oldest are "
                         "dropped beyond it)")
    # the reference's live-plane flags: accepted, then refused
    ap.add_argument("--admin-port", type=int, default=None)
    ap.add_argument("--admin-linger", type=float, default=0.0)
    ap.add_argument("--snapshot-every", type=float, default=None)
    ap.add_argument("--monitor-window", type=int, default=64)
    ap.add_argument("--xla-profile-dir", default=None)
    args = ap.parse_args(argv)
    for dest, flag in NOT_PORTED.items():
        if getattr(args, dest) != ap.get_default(dest):
            raise NotImplementedError(
                f"{flag} is not ported yet ({LIVE_PLANE_ITEM})")
    if args.tp < 1:
        ap.error("--tp must be >= 1")
    if args.tp > 1 and args.scheduler != "continuous":
        ap.error("--tp rides on the continuous scheduler (the sharded "
                 "BatchEngine pair); add --scheduler continuous")
    if args.tp > 1 and args.decode_loop == "fused":
        ap.error("--tp runs the per-token rows loop: the ranks' gloo "
                 "all-gathers cannot be captured in a CUDA graph; drop "
                 "--decode-loop fused")
    if args.decode_loop is None:
        args.decode_loop = "eager" if args.tp > 1 else "fused"
    if args.scheduler == "continuous":
        if args.scheme != "specreason":
            ap.error("--scheduler continuous serves the specreason scheme "
                     "only")
    elif args.spec_decode:
        ap.error("--spec-decode rides on the continuous scheduler; the "
                 "sequential regime has the specreason+decode scheme")
    if args.num_samples < 1:
        ap.error("--num-samples must be >= 1")
    if args.num_samples > 1 and args.scheduler != "continuous":
        ap.error("--num-samples rides on the continuous scheduler (the "
                 "prefix cache that makes best-of-N cheap lives there); "
                 "add --scheduler continuous")
    if args.vote and args.num_samples < 2:
        ap.error("--vote needs --num-samples >= 2")
    if args.max_prefill_tokens < 1:
        ap.error("--max-prefill-tokens must be >= 1")
    if args.trace_buffer < 1:
        ap.error("--trace-buffer must be >= 1")
    continuous_only = [f for f, on in (
        ("--deadline", args.deadline is not None),
        ("--slo-tpot", args.slo_tpot is not None),
        ("--shed-policy", args.shed_policy != "none"),
        ("--degrade", args.degrade), ("--inject-faults", args.inject_faults),
        ("--audit", args.audit), ("--trace", args.trace),
        ("--metrics-out", args.metrics_out)) if on]
    if continuous_only and args.scheduler != "continuous":
        ap.error(f"{', '.join(continuous_only)} ride on the continuous "
                 "scheduler; add --scheduler continuous")
    return args


def main(argv: Optional[List[str]] = None) -> ServeReport:
    args = parse_args(argv)
    dev = devices.resolve(args.device)
    if args.tp > 1:
        return serve_tp(args, dev)
    base, small = load_testbed_engines(args.ckpt_dir, dev)
    rng = random.Random(args.seed)
    reqs = [tasks.sample_task(rng) for _ in range(args.num_requests)]
    if args.scheduler == "continuous":
        return serve_continuous(args, base, small, reqs, dev)
    scheme = args.scheme
    fused = args.decode_loop == "fused"
    print(f"[serve] decode loop: {base.name} {args.decode_loop}, "
          f"{small.name} {args.decode_loop} (engine defaults: "
          f"{decode_loops(base, small)})", flush=True)

    report = ServeReport(base, small, [], args.decode_loop)
    lat, acc, think, out_tokens = [], [], [], 0
    for i, task in enumerate(reqs):
        gen = torch.Generator(device=dev).manual_seed(1000 * args.seed + i)
        res = run_scheme(scheme, base, small, task, gen, args.budget,
                         args.threshold, args.temperature, fused=fused)
        ok = is_correct(task, res.answer_ids)
        report.runs.append((scheme, i, task, res))
        lat.append(res.wall_time)
        acc.append(ok)
        think.append(res.n_thinking_tokens)
        out_tokens += res.n_thinking_tokens + len(res.answer_ids)
        print(f"[{scheme}] req{i}: {'OK ' if ok else 'BAD'} "
              f"{res.wall_time:.3f}s think={res.n_thinking_tokens} "
              f"steps={len(res.steps)}{_spec_suffix(res)} "
              f"answer={tk.detok(res.answer_ids)}", flush=True)
        if args.meters:
            for name, m in res.meters.items():
                print(_meter_line(name, m))
    print(json.dumps({
        "scheme": scheme, "device": str(dev),
        "decode_loop": args.decode_loop,
        "mean_latency_s": sum(lat) / len(lat),
        "output_tokens_per_s": out_tokens / sum(lat),
        "accuracy": sum(acc) / len(acc),
        "mean_thinking_tokens": sum(think) / len(think),
    }), flush=True)
    return report


if __name__ == "__main__":
    main()
