"""Serving CLI of the port: serve reasoning requests through SpecReason
(or a baseline) on the testbed pair, printing per-request latency and
answers and a summary.

  PYTHONPATH=src python -m repro_torch.launch.serve --scheme specreason \\
      -n 3 --budget 128 --ckpt-dir exp/ckpt --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --scheduler continuous \\
      --no-prefix-cache --batch 4 -n 8 --kv-budget-mb 64 [--spec-decode] \\
      --ckpt-dir exp/ckpt --device cuda

The pair is read from ``--ckpt-dir`` (``testbed-base.npz``,
``testbed-small.npz``); the port cannot train, so a missing checkpoint is
an error.  Request i samples from a ``torch.Generator`` seeded with
``1000 * seed + i``.

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
events).  The reference's prefix cache is its default; here it is not
ported, so the continuous scheduler needs ``--no-prefix-cache``.  The
reference's ``--num-samples``, ``--vote``, ``--tp``, ``--deadline``,
``--slo-tpot``, ``--shed-policy``, ``--degrade``, ``--inject-faults``,
``--audit``, ``--trace``, ``--metrics-out``, ``--admin-port``,
``--snapshot-every`` and ``--xla-profile-dir`` are accepted and raise
``NotImplementedError`` naming their ROADMAP item.
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
from ..serving.kv_manager import KVBudget, KVManager
from ..serving.loader import decode_loops, load_testbed_engines
from ..serving.scheduler import ContinuousScheduler
from ..serving.workload import poisson_arrivals, run_workload, summarize
from ..tokenizer import toy as tk

SCHEMES = ("base", "small", "specdecode", "specreason", "specreason+decode")

# the reference CLI's flags this slice leaves out, with the ROADMAP item
# that brings each (queue 1)
NOT_PORTED = {
    "num_samples": ("--num-samples", "item 4 (best-of-N)"),
    "vote": ("--vote", "item 4 (best-of-N)"),
    "tp": ("--tp", "item 8 (tensor parallelism)"),
    "deadline": ("--deadline", "item 6 (resilience)"),
    "slo_tpot": ("--slo-tpot", "item 6 (resilience)"),
    "shed_policy": ("--shed-policy", "item 6 (resilience)"),
    "degrade": ("--degrade", "item 6 (resilience)"),
    "inject_faults": ("--inject-faults", "item 6 (faults and audits)"),
    "audit": ("--audit", "item 6 (faults and audits)"),
    "trace": ("--trace", "item 6 (observability)"),
    "metrics_out": ("--metrics-out", "item 6 (observability)"),
    "admin_port": ("--admin-port", "item 6 (observability)"),
    "snapshot_every": ("--snapshot-every", "item 6 (observability)"),
    "xla_profile_dir": ("--xla-profile-dir", "item 6 (compile and device "
                        "plane)"),
}


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
    return line


def _spec_suffix(res: SpecReasonResult) -> str:
    """Per-request acceptance breakdown for hierarchical runs."""
    s = res.spec_stats
    if not s.rounds:
        return ""
    return (f" spec[acc={s.acceptance_rate:.2f} "
            f"len={s.mean_accepted_len:.1f}/{s.rounds}r]")


@dataclasses.dataclass
class ServeReport:
    """What a run served: the engines, the decode loop and, per request,
    (scheme, request index, task, result); a continuous run also keeps
    its scheduler, the request handles and the summary."""
    base: Engine
    small: Engine
    runs: List[Tuple[str, int, tasks.Task, SpecReasonResult]]
    decode_loop: str = "fused"
    sched: Optional[ContinuousScheduler] = None
    handles: Optional[list] = None
    stats: Optional[dict] = None


def continuous_scheduler(args, base: Engine,
                         small: Engine) -> ContinuousScheduler:
    """The continuous scheduler that ``args`` (``parse_args``) describe,
    over the pair."""
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
    return ContinuousScheduler(
        ctrl, kv, max_batch=args.batch,
        context_capacity=min(base.max_len, args.budget + 64),
        prefix_cache=not args.no_prefix_cache,
        chunked_prefill=args.chunked_prefill,
        max_prefill_tokens=args.max_prefill_tokens,
        on_event=(lambda e: print(f"[sched] {e}")) if args.verbose else None,
        seed=args.seed)


def serve_continuous(args, base: Engine, small: Engine, reqs,
                     dev: torch.device) -> ServeReport:
    """The continuous-batching path: paged-KV admission and per-tick
    speculate / verify / fallback batching."""
    sched = continuous_scheduler(args, base, small)
    print(f"[serve] decode loop: {sched.base_be.name} {args.decode_loop}, "
          f"{sched.small_be.name} {args.decode_loop}", flush=True)
    rng = random.Random(args.seed)
    pairs = [(t, torch.Generator(device=dev).manual_seed(1000 * args.seed
                                                         + i))
             for i, t in enumerate(reqs)]
    arrivals = poisson_arrivals(len(pairs), args.arrival_rate, rng)
    t0 = time.perf_counter()
    handles = run_workload(sched, pairs, arrivals)
    wall = time.perf_counter() - t0
    tag = "hierspec" if args.spec_decode else "continuous"
    report = ServeReport(base, small, [], args.decode_loop, sched, handles)
    for i, h in enumerate(handles):
        res = h.result
        ok = is_correct(h.task, res.answer_ids)
        report.runs.append((tag, i, h.task, res))
        print(f"[{tag}] req{i}: {'OK ' if ok else 'BAD'} "
              f"status={h.status} "
              f"lat={h.e2e_latency:.2f}s think={res.n_thinking_tokens}"
              f"{_spec_suffix(res)} answer={tk.detok(res.answer_ids)}",
              flush=True)
        if args.meters:
            for name, m in res.meters.items():
                print(_meter_line(name, m))
    stats = summarize(handles, wall)
    stats.update({
        "scheduler": "continuous", "device": str(dev), "batch": args.batch,
        "decode_loop": args.decode_loop,
        "spec_decode": args.spec_decode, "gamma": args.gamma,
        "arrival_rate": args.arrival_rate, "ticks": sched.ticks,
        "preemptions": sched.preemptions, "prefix_cache": False,
        "chunked_prefill": args.chunked_prefill,
        "max_prefill_tokens": args.max_prefill_tokens,
        "prefill_chunks": sched.prefill_chunks,
        "num_samples": 1, "vote": False,
        "accuracy": sum(is_correct(h.task, h.result.answer_ids)
                        for h in handles) / max(len(handles), 1),
        "kv_store_bytes": sched.store_bytes(),
        "kv_accounted_bytes": {
            w: p.num_blocks * sched.kv.block_bytes(w)
            for w, p in sched.pools.items()},
    })
    if "p95_ttft_s" in stats:
        print(f"[latency] ttft p50={stats['p50_ttft_s']:.3f}s "
              f"p95={stats['p95_ttft_s']:.3f}s | tpot "
              f"p50={stats.get('p50_tpot_s', 0.0) * 1e3:.1f}ms "
              f"p95={stats.get('p95_tpot_s', 0.0) * 1e3:.1f}ms | "
              f"prefill stall "
              f"mean={stats.get('mean_prefill_stall_s', 0.0):.3f}s "
              f"p95={stats.get('p95_prefill_stall_s', 0.0):.3f}s")
    print(json.dumps(stats), flush=True)
    report.stats = stats
    return report


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
                    default="fused",
                    help="fused = chunks of tokens a CUDA graph replay "
                         "on the card (the body runs eagerly on the CPU), "
                         "eager = the per-token loop; for the sequential "
                         "engines and the continuous scheduler's rows")
    ap.add_argument("--scheduler", choices=("sequential", "continuous"),
                    default="sequential",
                    help="sequential = one request start-to-finish; "
                         "continuous = step-interleaved continuous batching "
                         "over paged KV")
    ap.add_argument("--batch", type=int, default=8,
                    help="continuous scheduler: max concurrent rows")
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
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="continuous scheduler: serve without the radix "
                         "prefix cache (required: the cache is not ported)")
    ap.add_argument("--chunked-prefill", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="continuous scheduler: chunk admission prefill to "
                         "--max-prefill-tokens prompt tokens per tick")
    ap.add_argument("--max-prefill-tokens", type=int, default=64,
                    help="chunked prefill: per-tick prompt-prefill budget")
    ap.add_argument("--verbose", action="store_true",
                    help="log admission / chunk-progress / preemption "
                         "events (continuous scheduler)")
    # the reference's flags that are not ported: accepted, then refused
    ap.add_argument("--num-samples", type=int, default=1)
    ap.add_argument("--vote", action="store_true")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--deadline", type=float, default=None)
    ap.add_argument("--slo-tpot", type=float, default=None)
    ap.add_argument("--shed-policy", choices=("none", "priority"),
                    default="none")
    ap.add_argument("--degrade", action="store_true")
    ap.add_argument("--inject-faults", default=None, metavar="SEED[:N]")
    ap.add_argument("--audit", action="store_true")
    ap.add_argument("--trace", default=None, metavar="OUT.json")
    ap.add_argument("--metrics-out", default=None, metavar="OUT.prom")
    ap.add_argument("--admin-port", type=int, default=None)
    ap.add_argument("--snapshot-every", type=float, default=None)
    ap.add_argument("--xla-profile-dir", default=None)
    args = ap.parse_args(argv)
    for dest, (flag, item) in NOT_PORTED.items():
        if getattr(args, dest) != ap.get_default(dest):
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP queue 1, {item})")
    if args.scheduler == "continuous":
        if args.scheme != "specreason":
            ap.error("--scheduler continuous serves the specreason scheme "
                     "only")
        if not args.no_prefix_cache:
            raise NotImplementedError(
                "the continuous scheduler's prefix cache is not ported yet "
                "(ROADMAP queue 1, item 4); pass --no-prefix-cache")
    elif args.spec_decode:
        ap.error("--spec-decode rides on the continuous scheduler; the "
                 "sequential regime has the specreason+decode scheme")
    if args.max_prefill_tokens < 1:
        ap.error("--max-prefill-tokens must be >= 1")
    return args


def main(argv: Optional[List[str]] = None) -> ServeReport:
    args = parse_args(argv)
    dev = devices.resolve(args.device)
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
