"""Serving CLI of the port, sequential: serve reasoning requests one at a
time through SpecReason (or a one-model baseline) on the testbed pair,
printing per-request latency and answers and a summary per scheme.

  PYTHONPATH=src python -m repro_torch.launch.serve --scheme specreason \\
      -n 3 --budget 128 --ckpt-dir exp/ckpt --device cuda

The pair is read from ``--ckpt-dir`` (``testbed-base.npz``,
``testbed-small.npz``); the port cannot train, so a missing checkpoint is
an error.  Request i samples from a ``torch.Generator`` seeded with
``1000 * seed + i``.  Schemes that need token-level speculative decoding
(specdecode, specreason+decode) and the continuous-batching scheduler
are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import random
from typing import List, Optional, Tuple

import torch

from .. import device as devices
from ..core.baselines import vanilla_reason
from ..core.controller import SpecReason, SpecReasonConfig, SpecReasonResult
from ..core.policies import StaticThreshold
from ..data import tasks
from ..data.evaluate import is_correct
from ..sampling.sample import SamplingParams
from ..serving.engine import Engine
from ..serving.loader import load_testbed_engines
from ..tokenizer import toy as tk

SCHEMES = ("base", "small", "specreason")


def run_scheme(scheme: str, base: Engine, small: Engine, task,
               generator: torch.Generator, budget: int, threshold: float,
               temperature: float) -> SpecReasonResult:
    prompt = tasks.question_tokens(task)
    sp = SamplingParams(temperature=temperature)
    if scheme == "base":
        return vanilla_reason(base, prompt, generator, budget, sp)
    if scheme == "small":
        return vanilla_reason(small, prompt, generator, budget, sp)
    cfg = SpecReasonConfig(policy=StaticThreshold(threshold),
                           token_budget=budget, sampling=sp)
    return SpecReason(base, small, cfg).run(prompt, generator)


def _meter_line(name: str, m: dict) -> str:
    dt, dc = m["decode_tokens"], m["decode_calls"]
    tok_s = dt / m["decode_time"] if m["decode_time"] else 0.0
    return (f"    {name}: decode {dt} tok / {dc} calls ({tok_s:.0f} tok/s), "
            f"prefill {m['prefill_tokens']} tok / {m['prefill_calls']} "
            "calls")


@dataclasses.dataclass
class ServeReport:
    """What a run served: the engines and, per request, (scheme, request
    index, task, result)."""
    base: Engine
    small: Engine
    runs: List[Tuple[str, int, tasks.Task, SpecReasonResult]]


def main(argv: Optional[List[str]] = None) -> ServeReport:
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
    args = ap.parse_args(argv)

    dev = devices.resolve(args.device)
    base, small = load_testbed_engines(args.ckpt_dir, dev)
    rng = random.Random(args.seed)
    reqs = [tasks.sample_task(rng) for _ in range(args.num_requests)]
    scheme = args.scheme

    report = ServeReport(base, small, [])
    lat, acc, think, out_tokens = [], [], [], 0
    for i, task in enumerate(reqs):
        gen = torch.Generator(device=dev).manual_seed(1000 * args.seed + i)
        res = run_scheme(scheme, base, small, task, gen, args.budget,
                         args.threshold, args.temperature)
        ok = is_correct(task, res.answer_ids)
        report.runs.append((scheme, i, task, res))
        lat.append(res.wall_time)
        acc.append(ok)
        think.append(res.n_thinking_tokens)
        out_tokens += res.n_thinking_tokens + len(res.answer_ids)
        print(f"[{scheme}] req{i}: {'OK ' if ok else 'BAD'} "
              f"{res.wall_time:.3f}s think={res.n_thinking_tokens} "
              f"steps={len(res.steps)} "
              f"answer={tk.detok(res.answer_ids)}", flush=True)
        if args.meters:
            for name, m in res.meters.items():
                print(_meter_line(name, m))
    print(json.dumps({
        "scheme": scheme, "device": str(dev),
        "mean_latency_s": sum(lat) / len(lat),
        "output_tokens_per_s": out_tokens / sum(lat),
        "accuracy": sum(acc) / len(acc),
        "mean_thinking_tokens": sum(think) / len(think),
    }), flush=True)
    return report


if __name__ == "__main__":
    main()
