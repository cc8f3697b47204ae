"""Time the continuous path of two checkouts, in turns, on one card.

    python -m repro_torch.launch.rows_ab --a <parent checkout> --b . \
        [--out rows_ab.jsonl]

Each turn is a child process that puts one checkout's ``src`` first on
the path and runs that checkout's code only, with its defaults: the
minitron-4b base (all 32 layers, random init from seed 0, the vocabulary
cut to the toy tokenizer's 64, as ``chip_smoke.py``'s ``[fused rows]``
phase) and the testbed SMALL drafter (seed 1) behind the continuous
scheduler: 8 requests over 4 rows, budget 128, threshold 4.5, a KV
budget of 1000 MiB, no prefix cache, greedy, once without and once with
hierarchical spec decode (gamma 4).  Each case runs once to warm up
(kernels loaded, graphs captured), then ``REPS`` times timed: wall,
tok/s, TPOT p50 and p95, TTFT p50, the batch engines' decode calls,
steps and host waits, and the tokens' hash.  Each checkout's kernels
are built first, by its own build module, outside the turns.  Turns run
A, B, B, A, each after a reading of the host's speed (ms of a fixed
pure-Python loop), so that drift of the shared host shows (``turns``,
which ``ssm_loop_ab.py`` shares).

Prints the card's name and power limit first, then one JSON line per
turn (also appended to ``--out``), then the median of each case's
readings per checkout.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional

ORDER = ("A", "B", "B", "A")
REPS = 2
CASES = (("continuous", False), ("hierspec", True))
REQUESTS = 8
BUDGET = 128
THRESHOLD = 4.5
KV_MB = 1000


def _host_speed_ms() -> float:
    """ms of a fixed pure-Python loop: how fast the host runs now."""
    t0 = time.perf_counter()
    s = 0
    for i in range(200_000):
        s += i & 7
    return (time.perf_counter() - t0) * 1e3


def _child(root: str) -> None:
    """One turn: ``root``'s code, every case; prints one JSON line."""
    sys.path[0] = os.path.join(root, "src")      # was this file's folder
    import random

    import torch

    from repro_torch.core.controller import SpecReason, SpecReasonConfig
    from repro_torch.core.policies import StaticThreshold
    from repro_torch.data import tasks
    from repro_torch.sampling.sample import SamplingParams
    from repro_torch.serving import loader
    from repro_torch.serving.kv_manager import KVBudget, KVManager
    from repro_torch.serving.scheduler import ContinuousScheduler
    from repro_torch.serving.workload import run_workload, summarize

    import repro_torch
    assert os.path.dirname(os.path.dirname(repro_torch.__file__)) == \
        os.path.join(root, "src"), repro_torch.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    base = loader.random_engine("minitron-4b", "cuda", seed=0)
    small = loader.random_engine("testbed-small", "cuda", seed=1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = random.Random(0)
    reqs = [tasks.sample_task(rng) for _ in range(REQUESTS)]
    out = dict(root=root, init_s=init_s, cases={})
    for name, spec in CASES:
        cfg = SpecReasonConfig(policy=StaticThreshold(THRESHOLD),
                               token_budget=BUDGET,
                               sampling=SamplingParams(temperature=0.0),
                               use_spec_decode=spec, spec_gamma=4)
        kv = KVManager(base.model.cfg, small.model.cfg,
                       KVBudget(total_bytes=KV_MB << 20))
        sched = ContinuousScheduler(
            SpecReason(base, small, cfg), kv, max_batch=4,
            context_capacity=min(base.max_len, BUDGET + 64),
            prefix_cache=False, seed=0)
        engines = (sched.base_be, sched.small_be)
        loop = "fused" if getattr(sched.base_be, "fused", False) \
            else "per-token"
        runs = []
        for rep in range(REPS + 1):
            gens = [torch.Generator(device="cuda").manual_seed(i)
                    for i in range(REQUESTS)]
            before = [(e.meter.decode_calls, e.meter.decode_steps,
                       e.meter.decode_syncs) for e in engines]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            handles = run_workload(sched, list(zip(reqs, gens)),
                                   [0.0] * REQUESTS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if any(h.status != "ok" for h in handles):
                raise RuntimeError(f"{name}: a request did not finish")
            st = summarize(handles, wall)
            toks = [h.result.thinking_ids + h.result.answer_ids
                    for h in handles]
            if rep == 0:
                continue                   # the warm-up
            meters = {}
            for e, (calls, steps, syncs) in zip(engines, before):
                m = e.meter
                meters[e.name] = dict(
                    decode_calls=m.decode_calls - calls,
                    decode_steps=m.decode_steps - steps,
                    decode_syncs=m.decode_syncs - syncs)
            runs.append(dict(
                wall_s=wall, tokens=sum(map(len, toks)), tok_s=st["tok_s"],
                p50_tpot_s=st.get("p50_tpot_s"),
                p95_tpot_s=st.get("p95_tpot_s"),
                p50_ttft_s=st.get("p50_ttft_s"), meters=meters,
                tokens_sha=hashlib.sha256(
                    json.dumps(toks).encode()).hexdigest()[:16]))
        out["cases"][name] = dict(loop=loop, runs=runs)
    print("ROWS_AB " + json.dumps(out), flush=True)


def _build(root: str) -> subprocess.Popen:
    """``root``'s own build module builds its kernels (a child)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import build; build.build()")
    return subprocess.Popen([sys.executable, "-c", code,
                             os.path.join(root, "src")], cwd=root,
                            env={**os.environ, "PYTHONPATH": ""},
                            stdout=subprocess.DEVNULL)


def turns(script: str, tag: str, a: str, b: str,
          out: Optional[str]) -> Dict[str, List[dict]]:
    """Print the card, build both checkouts' kernels, then run each turn
    of ORDER: a reading of the host's speed, then ``script --child
    <checkout>`` in a child process that runs that checkout's code and
    prints one line, ``TAG <JSON>`` (``tag`` in capitals).  Returns each
    checkout's records (the JSON, the turn, the checkout, the card, the
    host's speed and the child's seconds), each also printed and
    appended to ``out``."""
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"[{tag}] {card}", flush=True)
    roots = {"A": os.path.abspath(a), "B": os.path.abspath(b)}
    t0 = time.perf_counter()
    builds = [_build(r) for r in roots.values()]
    if any(p.wait(timeout=900) for p in builds):
        raise RuntimeError("a kernel build failed")
    print(f"[{tag}] kernels of both checkouts built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    marker = tag.upper() + " "
    readings = {k: [] for k in roots}
    for turn, key in enumerate(ORDER):
        host_ms = _host_speed_ms()
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, os.path.abspath(script),
                              "--child", roots[key]], cwd=roots[key],
                             env={**os.environ, "PYTHONPATH": ""},
                             capture_output=True, text=True, timeout=900)
        line = next((x for x in res.stdout.splitlines()
                     if x.startswith(marker)), None)
        if res.returncode or line is None:
            sys.stderr.write(res.stdout[-4000:] + res.stderr[-4000:])
            raise RuntimeError(f"turn {turn} ({key}) failed")
        rec = dict(turn=turn, checkout=key, card=card, host_ms=host_ms,
                   process_s=time.perf_counter() - t0,
                   **json.loads(line[len(marker):]))
        readings[key].append(rec)
        text = json.dumps(rec)
        print(text, flush=True)
        if out:
            with open(out, "a") as f:
                f.write(text + "\n")
    return readings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--a", help="checkout A (e.g. parent)")
    ap.add_argument("--b", help="checkout B (e.g. change)")
    ap.add_argument("--out", default=None, help="append JSON lines here")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        _child(args.child)
        return 0
    if not (args.a and args.b):
        ap.error("--a and --b are required")
    readings = turns(__file__, "rows_ab", args.a, args.b, args.out)
    for name, _ in CASES:
        for key, recs in readings.items():
            runs = [r for rec in recs for r in rec["cases"][name]["runs"]]
            med = {m: statistics.median(r[m] for r in runs)
                   for m in ("wall_s", "tok_s", "p50_tpot_s", "p50_ttft_s")}
            print(f"[rows_ab] {name} {key} "
                  f"({recs[0]['cases'][name]['loop']} rows loop, "
                  f"{len(runs)} runs): median "
                  + ", ".join(f"{m} {v:.4f}" for m, v in med.items())
                  + f"; tokens {sorted(set(r['tokens_sha'] for r in runs))}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
