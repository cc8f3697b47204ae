"""Time the ssm path's decode loop of two checkouts, in turns, on one card.

    python -m repro_torch.launch.ssm_loop_ab --a <parent checkout> --b . \
        [--out ssm_loop_ab.jsonl]

Each turn is a child process that puts one checkout's ``src`` first on
the path and runs that checkout's code only, with its defaults (so a
tree whose ssm engines decode per token runs that loop, and one whose
engines decode fused runs the fused one): the mamba2-1.3b base (48
layers at published widths, random init from seed 0, the vocabulary cut
to the toy tokenizer's 64, as ``chip_smoke.py``'s ssm phase) and the
testbed SMALL drafter (seed 1), through ``serve.run_scheme``:

* ``req0``-``req2``: the three greedy SpecReason requests of
  ``chip_smoke.py``'s ssm phase (budget 128, threshold 4.5);
* ``hier0``: the first of them with hierarchical spec decode
  (``specreason+decode``, gamma 4);
* ``decode``: the base alone, a 64-token prompt and then 128 greedy
  tokens in one ``generate`` call (timed without the prompt).

Each case runs once to warm up (kernels loaded, graphs captured), then
once timed: wall, tokens, tok/s, ms per output token, the base's decode
calls, tokens and metered decode seconds, and the tokens' hash; then
once profiled in the window of ``chip_smoke.py``'s ``[profile]`` lines
(``trace_window.py``: CUDA activity only, bounded by pad kernels on the
device's clock; this tree's file in both checkouts' turns): the union of
the device's intervals in the window (busy), the window's wall, its idle
share 1 - busy / wall, and the pads the trace held before and after the
window.  Each checkout's kernels are built first, by its own
build module, outside the turns.  Turns run A, B, B, A, each after a
reading of the host's speed (ms of a fixed pure-Python loop), so that
drift of the shared host shows (``rows_ab.turns``).

Prints the card's name and power limit first, then one JSON line per
turn (also appended to ``--out``), then per case and checkout the range
of the readings and the tokens' hashes.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

BUDGET = 128
THRESHOLD = 4.5
PROMPT = 64
CASES = ("req0", "req1", "req2", "hier0", "decode")


def _child(root: str) -> None:
    """One turn: ``root``'s code, every case; prints one JSON line."""
    sys.path[0] = os.path.join(root, "src")      # was this file's folder
    # this tree's window, whichever checkout the turn runs
    sys.path.append(os.path.dirname(os.path.abspath(__file__)))
    import random

    import torch
    import trace_window

    from repro_torch.data import tasks
    from repro_torch.launch import serve
    from repro_torch.sampling.sample import SamplingParams
    from repro_torch.serving import loader

    import repro_torch
    assert os.path.dirname(os.path.dirname(repro_torch.__file__)) == \
        os.path.join(root, "src"), repro_torch.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    base = loader.random_engine("mamba2-1.3b", "cuda", seed=0)
    small = loader.random_engine("testbed-small", "cuda", seed=1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = random.Random(0)
    reqs = [tasks.sample_task(rng) for _ in range(3)]
    prompt = torch.randint(0, base.model.cfg.vocab_size, (PROMPT,),
                           generator=torch.Generator().manual_seed(4)
                           ).tolist()
    committed = base.extend(base.new_session(), prompt)

    def case(name):
        """(tokens, the base's meter over the run) of one run of
        ``name``."""
        gen = torch.Generator(device="cuda").manual_seed(
            0 if name == "decode" else int(name[-1]))
        if name == "decode":
            base.meter.reset()
            ids, _, _ = base.generate(committed, BUDGET, [],
                                      SamplingParams(temperature=0.0), gen)
            return ids, base.meter.as_dict()
        scheme = "specreason+decode" if name.startswith("hier") \
            else "specreason"
        res = serve.run_scheme(scheme, base, small, reqs[int(name[-1])],
                               gen, BUDGET, THRESHOLD, 0.0)
        return res.thinking_ids + res.answer_ids, res.meters["base"]

    out = dict(root=root, init_s=init_s, fused=bool(base.fused), cases={})
    for name in CASES:
        case(name)                              # the warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, m = case(name)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        p = trace_window.trace(lambda: case(name))
        out["cases"][name] = dict(
            wall_s=wall, tokens=len(toks), tok_s=len(toks) / wall,
            ms_per_token=wall / len(toks) * 1e3,
            base_decode_calls=m["decode_calls"],
            base_decode_tokens=m["decode_tokens"],
            base_decode_s=m["decode_time"],
            device_busy_s=p["busy"], profiled_wall_s=p["wall"],
            idle_share=p["idle"], pads=p["pads"],
            tokens_sha=hashlib.sha256(
                json.dumps(toks).encode()).hexdigest()[:16])
    print("SSM_LOOP_AB " + json.dumps(out), flush=True)


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
    from .rows_ab import turns
    readings = turns(__file__, "ssm_loop_ab", args.a, args.b, args.out)
    for name in CASES:
        for key, recs in readings.items():
            runs = [rec["cases"][name] for rec in recs]
            loop = "fused" if recs[0]["fused"] else "per-token"
            pads = sorted({tuple(r["pads"]) for r in runs})
            print(f"[ssm_loop_ab] {name} {key} ({loop} loop): "
                  + ", ".join(f"{m} {min(r[m] for r in runs):.4f}-"
                              f"{max(r[m] for r in runs):.4f}"
                              for m in ("tok_s", "ms_per_token",
                                        "idle_share"))
                  + f", {runs[0]['tokens']} tokens; pads held before and "
                  f"after the window {pads}; tokens "
                  f"{sorted(set(r['tokens_sha'] for r in runs))}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
