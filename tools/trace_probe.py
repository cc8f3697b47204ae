"""Does torch.profiler's trace hold every kernel launch of a window?

    python tools/trace_probe.py [--out trace_probe.jsonl]

A study of the profiler's lost records, kept beside the port and not part
of it (it imports only torch).  Each case traces a window (a
``record_function`` range inside ``torch.profiler.profile`` with CPU and
CUDA activities, the window ``chip_smoke.py``'s ``profile_request`` used
before it moved to a trace of CUDA activity bounded by pad kernels,
``repro_torch.launch.trace_window``) of a known number of launches
of one elementwise kernel (``add_`` on a small tensor): a CUDA graph of
1000 of them replayed R times, or N eager launches.  After the window,
still inside the trace, the card is synchronised and ``TAIL`` launches of
another kernel (``mul_``) follow, so that records lost at the end of the
trace show as missing tail launches and not as missing window launches.
Per case: launches made and records seen, of the window's kernel and of
the tail's; records of zero length; the gap from the window's start to
its first device record and from its last record to the window's end;
the count of gaps between consecutive window records over 20 times
their median spacing (a record lost inside a graph replay leaves one);
where the lost records were: each launch's host record (``cudaLaunchKernel``
or ``cudaGraphLaunch``) carries the correlation id of the device records
it made, so ``missing_at`` lists the positions, in launch order, of the
launches (eager: of the window and then the tail) or graph replays
(with the records each lost) whose device records the trace lacks.
For eager launches also the offset of each kernel's device start from
its ``cudaLaunchKernel`` on the host (matched by correlation id), the
median over the window's first and last 500 launches: the card waits on
the host there, so the offset is the launch latency plus any error of
the trace's clock alignment, and its change across the window is that
error's drift.  The sizes run from 10^3 to 2x10^5 launches a window,
the largest as many as a ``chip_smoke.py`` decode-only call holds, and
repeat; the largest cases run again with MARGIN seconds of host sleep
after the trace starts and before it stops.

The probe runs in a child process with ``KINETO_LOG_LEVEL=2`` (warnings
and above) and prints what the profiler wrote to stderr that speaks of
dropped, lost or out-of-range records.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

GRAPH_ADDS = 1000
TAIL = 64
MARGIN = 0.25
# (mode, replays of the graph or eager launches, repetitions, margin s)
CASES = (("graph", 10, 2, 0.0), ("graph", 130, 4, 0.0),
         ("eager", 1000, 3, 0.0), ("eager", 20000, 3, 0.0),
         ("eager", 60000, 2, 0.0), ("graph", 130, 4, MARGIN),
         ("eager", 1000, 3, MARGIN), ("eager", 20000, 3, MARGIN))


def _window(torch, mode, n, graph, x, margin):
    """One traced case; returns its record counts and edges."""
    from torch.profiler import ProfilerActivity, profile, record_function
    name = "trace_probe window"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(margin)
        with record_function(name):
            if mode == "graph":
                for _ in range(n):
                    graph.replay()
            else:
                for _ in range(n):
                    x.add_(1.0)
            torch.cuda.synchronize()
        for _ in range(TAIL):
            x.mul_(1.0)
        torch.cuda.synchronize()
        time.sleep(margin)
    win, adds, muls, zero = None, [], 0, 0
    launch, start, per_launch = {}, {}, {}
    for e in prof.profiler.kineto_results.events():
        dev = str(e.device_type())
        if e.name() == name and dev.endswith("CPU"):
            win = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif dev.endswith("CPU") and e.name().startswith(
                ("cudaLaunchKernel", "cudaGraphLaunch")):
            launch[e.correlation_id()] = e.start_ns()
        elif dev.endswith("CUDA") and e.name() != name:
            start[e.correlation_id()] = e.start_ns()
            per_launch[e.correlation_id()] = \
                per_launch.get(e.correlation_id(), 0) + 1
            if e.duration_ns() == 0:
                zero += 1
            if "AddFunctor" in e.name() or (
                    "add" in e.name().lower() and "mul" not in
                    e.name().lower()):
                adds.append((e.start_ns(), e.start_ns() + e.duration_ns()))
            elif "Mul" in e.name() or "mul" in e.name().lower():
                muls += 1
    adds.sort()
    made = n * (GRAPH_ADDS if mode == "graph" else 1)
    order = sorted(launch, key=launch.get)
    offsets = [start[c] - launch[c] for c in order if c in start]
    per = GRAPH_ADDS if mode == "graph" else 1
    missing_at = [(i, per - per_launch.get(c, 0)) if mode == "graph" else i
                  for i, c in enumerate(order) if per_launch.get(c, 0) < per
                  and not (mode == "graph" and i >= n)]
    head = offsets[:500] if mode == "eager" else []
    tail = offsets[-(TAIL + 500):-TAIL] if mode == "eager" else []
    gaps = 0
    if len(adds) > 2:
        spacing = [b[0] - a[0] for a, b in zip(adds, adds[1:])]
        med = statistics.median(spacing)
        gaps = sum(s > 20 * med for s in spacing) if med > 0 else 0
    return dict(mode=mode, n=n, margin_s=margin, made=made,
                seen=len(adds), tail_made=TAIL,
                offset_first_us=statistics.median(head) / 1e3
                if head else None,
                offset_last_us=statistics.median(tail) / 1e3
                if tail else None,
                tail_seen=muls, zero_length=zero,
                head_gap_us=(adds[0][0] - win[0]) / 1e3 if adds and win
                else None,
                end_gap_us=(win[1] - adds[-1][1]) / 1e3 if adds and win
                else None,
                gaps=gaps, launches=len(order), missing_at=missing_at[:20])


def _child(out: str) -> None:
    import torch
    x = torch.zeros(256, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x.add_(1.0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_ADDS):
            x.add_(1.0)
    for mode, n, reps, margin in CASES:
        for rep in range(reps):
            t0 = time.perf_counter()
            rec = _window(torch, mode, n, graph, x, margin)
            rec.update(rep=rep, seconds=time.perf_counter() - t0)
            text = json.dumps(rec)
            print("TRACE_PROBE " + text, flush=True)
            if out:
                with open(out, "a") as f:
                    f.write(text + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="append JSON lines here")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        _child(args.out)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"[trace_probe] {card}", flush=True)
    cmd = [sys.executable, os.path.abspath(__file__), "--child"] + (
        ["--out", args.out] if args.out else [])
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=1200,
                         env={**os.environ, "KINETO_LOG_LEVEL": "2"})
    recs = [json.loads(ln.split(" ", 1)[1]) for ln in res.stdout.splitlines()
            if ln.startswith("TRACE_PROBE ")]
    for r in recs:
        drift = "" if r["offset_first_us"] is None else (
            f", launch-to-start offset {r['offset_first_us']:.1f} us "
            f"first, {r['offset_last_us']:.1f} us last")
        print(f"[trace_probe] {r['mode']} x{r['n']} margin "
              f"{r['margin_s']} s rep {r['rep']}: "
              f"{r['seen']} of {r['made']} window records, tail "
              f"{r['tail_seen']} of {r['tail_made']}, zero-length "
              f"{r['zero_length']}, head gap {r['head_gap_us']} us, end "
              f"gap {r['end_gap_us']} us, inner gaps {r['gaps']}{drift}, "
              f"{r['seconds']:.2f} s; lost at (of {r['launches']} host "
              f"launches) {r['missing_at']}", flush=True)
    said = [ln for ln in res.stderr.splitlines()
            if re.search(r"drop|lost|range|exceed|overflow|buffer",
                         ln, re.I)]
    print(f"[trace_probe] the profiler's stderr: {len(res.stderr)} bytes, "
          f"{len(said)} lines on drops, losses, ranges or buffers", flush=True)
    for ln in said[:40]:
        print(f"[trace_probe] stderr: {ln[:300]}", flush=True)
    for margin in sorted({r["margin_s"] for r in recs}):
        mine = [r for r in recs if r["margin_s"] == margin]
        lost = sum(r["made"] - r["seen"] for r in mine)
        tail = sum(r["tail_made"] - r["tail_seen"] for r in mine)
        short = sum(r["made"] > r["seen"] or r["tail_made"] > r["tail_seen"]
                    for r in mine)
        print(f"[trace_probe] margin {margin} s: {len(mine)} windows, "
              f"{short} with records missing: {lost} window records and "
              f"{tail} tail records in all", flush=True)
    if res.returncode:
        sys.stderr.write(res.stderr[-4000:])
    return res.returncode


if __name__ == "__main__":
    sys.exit(main())
