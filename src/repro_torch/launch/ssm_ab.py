"""Time the ssm path with the SSD scan of two checkouts, in turns, in one
process on one card.

    python -m repro_torch.launch.ssm_ab --a <parent checkout> --b .

Builds each checkout's ``csrc/ssd_scan.cu`` with that checkout's own
build module (in a child process) and loads each checkout's wrapper
``kernels/ssd_scan.py`` against its own library; everything else (the
models, the engines, the other kernels) is this checkout's.  Makes
``chip_smoke.py``'s ssm engines once (mamba2-1.3b at its published widths
with random weights from seed 0, the testbed SMALL drafter from seed 1)
and runs one warm-up request with each scan.  Then every measurement
below is taken in turns A, B, B, A, with that checkout's scan behind
``ops.ssd``, each turn after a reading of the host's speed (ms of a fixed
pure-Python loop), so that drift of the shared host shows:

* each of the three greedy SpecReason requests of ``chip_smoke.py``'s ssm
  phase (budget 128, threshold 4.5): wall time, tokens, tok/s, base
  extends;
* the third again, unprofiled and under ``torch.profiler``: the device's
  busy time and idle share of the unprofiled wall, as ``chip_smoke.py``
  reads them;
* the base's 37-token extend after a 64-token prompt (48 scans of one
  chunk): the median wall ms of 20, each synchronised;
* the scan wrapper's host ms a call at that extend's shapes: the median
  of five windows of 200 calls on the host clock, not synchronised
  between calls.

Prints the card's name and power limit first, then one JSON line per
checkout with its readings in the order taken.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import random
import statistics
import subprocess
import sys
import time

THRESHOLD = 4.5
BUDGET = 128
EXTEND = (64, 37)       # prompt, then the timed extend
EXTEND_REPS = 20
HOST_REPS = 200
ORDER = ("A", "B", "B", "A")


class _OneLibrary:
    """Stands in for a wrapper's ``build`` module: ``load`` returns the
    library built from that wrapper's own checkout."""

    def __init__(self, path: str):
        self.path = path

    def load(self, name: str) -> ctypes.CDLL:
        return ctypes.CDLL(self.path)


def bind_scan(library: str, root: str, tag: str):
    """``root``'s ``ssd_scan`` wrapper (``kernels/ssd_scan.py``), loaded as
    a module of its own and bound to the library at ``library``."""
    path = os.path.join(root, "src", "repro_torch", "kernels",
                        "ssd_scan.py")
    spec = importlib.util.spec_from_file_location(
        f"repro_torch.kernels._ab_ssd_scan_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build = _OneLibrary(library)
    return mod.ssd_scan


def _scan_of(root: str, tag: str):
    """``root``'s ``ssd_scan`` wrapper, bound to ``root``'s library (built
    by ``root``'s own build module)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import build; "
            "build.build(['ssd_scan']); "
            "print(build.library_path('ssd_scan'))")
    out = subprocess.run([sys.executable, "-c", code,
                          os.path.join(root, "src")],
                         capture_output=True, text=True, check=True,
                         timeout=900, cwd=root,
                         env={**os.environ, "PYTHONPATH": ""})
    return bind_scan(out.stdout.strip().splitlines()[-1], root, tag)


def _request(torch, serve, base, small, task, seed) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    res = serve.run_scheme("specreason", base, small, task, gen, BUDGET,
                           THRESHOLD, 0.0)
    n = len(res.thinking_ids + res.answer_ids)
    return dict(wall_s=res.wall_time, tokens=n, tok_s=n / res.wall_time,
                base_extends=res.meters["base"]["prefill_calls"])


def _idle(torch, serve, base, small, task) -> dict:
    """The request unprofiled (its wall), then profiled (device busy)."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device="cuda").manual_seed(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve.run_scheme("specreason", base, small, task, gen, BUDGET,
                     THRESHOLD, 0.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve.run_scheme("specreason", base, small, task, gen, BUDGET,
                         THRESHOLD, 0.0)
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0) / 1e6
    return dict(wall_s=wall, device_busy_s=busy, idle_share=1 - busy / wall)


def _extend_ms(torch, base, toks, st) -> float:
    """Median wall ms of the base's extend, each synchronised."""
    m, params = base.model, base.params
    times = []
    with torch.no_grad():
        for _ in range(EXTEND_REPS + 3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.prefill(params, toks, st)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[3:])


def _host_ms(torch, scan, args) -> float:
    """Median over five windows of the wrapper's host ms a call."""
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_REPS):
            scan(*args)
        host.append((time.perf_counter() - t0) * 1e3 / HOST_REPS)
        torch.cuda.synchronize()
    return statistics.median(host)


def _host_speed_ms() -> float:
    """ms of a fixed pure-Python loop: how fast the host runs now."""
    t0 = time.perf_counter()
    s = 0
    for i in range(200_000):
        s += i & 7
    return (time.perf_counter() - t0) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--a", required=True, help="checkout A (e.g. parent)")
    ap.add_argument("--b", required=True, help="checkout B (e.g. change)")
    args = ap.parse_args(argv)
    import torch

    from repro_torch.data import tasks
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving import loader

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"[ssm_ab] {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    roots = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    scans = {k: _scan_of(r, k) for k, r in roots.items()}
    t0 = time.perf_counter()
    base = loader.random_engine("mamba2-1.3b", "cuda", seed=0)
    small = loader.random_engine("testbed-small", "cuda", seed=1)
    torch.cuda.synchronize()
    print(f"[ssm_ab] engines in {time.perf_counter() - t0:.1f} s",
          flush=True)
    rng = random.Random(0)
    reqs = [tasks.sample_task(rng) for _ in range(3)]
    for scan in scans.values():           # warm-up, one request each
        ops.ssd_kernel = scan
        _request(torch, serve, base, small, reqs[0], 0)

    m, cfg = base.model, base.model.cfg
    toks = torch.randint(0, cfg.vocab_size, (1, sum(EXTEND)),
                         generator=torch.Generator().manual_seed(9)).cuda()
    with torch.no_grad():
        _, st = m.prefill(base.params, toks[:, :EXTEND[0]],
                          m.init_state(1, 0, device="cuda"))
    # apply_mamba's x, dt, a, B, C of one layer at the extend's shapes
    h, p, n, g = (cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state,
                  cfg.ssm_n_groups)
    gen = torch.Generator(device="cuda").manual_seed(4)
    length = EXTEND[1]
    scan_args = (torch.randn(1, length, h, p, generator=gen, device="cuda"),
                 torch.rand(1, length, h, generator=gen, device="cuda"),
                 -torch.rand(h, generator=gen, device="cuda"),
                 torch.randn(1, length, g, n, generator=gen, device="cuda"),
                 torch.randn(1, length, g, n, generator=gen, device="cuda"),
                 length,
                 torch.randn(1, h, p, n, generator=gen, device="cuda"))

    # every measurement in turns A, B, B, A, each after a reading of the
    # host's speed, so that drift of the host shows
    rows = {k: dict(root=r, host_speed_ms=[], requests=[], idle=[],
                    extend_ms=[], scan_host_ms=[]) for k, r in roots.items()}

    def turns(key, fn):
        for who in ORDER:
            ops.ssd_kernel = scans[who]
            rows[who]["host_speed_ms"].append(_host_speed_ms())
            rows[who][key].append(fn(who))

    for i, task in enumerate(reqs):
        turns("requests",
              lambda who: _request(torch, serve, base, small, task, i))
    turns("idle", lambda who: _idle(torch, serve, base, small, reqs[2]))
    turns("extend_ms",
          lambda who: _extend_ms(torch, base, toks[:, EXTEND[0]:], st))
    turns("scan_host_ms", lambda who: _host_ms(torch, scans[who], scan_args))
    for key, row in rows.items():
        print(json.dumps({"checkout": key, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
