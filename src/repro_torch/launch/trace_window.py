"""One call's window in a ``torch.profiler`` trace of the card, bounded on
the device's clock: its device busy time, idle share and kernel counts.

``trace(run)`` traces CUDA activity only (the host's operator records
cost a trace most of its stop and read time, and nothing here reads
them).  In the trace: MARGIN s of host sleep, PAD launches of
``torch.cuda._sleep``'s ``spin_kernel``, ``run()``, PAD more, each block
ending in a device synchronize, and the margin again.  A trace loses
device records at its start and the first records after the card idles
(PERF.md §7; ``tools/trace_probe.py``): the margins and pads take those
losses.  The pads also bound the window on the device's clock, from the
end of the last pad before the run's first record to the start of the
first pad after its last one, since the trace's host clock drifts from
the device's by up to tens of ms.

Used by ``chip_smoke.py``'s ``profile_request`` and by
``ssm_loop_ab.py``.  It imports nothing of the package, so that
``ssm_loop_ab.py``'s child processes load this file from its folder and
read a parent checkout that lacks it the same way.
"""

from __future__ import annotations

import time

import torch

# spin_kernel launches before and after each window, and the seconds of
# host sleep around them (PERF.md §7: a trace loses up to 41 records at
# its start)
PAD = 256
MARGIN = 0.2


def trace(run) -> dict:
    """``run()`` traced as the module says.  Returns a dict: ``res``
    the result, ``wall`` the window's s, ``busy`` the union of the
    device's intervals (kernels, copies, sets) in it, ``idle`` = 1 -
    busy / wall, ``rows`` (kernel, device us, count) summed by name over
    the trace (a record of zero length counted, its interval not; pads
    left out), ``records`` and ``zero`` the device records and those of
    zero length, ``pads`` (pads before, pads after) the trace holds,
    ``stop_s`` and ``read_s`` the profiler's stop and the trace's
    reading."""
    from torch.profiler import ProfilerActivity, profile

    def pad():
        for _ in range(PAD):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(MARGIN)
        pad()
        res = run()
        torch.cuda.synchronize()
        pad()
        time.sleep(MARGIN)
        stop = time.perf_counter()
    stop_s = time.perf_counter() - stop
    t0 = time.perf_counter()
    # the raw trace's events: the profiler's own averaging
    # (``key_averages``) of a trace with 10^5 events takes minutes
    pads, events = [], []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            rec = (e.name(), e.start_ns(), e.duration_ns())
            (pads if "spin_kernel" in rec[0] else events).append(rec)
    if not events:
        raise AssertionError("the trace holds no device record of the run")
    first = min(start for _, start, _ in events)
    last = max(start + dur for _, start, dur in events)
    head = [start + dur for _, start, dur in pads if start < first]
    tail = [start for _, start, _ in pads if start >= last]
    lo, hi = max(head, default=first), min(tail, default=last)
    agg, spans, zero = {}, [], 0
    for name, start, dur in events:
        t, n = agg.get(name, (0.0, 0))
        agg[name] = (t + dur / 1e3, n + 1)
        if dur > 0:
            spans.append((start, start + dur))
        else:
            zero += 1
    busy_ns, cur = 0, lo
    for a, b in sorted(spans):
        a, b = max(a, cur), min(b, hi)
        if b > a:
            busy_ns += b - a
            cur = b
    wall = (hi - lo) / 1e9
    rows = sorted(((k, t, n) for k, (t, n) in agg.items()),
                  key=lambda r: -r[1])
    return dict(res=res, wall=wall, busy=busy_ns / 1e9,
                idle=1 - busy_ns / 1e9 / wall, rows=rows,
                records=len(events), zero=zero, pads=(len(head), len(tail)),
                stop_s=stop_s, read_s=time.perf_counter() - t0)
