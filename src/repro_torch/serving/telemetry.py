"""Structured tracing & metrics for the serving stack: the port of the
JAX package's ``serving/telemetry.py``.

Three pieces, all optional and all off by default:

``Tracer`` — a low-overhead span/event recorder.  The scheduler, the
batch engines and the spec engine record *complete spans* (a name plus a
``[t0, t1)`` wall-clock window on a named track), *instants* (admission,
preemption, verdicts, terminal outcomes) and *counter samples* (pool
occupancy, pressure, queue depth) into one bounded ring buffer
(``collections.deque(maxlen=...)`` — a long run overwrites its oldest
entries instead of growing without bound).  Tracks are strings:

    ``scheduler``      per-tick spans (batch composition, budget spent)
    ``engine:<name>``  engine-call brackets (prefill/extend/decode/feed/
                       cache_seed) per BatchEngine, and the spec engine's
                       acceptance (``accept_prog``)
    ``req:<id>``       one track per request: queued -> prefill chunks ->
                       speculate/verify/close/fallback/answer phase spans
                       -> spec_round spans -> done

``Tracer.chrome_trace()`` renders the buffer as Chrome trace-event JSON
(``traceEvents`` with ``ph:"X"`` complete events, ``ph:"i"`` instants,
``ph:"C"`` counters and ``ph:"M"`` track-naming metadata — loadable in
Perfetto / chrome://tracing).  Timestamps are microseconds relative to
the tracer's epoch.  With ``annotate=True`` the batch engines also wrap
each engine call in ``torch.profiler.record_function("<engine>.<op>")``
(the JAX package's ``jax.profiler.TraceAnnotation``), so a
``torch.profiler`` trace taken in the same process (``launch/
trace_window.py``) shows the tracer's brackets as host ranges around
the kernels and graph replays they launched.

**Zero-cost-when-off contract:** tracing is off when the scheduler's
``tracer`` is ``None``; every call site guards with ``if tr is not
None:`` BEFORE building span names or args dicts, so a tracer-less tick
executes no telemetry code beyond the guard itself.  When on, recording
is an epoch subtraction plus one deque append — no host syncs, no device
launches, no draw from a generator — so traced runs stay
token-identical to untraced runs (tests/test_torch_telemetry.py).

``MetricsRegistry`` — Prometheus-style counters / gauges / histograms
(fixed buckets for TTFT / TPOT / prefill-chunk latency / spec-decode
accepted length) with a text exposition ``render()``.  The
``ServingMetrics`` bundle wires the registry to the scheduler's hooks.
The JAX package's bundle also has compile and device-memory series,
fed by its compile and memory watches; they come with those watches
(ROADMAP queue 1, item 6: monitors, admin and device plane).

``SchedEvent`` — the structured upgrade of the scheduler's ``on_event``
hook.  A ``str`` subclass: consumers that treated events as strings
(prefix matching, printing) keep working unchanged, structured consumers
read ``.kind`` and ``.fields``.  An active tracer records every event as
an instant on the owning track.

Analyzer: ``tools/trace_report.py`` reads the exported trace (a
per-request waterfall, a phase-attribution table and a speculation
funnel)."""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import deque
from typing import (Any, Dict, Iterable, List, Mapping, Optional, Sequence,
                    Tuple)


def atomic_write(path: str, text: str) -> None:
    """Crash-safe text write: the content lands in ``<path>.tmp`` first
    and is moved into place with ``os.replace`` (atomic on POSIX), so a
    reader never sees a truncated artifact and an interrupt mid-write
    leaves any previous version intact.  Used for every telemetry
    artifact (--trace, --metrics-out, --snapshot-every flushes)."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Structured scheduler events
# ---------------------------------------------------------------------------


class SchedEvent(str):
    """One structured scheduler event: ``kind`` (a stable machine tag:
    admit / prefill / preempt / defer / quarantine / degrade / ok /
    timeout / shed / failed) plus ``fields`` (the event's data), rendered
    as the SAME human-readable line ``on_event`` consumers always
    received — the instance IS that string (``str`` subclass), so
    ``startswith``/``==``/printing are unchanged while structured
    consumers read the attributes.  Per-request events carry the id in
    ``fields["request"]``."""

    kind: str
    fields: Dict[str, Any]

    def __new__(cls, kind: str, message: str,
                fields: Optional[Mapping[str, Any]] = None) -> "SchedEvent":
        ev = super().__new__(cls, message)
        ev.kind = kind
        ev.fields = dict(fields) if fields else {}
        return ev

    def as_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "message": str(self), **self.fields}


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------

# well-known track names (requests get "req:<id>")
TRACK_SCHED = "scheduler"


def engine_track(name: str) -> str:
    return f"engine:{name}"


def request_track(request_id: str) -> str:
    return f"req:{request_id}"


class Tracer:
    """Bounded ring-buffer recorder for serving spans/instants/counters.

    All timestamps are absolute ``time.perf_counter()`` seconds; entries
    store them relative to the tracer's construction epoch (clamped at
    zero, so a request submitted before the tracer existed still exports
    a valid non-negative span).  ``buffer`` bounds retained entries —
    ``dropped`` counts what the ring overwrote.  ``annotate=True`` asks
    the batch engines to additionally wrap each engine call in
    ``torch.profiler.record_function("<engine>.<op>")`` so a profiler
    trace lines up with the serving-phase spans."""

    def __init__(self, buffer: int = 65536, annotate: bool = False):
        if buffer < 1:
            raise ValueError("trace buffer must hold >= 1 entry")
        self.epoch = time.perf_counter()
        self.annotate = annotate
        self.recorded = 0            # total entries ever recorded
        self._buf: deque = deque(maxlen=int(buffer))

    # ------------------------------------------------------------- record
    def _rel(self, t: float) -> float:
        return max(0.0, t - self.epoch)

    def span(self, track: str, name: str, t0: float, t1: float,
             args: Optional[Dict[str, Any]] = None) -> None:
        """One complete span ``[t0, t1)`` (absolute perf_counter s)."""
        self.recorded += 1
        r0 = self._rel(t0)
        self._buf.append(("X", track, name, r0,
                          max(0.0, self._rel(t1) - r0), args))

    def instant(self, track: str, name: str,
                args: Optional[Dict[str, Any]] = None,
                t: Optional[float] = None) -> None:
        self.recorded += 1
        self._buf.append(("i", track, name,
                          self._rel(time.perf_counter() if t is None
                                    else t), 0.0, args))

    def counter(self, name: str, values: Dict[str, float],
                t: Optional[float] = None) -> None:
        """One sample of a counter track (rendered as a stacked area
        chart by Perfetto): ``values`` maps series name -> value."""
        self.recorded += 1
        self._buf.append(("C", "counters", name,
                          self._rel(time.perf_counter() if t is None
                                    else t), 0.0, values))

    def event(self, ev: SchedEvent) -> None:
        """Record a structured scheduler event as an instant on the
        owning track (the request's, when ``fields["request"]`` names
        one; the scheduler track otherwise)."""
        rid = ev.fields.get("request")
        track = request_track(rid) if rid is not None else TRACK_SCHED
        self.instant(track, ev.kind,
                     {**ev.fields, "message": str(ev)})

    @property
    def dropped(self) -> int:
        """Entries the bounded ring overwrote (oldest-first)."""
        return max(0, self.recorded - len(self._buf))

    def entries(self) -> List[Tuple]:
        """The retained ring entries, oldest first (tests/analyzers)."""
        return list(self._buf)

    # ------------------------------------------------------------- export
    def chrome_trace(self) -> Dict[str, Any]:
        """Render the ring as a Chrome trace-event JSON object: one
        process, one thread (tid) per track in first-seen order, complete
        ``X`` events with microsecond ts/dur, ``i`` instants, ``C``
        counters, and ``M`` metadata naming the tracks.  Events are
        sorted by timestamp."""
        tids: Dict[str, int] = {}

        def tid_of(track: str) -> int:
            t = tids.get(track)
            if t is None:
                t = tids[track] = len(tids)
            return t

        events: List[Dict[str, Any]] = []
        for ph, track, name, ts, dur, args in self._buf:
            ts_us = round(ts * 1e6, 3)
            if ph == "X":
                e: Dict[str, Any] = {
                    "ph": "X", "pid": 1, "tid": tid_of(track),
                    "name": name, "cat": track.split(":", 1)[0],
                    "ts": ts_us, "dur": round(dur * 1e6, 3)}
            elif ph == "i":
                e = {"ph": "i", "pid": 1, "tid": tid_of(track),
                     "name": name, "cat": track.split(":", 1)[0],
                     "ts": ts_us, "s": "t"}
            else:                                   # "C"
                e = {"ph": "C", "pid": 1, "tid": tid_of(track),
                     "name": name, "ts": ts_us}
            if args:
                e["args"] = dict(args)
            events.append(e)
        events.sort(key=lambda e: e["ts"])
        meta: List[Dict[str, Any]] = [{
            "ph": "M", "pid": 1, "name": "process_name",
            "args": {"name": "specreason-serving"}}]
        for track, tid in sorted(tids.items(), key=lambda kv: kv[1]):
            meta.append({"ph": "M", "pid": 1, "tid": tid,
                         "name": "thread_name", "args": {"name": track}})
            meta.append({"ph": "M", "pid": 1, "tid": tid,
                         "name": "thread_sort_index",
                         "args": {"sort_index": tid}})
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {
                "tracer": "repro_torch.serving.telemetry",
                "recorded": self.recorded,
                "dropped": self.dropped,
            },
        }

    def export(self, path: str) -> None:
        """Write the Chrome trace-event JSON to ``path`` atomically
        (open it in https://ui.perfetto.dev or chrome://tracing).  A
        crash mid-write leaves the previous file intact, never a
        truncated one — the crash-safe-flush contract serve.py's
        try/finally and --snapshot-every rely on."""
        atomic_write(path, json.dumps(self.chrome_trace()))


# ---------------------------------------------------------------------------
# Metrics registry (Prometheus text exposition)
# ---------------------------------------------------------------------------


def _fmt(v: float) -> str:
    return f"{v:g}"


def _label_str(labelnames: Sequence[str], labelvalues: Sequence[str]) -> str:
    if not labelnames:
        return ""
    inner = ",".join(f'{n}="{v}"'
                     for n, v in zip(labelnames, labelvalues))
    return "{" + inner + "}"


class Counter:
    """Monotonic counter, optionally labelled: ``inc(n, status="ok")``."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name, self.help = name, help
        self.labelnames = tuple(labelnames)
        self._vals: Dict[Tuple[str, ...], float] = {}

    def _key(self, labels: Mapping[str, Any]) -> Tuple[str, ...]:
        assert set(labels) == set(self.labelnames), \
            f"{self.name}: labels {sorted(labels)} != " \
            f"declared {sorted(self.labelnames)}"
        return tuple(str(labels[n]) for n in self.labelnames)

    def inc(self, n: float = 1.0, **labels: Any) -> None:
        k = self._key(labels)
        self._vals[k] = self._vals.get(k, 0.0) + n

    def value(self, **labels: Any) -> float:
        return self._vals.get(self._key(labels), 0.0)

    def samples(self) -> Iterable[Tuple[str, float]]:
        if not self._vals and not self.labelnames:
            yield self.name, 0.0
        for k in sorted(self._vals):
            yield self.name + _label_str(self.labelnames, k), self._vals[k]


class Gauge(Counter):
    """Point-in-time value with the same optional labelling."""

    kind = "gauge"

    def set(self, v: float, **labels: Any) -> None:
        self._vals[self._key(labels)] = float(v)


class Histogram:
    """Fixed-bucket histogram with cumulative Prometheus exposition
    (``_bucket{le=...}`` / ``_sum`` / ``_count``)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = ()):
        assert buckets, f"{name}: histogram needs fixed buckets"
        self.name, self.help = name, help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self.buckets) + 1)   # + the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        self._counts[bisect.bisect_left(self.buckets, v)] += 1
        self._sum += v
        self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def samples(self) -> Iterable[Tuple[str, float]]:
        cum = 0
        for b, c in zip(self.buckets, self._counts):
            cum += c
            yield f'{self.name}_bucket{{le="{_fmt(b)}"}}', float(cum)
        yield f'{self.name}_bucket{{le="+Inf"}}', float(self._count)
        yield f"{self.name}_sum", self._sum
        yield f"{self.name}_count", float(self._count)


class MetricsRegistry:
    """Ordered collection of metrics with a Prometheus text exposition.
    Registering an existing name returns the existing metric (so bundles
    can share a registry) — with a kind mismatch it raises."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Any] = {}

    def _register(self, metric: Any) -> Any:
        have = self._metrics.get(metric.name)
        if have is not None:
            if type(have) is not type(metric):
                raise ValueError(
                    f"metric {metric.name} already registered as "
                    f"{have.kind}")
            return have
        self._metrics[metric.name] = metric
        return metric

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter(name, help, labelnames))

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge(name, help, labelnames))

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = ()) -> Histogram:
        return self._register(Histogram(name, help, buckets))

    def render(self) -> str:
        """The Prometheus text exposition of every registered metric."""
        lines: List[str] = []
        for m in self._metrics.values():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for sample_name, v in m.samples():
                lines.append(f"{sample_name} {_fmt(v)}")
        return "\n".join(lines) + "\n"


# fixed buckets (seconds / tokens): chosen to resolve both the random-init
# micro testbed (sub-millisecond ticks) and real-model serving
TTFT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                10.0)
TPOT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5)
CHUNK_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                 1.0)
ACCEPTED_BUCKETS = (0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0)


class ServingMetrics:
    """The serving stack's metric bundle over one :class:`MetricsRegistry`
    (pass ``metrics=ServingMetrics()`` to the continuous scheduler; write
    ``render()`` to a ``.prom`` file or scrape endpoint)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        r = self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.ttft = r.histogram(
            "specreason_ttft_seconds",
            "Time to first output token (s, from submission).",
            TTFT_BUCKETS)
        self.tpot = r.histogram(
            "specreason_tpot_seconds",
            "Per-output-token decode latency (s, after the first token).",
            TPOT_BUCKETS)
        self.chunk_latency = r.histogram(
            "specreason_prefill_chunk_seconds",
            "Wall time of one tick's bounded chunked-prefill batch (s).",
            CHUNK_BUCKETS)
        self.accepted_length = r.histogram(
            "specreason_spec_accepted_length",
            "Draft tokens accepted per spec-decode round per row.",
            ACCEPTED_BUCKETS)
        self.requests = r.counter(
            "specreason_requests_total",
            "Terminal request outcomes.", labelnames=("status",))
        self.output_tokens = r.counter(
            "specreason_output_tokens_total",
            "Thinking + answer tokens across finished requests.")
        self.prefill_tokens = r.counter(
            "specreason_prefill_tokens_total",
            "Prompt tokens prefilled (cached prefix hits excluded).")
        self.ticks = r.counter(
            "specreason_ticks_total", "Scheduler ticks.")
        self.preemptions = r.counter(
            "specreason_preemptions_total",
            "Recompute preemptions under KV pool pressure.")
        self.spec_rounds = r.counter(
            "specreason_spec_rounds_total",
            "Token-level spec-decode rounds (per row).")
        self.queue_depth = r.gauge(
            "specreason_queue_depth", "Requests waiting for admission.")
        self.pressure = r.gauge(
            "specreason_pressure",
            "Overload-controller pressure scalar in [0, 1].")
        self.degrade_level = r.gauge(
            "specreason_degrade_level",
            "Degradation-ladder level (0 = full configuration).")
        self.pool_occupancy = r.gauge(
            "specreason_kv_pool_occupancy",
            "Claimed fraction of the paged KV block pool.",
            labelnames=("pool",))

    def render(self) -> str:
        return self.registry.render()
