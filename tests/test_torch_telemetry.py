"""The port's tracer and metrics (``serving/telemetry.py``) and their
hooks in the continuous scheduler, the batch engines and the spec
engine, on the random-init MICRO pair.

Held to the JAX package, exactly: ``SchedEvent``; the same span,
instant and counter calls at given timestamps give an equal
``chrome_trace()`` (ring overwrite included; only the exporter's module
name differs); the same observations give the same
``MetricsRegistry.render()`` bytes, and ``ServingMetrics.render()``
gives the JAX bundle's lines but those of its compile and memory series
(fed by watches that are not ported yet).

Inside the port: traced runs (tracer and metrics on) give the untraced
tokens, spec statistics and Meter counts, greedy, sampled and with
spec decode; an exported trace passes ``tools/trace_report.py``'s
validation, with a ``scheduler`` track, an ``engine:<name>`` track per
engine and a ``req:<id>`` track per request whose phase spans nest in
its lifetime; the metrics count the run; an annotated tracer's
``record_function`` ranges show in a ``torch.profiler`` trace; and the
serve CLI writes both artifacts (atomically) and the ``[resilience]``
line.
"""

import importlib.util
import json
import os
import random
import time
from collections import defaultdict

import pytest
import torch

from repro.serving import telemetry as jtel
from repro_torch.configs import testbed
from repro_torch.core import controller
from repro_torch.core.policies import StaticThreshold
from repro_torch.data import tasks
from repro_torch.launch import serve
from repro_torch.models.model import Model
from repro_torch.sampling.sample import SamplingParams
from repro_torch.serving import kv_manager as tkv
from repro_torch.serving import telemetry as tel
from repro_torch.serving.batch_engine import BatchEngine
from repro_torch.serving.engine import Engine
from repro_torch.serving.loader import save_random_testbed
from repro_torch.serving.scheduler import ContinuousScheduler
from repro_torch.serving.workload import expand_best_of_n

# the JAX ServingMetrics series that the live plane's watches feed
LIVE_PLANE_SERIES = {
    "specreason_compiles_total", "specreason_post_warmup_compiles_total",
    "specreason_compile_seconds_total", "specreason_device_memory_bytes",
    "specreason_device_memory_peak_bytes"}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THRESHOLD = 4.5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """The port's MICRO pair, seeded."""
    return tuple(Engine(Model(getattr(testbed, name)),
                        Model(getattr(testbed, name)).init(seed,
                                                           device="cpu"),
                        max_len=1024, fused=False)
                 for name, seed in (("MICRO", 0), ("MICRO_SMALL", 1)))


def _trace_report():
    spec = importlib.util.spec_from_file_location(
        "trace_report", os.path.join(ROOT, "tools", "trace_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------- against JAX

def test_sched_event_matches_jax():
    args = ("admit", "admit ab12cd34: prompt=20 cached=0 first_chunk=16",
            {"request": "ab12cd34", "prompt": 20, "cached": 0})
    t, j = tel.SchedEvent(*args), jtel.SchedEvent(*args)
    assert isinstance(t, str) and t == j and t.startswith("admit ")
    assert (t.kind, t.fields, t.as_dict()) == (j.kind, j.fields, j.as_dict())


def _record(mod, tr, n_spans, monkeypatch):
    """The same calls at given timestamps (the epoch pinned to 0, the
    clock pinned for the events)."""
    tr.epoch = 0.0
    for i in range(n_spans):
        t = 1.0 + 0.01 * i
        tr.span("scheduler", "tick", t, t + 0.004, {"tick": i})
        tr.span(f"engine:cb-{i % 2}", "decode", t + 0.001, t + 0.003,
                {"rows": i % 4, "tokens": 3 * i})
        if i % 3 == 0:
            tr.instant(f"req:r{i % 5}", "accept", {"utility": 0.5 * i},
                       t=t + 0.002)
        if i % 4 == 0:
            tr.counter("pressure", {"pressure": i / 100, "level": 1.0},
                       t=t + 0.004)
    tr.span("req:r1", "queued", -5.0, 1.0)          # clamps at the epoch
    monkeypatch.setattr(time, "perf_counter", lambda: 3.25)
    tr.event(mod.SchedEvent("shed", "shed r2: queue",
                            {"request": "r2", "code": "shed_overload"}))
    tr.event(mod.SchedEvent("degrade", "tick 3: L0 -> L1", {"tick": 3}))
    monkeypatch.undo()


@pytest.mark.parametrize("buffer,n", [(65536, 40), (16, 40)])
def test_chrome_trace_matches_jax(buffer, n, monkeypatch):
    t, j = tel.Tracer(buffer=buffer), jtel.Tracer(buffer=buffer)
    _record(tel, t, n, monkeypatch)
    _record(jtel, j, n, monkeypatch)
    assert t.entries() == j.entries()
    assert (t.recorded, t.dropped) == (j.recorded, j.dropped)
    if buffer < n:
        assert t.dropped > 0
    td, jd = t.chrome_trace(), j.chrome_trace()
    assert td["otherData"].pop("tracer") == "repro_torch.serving.telemetry"
    jd["otherData"].pop("tracer")
    assert td == jd
    with pytest.raises(ValueError):
        tel.Tracer(buffer=0)


def _observe(reg):
    c = reg.counter("reqs_total", "Requests.", labelnames=("status",))
    c.inc(status="ok")
    c.inc(2, status="shed")
    reg.counter("ticks_total", "Ticks.")
    g = reg.gauge("pressure", "Pressure.")
    g.set(0.75)
    h = reg.histogram("lat_seconds", "Latency.", buckets=(0.1, 1.0, 2.5))
    for v in (0.05, 0.1, 0.5, 5.0, 1e-9):
        h.observe(v)
    return reg.render()


def test_metrics_render_matches_jax():
    assert _observe(tel.MetricsRegistry()) == \
        _observe(jtel.MetricsRegistry())
    reg = tel.MetricsRegistry()
    c = reg.counter("x_total", labelnames=("a",))
    assert reg.counter("x_total", labelnames=("a",)) is c
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x_total")

    def bundle(mod):
        m = mod.ServingMetrics()
        for v in (0.004, 0.3, 7.0):
            m.ttft.observe(v)
            m.tpot.observe(v / 100)
        m.accepted_length.observe(3)
        m.requests.inc(status="ok")
        m.requests.inc(status="timeout")
        m.pool_occupancy.set(0.5, pool="base")
        return m.render().splitlines()

    def series(line):
        return (line.split()[2] if line.startswith("#")
                else line.split("{")[0].split()[0])
    # the JAX bundle's compile and memory series come with the watches
    # that feed them (the live plane): the rest is the same, line for line
    theirs = [x for x in bundle(jtel) if series(x) not in LIVE_PLANE_SERIES]
    assert len(theirs) < len(bundle(jtel))
    assert bundle(tel) == theirs


# ------------------------------------------------------- inside the port

def _sched(pair, temperature=0.0, spec=False, tracer=None, metrics=None,
           prefix_cache=True):
    base, small = pair
    cfg = controller.SpecReasonConfig(
        policy=StaticThreshold(THRESHOLD), token_budget=40,
        sampling=SamplingParams(temperature), use_spec_decode=spec,
        spec_gamma=3)
    ctrl = controller.SpecReason(base, small, cfg)
    kv = tkv.KVManager(base.model.cfg, small.model.cfg,
                       tkv.KVBudget(1 << 22))
    return ContinuousScheduler(ctrl, kv, max_batch=3,
                               max_prefill_tokens=16,
                               prefix_cache=prefix_cache, tracer=tracer,
                               metrics=metrics)


def _run(pair, reqs, gens, **kw):
    cs = _sched(pair, **kw)
    hs = [cs.submit(t, generator=g) for t, g in zip(reqs, gens)]
    cs.drain()
    return cs, hs


def _tasks(n=3, seed=4):
    rng = random.Random(seed)
    return [tasks.sample_task(rng, min_steps=6, max_steps=8)
            for _ in range(n)]


def _meters(cs):
    keep = ("prefill_tokens", "prefill_calls", "decode_tokens",
            "decode_calls", "decode_steps", "spec_rounds", "spec_proposed",
            "spec_accepted", "cache_hit_tokens", "cache_lookup_tokens")
    return {w: {k: be.meter.as_dict()[k] for k in keep}
            for w, be in (("base", cs.base_be), ("small", cs.small_be))}


@pytest.mark.parametrize("temperature,spec,best_of", [
    (0.0, False, 1), (0.8, False, 1), (0.8, True, 1), (0.8, False, 3)])
def test_traced_run_identical_to_untraced(pair, temperature, spec, best_of):
    """Tracing observes and never perturbs: tokens, step traces, spec
    statistics, cache hits and the engines' Meter counts are those of
    the same run untraced."""
    reqs = _tasks()
    if best_of > 1:
        pairs = expand_best_of_n([(reqs[0], torch.Generator()
                                   .manual_seed(5))], best_of)
        reqs = [t for t, _ in pairs]

    def gens():
        if best_of > 1:
            return [g for _, g in expand_best_of_n(
                [(reqs[0], torch.Generator().manual_seed(5))], best_of)]
        return [torch.Generator().manual_seed(i) for i in range(len(reqs))]
    on_cs, on = _run(pair, reqs, gens(), temperature=temperature, spec=spec,
                     tracer=tel.Tracer(annotate=True),
                     metrics=tel.ServingMetrics())
    off_cs, off = _run(pair, reqs, gens(), temperature=temperature,
                       spec=spec)
    for a, b in zip(on, off):
        assert a.status == b.status == "ok"
        assert a.result.thinking_ids == b.result.thinking_ids
        assert a.result.answer_ids == b.result.answer_ids
        assert [(s.source, s.accepted) for s in a.result.steps] == \
            [(s.source, s.accepted) for s in b.result.steps]
        assert a.result.spec_stats.as_dict() == b.result.spec_stats.as_dict()
        assert a.cache_hit_tokens == b.cache_hit_tokens
    assert _meters(on_cs) == _meters(off_cs)
    assert on_cs.ticks == off_cs.ticks
    if best_of > 1:
        assert sum(h.cache_hit_tokens for h in on) > 0


def test_trace_round_trip_and_metrics(pair, tmp_path):
    """An exported trace of a spec-decode run passes the analyzer's
    validation; it has the scheduler track, each engine's track and a
    track per request whose queued -> prefill -> ... -> answer spans and
    spec rounds nest in [queued start, done]; the metrics count the
    run."""
    tr, mt = tel.Tracer(), tel.ServingMetrics()
    cs, hs = _run(pair, _tasks(), [torch.Generator().manual_seed(i)
                                   for i in range(3)],
                  spec=True, tracer=tr, metrics=mt)
    path = tmp_path / "trace.json"
    tr.export(str(path))
    assert not os.path.exists(f"{path}.tmp")
    doc = json.load(open(path))
    rep = _trace_report()
    tracks = rep.validate(doc)
    names = set(tracks.values())
    assert {"scheduler", f"engine:{cs.base_be.name}",
            f"engine:{cs.small_be.name}"} <= names
    assert {f"req:{h.request_id}" for h in hs} <= names
    spans, instants = defaultdict(list), defaultdict(list)
    for ev in doc["traceEvents"]:
        track = tracks.get(ev.get("tid"), "")
        if ev["ph"] == "X":
            spans[track].append(ev)
        elif ev["ph"] == "i":
            instants[track].append(ev)
    for h in hs:
        track = f"req:{h.request_id}"
        evs = spans[track]
        assert {"queued", "prefill", "speculate", "answer"} <= \
            {e["name"] for e in evs}
        done = [e for e in instants[track] if e["name"] == "done"]
        assert len(done) == 1 and done[0]["args"]["status"] == "ok"
        lo = next(e for e in evs if e["name"] == "queued")["ts"]
        for e in evs:
            assert lo <= e["ts"] and e["ts"] + e["dur"] <= done[0]["ts"] + 1
    engine_ops = {e["name"] for t, evs in spans.items()
                  if t.startswith("engine:") for e in evs}
    assert {"prefill", "extend", "decode", "feed", "accept_prog",
            "decode.dispatch", "decode.block_until_ready"} <= engine_ops
    assert any(e["name"] == "spec_round" for t, evs in spans.items()
               if t.startswith("req:") for e in evs)
    assert rep.main([str(path)]) == 0
    assert mt.requests.value(status="ok") == len(hs)
    assert mt.ttft.count == len(hs) and mt.ticks.value() == cs.ticks
    assert mt.chunk_latency.count == cs.prefill_chunks
    assert mt.spec_rounds.value() == cs.base_be.meter.spec_rounds > 0
    assert mt.accepted_length.count == mt.spec_rounds.value()
    text = mt.render()
    assert f"specreason_ttft_seconds_count {len(hs)}" in text
    assert 'specreason_kv_pool_occupancy{pool="base"}' in text


def test_annotated_brackets_show_in_a_profiler_trace(pair):
    """``annotate=True`` wraps each engine call in
    ``record_function("<engine>.<op>")``: the profiler (here on the CPU)
    sees one range per bracket, and the tracer's spans stay one a call
    (a fused rows call is one ``decode`` bracket)."""
    from torch.profiler import ProfilerActivity, profile
    base, _ = pair
    tr = tel.Tracer(annotate=True)
    be = BatchEngine(base.model, base.params, batch=2, capacity=128,
                     name="probe", tracer=tr)
    rows = [be.alloc_row(), be.alloc_row()]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        be.prefill_rows(rows, [[3, 9, 14, 2, 7], [5, 6, 21]], [0, 0])
        be.generate_rows(rows, [9, 4], [], SamplingParams(0.0),
                         [torch.Generator(), torch.Generator()])
        be.extend_rows(rows[:1], [[4, 5]])
        be.feed_rows(rows, [12, 40])
    seen = defaultdict(int)
    for ev in prof.events():
        seen[ev.name] += 1
    brackets = defaultdict(int)
    for ph, track, name, *_ in tr.entries():
        if ph == "X" and track == "engine:probe" and "." not in name:
            brackets[f"probe.{name}"] += 1
    assert brackets == {"probe.prefill": 1, "probe.decode": 1,
                        "probe.extend": 1, "probe.feed": 1}
    assert {k: seen[k] for k in brackets} == brackets


def test_cli_writes_trace_metrics_and_resilience_line(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    save_random_testbed(ckpt, seed=4)
    trace, prom = tmp_path / "t.json", tmp_path / "m.prom"
    report = serve.main(
        ["--scheduler", "continuous", "--device", "cpu", "-n", "3",
         "--batch", "2", "--budget", "24", "--temperature", "0",
         "--ckpt-dir", ckpt, "--spec-decode", "--inject-faults", "7:3",
         "--audit", "--deadline", "300", "--slo-tpot", "0.5",
         "--shed-policy", "priority", "--degrade", "--trace", str(trace),
         "--metrics-out", str(prom), "--trace-buffer", "4096"])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("[resilience]"))
    assert "audit_violations=0" in line
    assert report.stats["resilience_audit_violations"] == 0
    assert all(h.terminal for h in report.handles)
    doc = json.load(open(trace))
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e.get("name") == "thread_name"}
    assert "scheduler" in names
    assert {f"req:{h.request_id}" for h in report.handles} <= names
    assert doc["otherData"]["recorded"] > 0
    text = prom.read_text()
    n_ok = sum(h.status == "ok" for h in report.handles)
    assert f"specreason_ttft_seconds_count {n_ok}" in text
    assert not os.path.exists(f"{trace}.tmp")
    assert f"[trace] {trace}" in out and f"[metrics] {prom}" in out
    with pytest.raises(SystemExit):
        serve.parse_args(["--trace", "x.json"])     # continuous only
