"""The port's overload and fault plane (``serving/resilience.py``,
``serving/faults.py`` and the continuous scheduler's failure lifecycle)
on the random-init MICRO pair.

Held to the JAX package, exactly: the overload controller's levels,
pressure, tick configs, admission quotas and feasibility answers over
the same signal sequences; the same bad ``ResilienceConfig`` / ``Fault``
values refused; ``FaultPlan.random`` plans from the same seeds; and the
continuous scheduler without pool pressure, greedy, under a plan of
``nan_logits`` and ``raise`` faults with the audit on: the JAX
scheduler's terminal statuses, error codes, retry counts and tokens.

Proved again inside the port (the reference's tests/test_resilience.py):
deadlines time requests out mid-flight and queued; cancel during a
chunked prefill, and cancel is idempotent; the shed order; greedy tokens
with the ladder forced down == ladder off; a NaN quarantine's retry ==
the clean run; a request past its retry budget fails structurally; a
mixed plan recovers; the audit catches a leaked block, and a page
reserved ahead of a call that raised; fixed chaos seeds drain clean
with the audit on; and at tp=2 over gloo, a run with a deadline, the
ladder and a stall gives tp=1's statuses and tokens with the ranks in
lockstep.  Deadlines that must not fire are generous, as the
reference's are (wall clocks).

Tolerances: none; every comparison is exact (tokens, statuses, the
controller's floats computed in the same order).
"""

import dataclasses
import random
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_ranks
from repro.configs import testbed as jtestbed
from repro.core import controller as jcontroller
from repro.core.policies import StaticThreshold as JThreshold
from repro.models.model import Model as JModel
from repro.sampling.sample import SamplingParams as JSampling
from repro.serving import faults as jfaults
from repro.serving import kv_manager as jkv
from repro.serving import resilience as jres
from repro.serving.engine import Engine as JEngine
from repro.serving.scheduler import ContinuousScheduler as JScheduler
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import testbed
from repro_torch.core import controller
from repro_torch.core.policies import StaticThreshold
from repro_torch.data import tasks
from repro_torch.models.model import Model, flatten, unflatten
from repro_torch.sampling.sample import SamplingParams
from repro_torch.serving import faults
from repro_torch.serving import kv_manager as tkv
from repro_torch.serving.engine import Engine
from repro_torch.serving.faults import Fault, FaultInjector, FaultPlan
from repro_torch.serving.resilience import (OverloadController,
                                            ResilienceConfig, TickConfig)
from repro_torch.serving.scheduler import ContinuousScheduler
from repro_torch.serving.tp import run_ranks
from repro_torch.serving.workload import majority_vote

THRESHOLD = 4.5
BUDGET = 40
JAX_BUDGET = 24          # the JAX scheduler's run: fewer shapes to compile
KV_BYTES = 1 << 22
RANKS_TIMEOUT_S = 150.0


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pairs():
    """((JAX base, small), (port base, small)) on the same parameters:
    the port's seeded init, handed to the JAX package as arrays (its own
    init would compile a program a parameter)."""
    out = []
    for name, seed in (("MICRO", 0), ("MICRO_SMALL", 1)):
        tp = Model(getattr(testbed, name)).init(seed, device="cpu")
        jp = jax.tree_util.tree_map(jnp.asarray, unflatten(
            tckpt.params_to_numpy(tp)))
        out.append((JEngine(JModel(getattr(jtestbed, name)), jp,
                            max_len=1024, fused=False),
                    Engine(Model(getattr(testbed, name)), tp, max_len=1024,
                           fused=False)))
    (jb, tb), (js, ts) = out
    return (jb, js), (tb, ts)


def _tasks(n, seed=1):
    rng = random.Random(seed)
    return [tasks.sample_task(rng) for _ in range(n)]


def _sched(pairs, spec=False, gamma=3, kv_bytes=KV_BYTES,
           max_batch=3, budget=BUDGET, **kw):
    _, (tb, ts) = pairs
    cfg = controller.SpecReasonConfig(
        policy=StaticThreshold(THRESHOLD), token_budget=budget,
        sampling=SamplingParams(0.0), use_spec_decode=spec,
        spec_gamma=gamma)
    ctrl = controller.SpecReason(tb, ts, cfg)
    kv = tkv.KVManager(tb.model.cfg, ts.model.cfg, tkv.KVBudget(kv_bytes))
    kw.setdefault("audit", True)
    return ContinuousScheduler(ctrl, kv, max_batch=max_batch, **kw)


def _gen(i):
    return torch.Generator().manual_seed(i)


CLEAN_N = 4
_CLEAN = {}


def _clean(pairs, n, spec=False):
    """Fault-free greedy tokens of ``_tasks(n)``: the first n of one
    cached run of CLEAN_N (``_tasks(n)`` is a prefix of ``_tasks(CLEAN_N)``
    and, without pool pressure, a request's greedy tokens do not depend
    on the others)."""
    assert n <= CLEAN_N
    if spec not in _CLEAN:
        cs = _sched(pairs, spec=spec)
        hs = [cs.submit(t, generator=_gen(i))
              for i, t in enumerate(_tasks(CLEAN_N))]
        cs.drain()
        _CLEAN[spec] = [_tokens(h) for h in hs]
    return _CLEAN[spec][:n]


def _tokens(h):
    return (list(h.result.thinking_ids), [int(t) for t in h.result.answer_ids])


def _drive(cs, max_ticks=400):
    """Tick with a bound: a faulted scheduler must drain, never hang."""
    for _ in range(max_ticks):
        if not cs.tick():
            return
    raise AssertionError(f"scheduler failed to drain in {max_ticks} ticks")


def _assert_drained_clean(cs):
    assert not cs.active and not cs.queue
    assert faults.audit_scheduler(cs) == []
    cs.clear_prefix_cache()
    assert cs.pool_utilization() == {"base": 0.0, "small": 0.0}
    assert cs.base_be.free_rows == cs.base_be.batch
    assert cs.small_be.free_rows == cs.small_be.batch


# ------------------------------------------------------------- policies

CONTROLLER_CFGS = [
    dict(degrade=True, high_water=0.8, low_water=0.3, patience=2,
         cooldown=3),
    dict(degrade=True, slo_tpot_s=0.02, slo_ttft_s=0.5, patience=1,
         cooldown=2, feasibility_factor=1.5, ewma_alpha=0.5),
    dict(slo_tpot_s=0.01, feasibility_factor=0.0),
]


@pytest.mark.parametrize("cfg_i", range(len(CONTROLLER_CFGS)))
def test_overload_controller_matches_jax(cfg_i):
    """The same signal sequence (numpy seed) gives the JAX controller's
    level, pressure, transition lines, tick config, admission quota,
    feasibility answer and as_dict at every tick."""
    kw = CONTROLLER_CFGS[cfg_i]
    base = dict(gamma=4, spec_decode=True, max_prefill_tokens=64,
                cache_insert=True)
    j = jres.OverloadController(jres.ResilienceConfig(**kw),
                                jres.TickConfig(**base))
    t = OverloadController(ResilienceConfig(**kw), TickConfig(**base))
    rng = np.random.default_rng(cfg_i)
    for tick in range(1, 200):
        if rng.random() < 0.3:
            fin = [None if rng.random() < 0.2 else float(x)
                   for x in rng.exponential([0.3, 0.02, 1.5])]
            j.observe_finish(*fin)
            t.observe_finish(*fin)
        # phases of low and high load, so the ladder walks both ways
        hot = (tick // 40) % 2 == 1
        occ = float(rng.uniform(0.6, 1.0) if hot else rng.uniform(0, 0.6))
        busy = float(rng.uniform(0, 1))
        queue = int(rng.integers(0, 6))
        extra = float(rng.uniform(-0.2, 1.2)) if rng.random() < 0.1 else 0.0
        assert t.observe_tick(tick, occ, busy, queue, extra) == \
            j.observe_tick(tick, occ, busy, queue, extra)
        assert (t.level, t.pressure) == (j.level, j.pressure)
        assert dataclasses.astuple(t.tick_config()) == \
            dataclasses.astuple(j.tick_config())
        n_active = int(rng.integers(0, 3))
        assert t.admit_quota(n_active) == j.admit_quota(n_active)
        rem = float(rng.uniform(0, 3))
        assert t.infeasible(rem) == j.infeasible(rem)
        assert t.as_dict() == j.as_dict()
    assert t.transitions == j.transitions
    if kw.get("degrade"):
        assert len(t.transitions) >= 2


BAD_RESILIENCE = [dict(shed_policy="random"),
                  dict(low_water=0.9, high_water=0.5),
                  dict(high_water=1.5), dict(low_water=-0.1),
                  dict(patience=0), dict(cooldown=0)]
BAD_FAULTS = [dict(tick=1, kind="gamma_ray"),
              dict(tick=1, kind="nan_logits"), dict(tick=1, kind="raise"),
              dict(tick=1, kind="stall", duration=0)]


@pytest.mark.parametrize("kind,kw", [("resilience", k) for k in
                                     BAD_RESILIENCE]
                         + [("fault", k) for k in BAD_FAULTS])
def test_bad_values_refused_as_jax(kind, kw):
    mine, theirs = ((ResilienceConfig, jres.ResilienceConfig)
                    if kind == "resilience" else (Fault, jfaults.Fault))
    with pytest.raises(ValueError) as j_err:
        theirs(**kw)
    with pytest.raises(ValueError) as t_err:
        mine(**kw)
    assert str(t_err.value) == str(j_err.value)
    # the defaults are inert and valid in both
    ResilienceConfig()
    jres.ResilienceConfig()


@pytest.mark.parametrize("seed", [0, 1, 7, 13, 42])
def test_fault_plan_random_matches_jax(seed):
    for kw in (dict(n_faults=6, n_requests=4),
               dict(n_faults=4, n_requests=12, max_tick=8),
               dict(n_faults=5, n_requests=3, max_tick=10,
                    kinds=("nan_logits", "raise"))):
        t = FaultPlan.random(seed=seed, **kw).faults
        j = jfaults.FaultPlan.random(seed=seed, **kw).faults
        assert [dataclasses.astuple(f) for f in t] == \
            [dataclasses.astuple(f) for f in j]
    assert FaultPlan.random(seed=seed, n_faults=6, n_requests=4).faults != \
        FaultPlan.random(seed=seed + 1, n_faults=6, n_requests=4).faults


# ------------------------------------------------ scheduler against JAX

PLAN = [("nan_logits", 2, 0, "base"), ("raise", 3, 1, "base"),
        ("nan_logits", 4, 2, "small"), ("raise", 6, 0, "base"),
        ("nan_logits", 9, 0, "base")]


def test_fault_plan_scheduler_matches_jax(pairs):
    """No pool pressure, greedy, spec decode on: a plan of NaN and raise
    faults, one request hit past its retry budget, the audit on every
    tick.  Statuses, error codes and ticks, retries and tokens are the
    JAX scheduler's."""
    (jb, js), _ = pairs
    reqs = _tasks(3)

    def plan(mod):
        return mod.FaultPlan([mod.Fault(tick=t, kind=k, target=x, which=w)
                              for k, t, x, w in PLAN])
    jcfg = jcontroller.SpecReasonConfig(
        policy=JThreshold(THRESHOLD), token_budget=JAX_BUDGET,
        sampling=JSampling(0.0), use_spec_decode=True, spec_gamma=3)
    jinj = jfaults.FaultInjector(plan(jfaults))
    jsched = JScheduler(jcontroller.SpecReason(jb, js, jcfg),
                        jkv.KVManager(jb.model.cfg, js.model.cfg,
                                      jkv.KVBudget(KV_BYTES)),
                        max_batch=3, prefix_cache=False,
                        max_prefill_tokens=16, faults=jinj, audit=True)
    jh = [jsched.submit(t, key=jax.random.PRNGKey(i))
          for i, t in enumerate(reqs)]
    jsched.drain(jax.random.PRNGKey(0))
    tinj = FaultInjector(plan(faults))
    tsched = _sched(pairs, spec=True, budget=JAX_BUDGET, prefix_cache=False,
                    max_prefill_tokens=16, faults=tinj)
    th = [tsched.submit(t, generator=_gen(i)) for i, t in enumerate(reqs)]
    tsched.drain()

    def outcome(h):
        return (h.status, h.error.code if h.error else None,
                h.error.tick if h.error else None, h.retries,
                h.quarantined, None if h.result is None else _tokens(h))
    assert [outcome(h) for h in th] == [outcome(h) for h in jh]
    assert {h.status for h in th} == {"ok", "failed"}
    assert tinj.as_dict() == jinj.as_dict()
    assert (tsched.ticks, tsched.quarantines, tsched.retries,
            tsched.failures, tsched.audit_violations) == \
        (jsched.ticks, jsched.quarantines, jsched.retries,
         jsched.failures, jsched.audit_violations)
    _assert_drained_clean(tsched)


# ------------------------------------------------- identities, the port

def test_deadline_timeout_midflight_and_queued(pairs):
    clean = _clean(pairs, 2)
    reqs = _tasks(2)
    cs = _sched(pairs, max_batch=2)
    h0 = cs.submit(reqs[0], generator=_gen(0))
    h1 = cs.submit(reqs[1], generator=_gen(1))
    h2 = cs.submit(reqs[0], generator=_gen(0), deadline_s=1e-9)
    time.sleep(0.001)
    cs.tick()                               # admits h0/h1, times out h2
    assert h2.status == "timeout" and h2.error.code == "deadline"
    assert "queued" in h2.error.message and h2.result is None
    assert h1.status == "running"
    h1.deadline_s = 1e-9                    # expire mid-flight
    _drive(cs)
    assert h1.status == "timeout" and h1.error.code == "deadline"
    assert "mid-flight" in h1.error.message and h1.result is None
    assert h0.status == "ok" and _tokens(h0) == clean[0]
    assert cs.timeouts == 2 and cs.base_be.meter.req_timeouts == 2
    _assert_drained_clean(cs)


def test_deadline_cancels_between_spec_rounds(pairs):
    """A deadline passing inside a multi-round spec decode cancels the
    row through the ledger's ``alive``, between rounds; the other rows
    finish with the clean run's tokens."""
    clean = _clean(pairs, 2, spec=True)
    reqs = _tasks(2)
    cs = _sched(pairs, spec=True, max_batch=2)
    hs = [cs.submit(t, generator=_gen(i)) for i, t in enumerate(reqs)]
    seen = []
    decode_rows = cs.spec_be.decode_rows

    def decode(items, params, ledger, **kw):
        # arm the deadline of the call's first row as the call starts
        if not seen:
            seen.append(ledger.acts[0])
            ledger.acts[0].req.deadline_s = 1e-9
            out = decode_rows(items, params, ledger, **kw)
            seen.append(ledger.acts[0].alive)
            return out
        return decode_rows(items, params, ledger, **kw)
    cs.spec_be.decode_rows = decode
    _drive(cs)
    victim, alive_after = seen
    assert alive_after is False           # cancelled inside the call
    assert victim.req.status == "timeout"
    assert victim.req.error.code == "deadline"
    assert "mid-flight" in victim.req.error.message
    for i, h in enumerate(hs):
        if h is not victim.req:
            assert h.status == "ok" and _tokens(h) == clean[i]
    _assert_drained_clean(cs)


def test_cancel_during_chunked_prefill_and_idempotent(pairs):
    clean = _clean(pairs, 2)
    reqs = _tasks(2)
    cs = _sched(pairs, max_batch=2, max_prefill_tokens=4)
    h0 = cs.submit(reqs[0], generator=_gen(0))
    h1 = cs.submit(reqs[1], generator=_gen(1))
    cs.tick()
    a0 = next(a for a in cs.active if a.req is h0)
    assert a0.state.phase == "prefill" and 0 < a0.cursor < len(a0.prompt)
    h0.deadline_s = 1e-9                     # expire mid-prefill
    _drive(cs)
    assert h0.status == "timeout" and h0.result is None
    assert h1.status == "ok" and _tokens(h1) == clean[1]
    _assert_drained_clean(cs)
    # the release latch fires once, whatever targets the row
    h = cs.submit(reqs[0], generator=_gen(0))
    cs.tick()
    a = next(x for x in cs.active if x.req is h)
    cs._cancel(a, "timeout", "deadline", "test cancel")
    cs._cancel(a, "failed", "engine_error", "second cancel is a no-op")
    cs._quarantine(a, "nan_logits", "a quarantine after it is a no-op")
    cs._release(a)
    assert h.status == "timeout" and cs.timeouts == 2 and cs.failures == 0
    assert cs.quarantines == 0
    _assert_drained_clean(cs)


def test_shed_priority_order_and_sibling_preference(pairs):
    clean = _clean(pairs, 2)
    reqs = _tasks(2)
    res = ResilienceConfig(shed_policy="priority", max_queue=3)
    cs = _sched(pairs, max_batch=1, resilience=res)
    ha = cs.submit(reqs[0], generator=_gen(0), priority=1)
    hb = cs.submit(reqs[1], generator=_gen(1))              # singleton
    hc = cs.submit(reqs[0], generator=_gen(0), group="g")
    hd = cs.submit(reqs[0], generator=_gen(0), group="g")
    _drive(cs)
    assert hd.status == "shed" and hd.error.code == "shed_overload"
    assert hd.result is None
    assert [ha.status, hb.status, hc.status] == ["ok"] * 3
    assert cs.shed_requests == 1 and cs.base_be.meter.req_shed == 1
    assert _tokens(ha) == clean[0] and _tokens(hb) == clean[1]
    votes = majority_vote([hc, hd], n=2)
    assert votes[0].winner_ids == hc.result.answer_ids
    assert votes[0].survivors == 1
    _assert_drained_clean(cs)


def test_feasibility_shed_after_a_service_estimate(pairs):
    """Once a finish gave the EWMA service time, a queued request whose
    remaining budget cannot cover it is shed as infeasible."""
    reqs = _tasks(3)
    res = ResilienceConfig(shed_policy="priority")
    cs = _sched(pairs, max_batch=1, resilience=res)
    h0 = cs.submit(reqs[0], generator=_gen(0))
    _drive(cs)
    assert h0.status == "ok" and cs.res.ewma_service.value > 0
    h1 = cs.submit(reqs[1], generator=_gen(1), deadline_s=60.0)
    h2 = cs.submit(reqs[2], generator=_gen(2),
                   deadline_s=cs.res.ewma_service.value / 4)
    _drive(cs)
    assert h1.status == "ok"
    assert h2.status == "shed" and h2.error.code == "shed_infeasible"
    _assert_drained_clean(cs)


@pytest.mark.parametrize("loop", ["fused", "eager"])
def test_ladder_forced_down_keeps_greedy_tokens(pairs, loop):
    """Every rung (gamma halved, spec off, a quarter of the prefill
    budget, no cache insertion) keeps the greedy tokens of the ladder
    off, under either rows loop."""
    clean = _clean(pairs, 3, spec=True)
    res = ResilienceConfig(degrade=True, high_water=0.0, low_water=0.0,
                           patience=1)
    cs = _sched(pairs, spec=True, resilience=res, max_prefill_tokens=16)
    for be in (cs.base_be, cs.small_be):
        be.fused = loop == "fused"
    gammas = []
    decode_rows = cs.spec_be.decode_rows

    def decode(*args, **kw):
        gammas.append(kw["gamma"])
        return decode_rows(*args, **kw)
    cs.spec_be.decode_rows = decode
    hs = [cs.submit(t, generator=_gen(i)) for i, t in enumerate(_tasks(3))]
    _drive(cs)
    assert cs.res.level == 4 and len(cs.res.transitions) == 4
    assert set(gammas) <= {3, 1}
    assert [_tokens(h) for h in hs] == clean
    _assert_drained_clean(cs)


def test_nan_quarantine_retry_gives_clean_tokens(pairs):
    clean = _clean(pairs, 3, spec=True)
    inj = FaultInjector(FaultPlan(
        [Fault(tick=2, kind="nan_logits", target=0, which="base")]))
    cs = _sched(pairs, spec=True, faults=inj)
    hs = [cs.submit(t, generator=_gen(i)) for i, t in enumerate(_tasks(3))]
    _drive(cs)
    assert inj.injected["nan_logits"] == 1
    assert cs.quarantines == 1 and cs.retries == 1
    assert hs[0].retries == 1 and hs[0].quarantined
    assert [h.status for h in hs] == ["ok"] * 3
    assert [_tokens(h) for h in hs] == clean
    _assert_drained_clean(cs)


def test_fault_past_retry_budget_fails_structurally(pairs):
    clean = _clean(pairs, 3, spec=True)
    inj = FaultInjector(FaultPlan(
        [Fault(tick=t, kind="nan_logits", target=0, which="base")
         for t in range(2, 7)]))
    cs = _sched(pairs, spec=True, faults=inj)
    hs = [cs.submit(t, generator=_gen(i)) for i, t in enumerate(_tasks(3))]
    _drive(cs)
    assert hs[0].status == "failed" and hs[0].result is None
    assert hs[0].error.code == "nan_logits" and hs[0].error.tick > 0
    assert "retries exhausted" in hs[0].error.message
    assert cs.failures == 1 and cs.base_be.meter.req_failed == 1
    assert [_tokens(h) for h in hs[1:]] == clean[1:]
    _assert_drained_clean(cs)


def test_mixed_fault_plan_recovers(pairs):
    clean = _clean(pairs, 3, spec=True)
    inj = FaultInjector(FaultPlan([
        Fault(tick=2, kind="raise", target=1),
        Fault(tick=3, kind="pool_exhaust", which="base", duration=2),
        Fault(tick=4, kind="stall", duration=2),
    ]))
    cs = _sched(pairs, spec=True, faults=inj)
    hs = [cs.submit(t, generator=_gen(i)) for i, t in enumerate(_tasks(3))]
    _drive(cs)
    assert inj.injected["raise"] == 1 and inj.injected["pool_exhaust"] == 1
    assert cs.stalled_ticks == 2 and cs.quarantines >= 1
    assert [h.status for h in hs] == ["ok"] * 3
    assert [_tokens(h) for h in hs] == clean
    _assert_drained_clean(cs)


@pytest.mark.parametrize("leak", ["block", "reserved_ahead"])
def test_audit_catches_deliberate_leak(pairs, leak):
    """Negative controls: a pool reference nobody holds; and pages a
    phase reserved ahead of a call that then raised, left past the
    row's position (the port reserves before its calls; a raising phase
    must give them back)."""
    cs = _sched(pairs, audit=False)
    if leak == "block":
        cs.submit(_tasks(1)[0], generator=_gen(0))
        _drive(cs)
        assert faults.audit_scheduler(cs) == []
        leaked = cs.pools["base"].alloc()
        viols = faults.audit_scheduler(cs)
        assert viols and any(f"block {leaked}" in v for v in viols)
        cs.pools["base"].release(leaked)
        assert faults.audit_scheduler(cs) == []
        return
    h = cs.submit(_tasks(1)[0], generator=_gen(0))
    while not any(a.state.phase in ("fallback", "speculate")
                  for a in cs.active):
        cs.tick()
    assert faults.audit_scheduler(cs) == []
    a = next(x for x in cs.active if x.req is h)
    pos = int(cs.base_be.pos[a.base_row])
    cs._reserve(a, "base", pos + 40)       # ahead of a call ...
    with pytest.raises(faults.InjectedEngineError):
        raise faults.InjectedEngineError(h.request_id, "fallback")
    viols = faults.audit_scheduler(cs)     # ... that raised, not settled
    assert viols and any("reserved" in v and "not given back" in v
                         for v in viols)
    cs._settle(a, "base")
    assert faults.audit_scheduler(cs) == []
    _drive(cs)
    _assert_drained_clean(cs)


@pytest.mark.parametrize("seed", [0, 1, 7, 13, 42])
def test_chaos_fixed_seeds_drain_clean(pairs, seed):
    """Seeded random plans under pool pressure: the scheduler drains
    within a tick bound, the audit stays clean every tick, the pools
    reconcile to zero, ok requests have the clean tokens and every other
    one a structured error."""
    clean = _clean(pairs, 4, spec=True)
    inj = FaultInjector(FaultPlan.random(seed=seed, n_faults=4,
                                         n_requests=4, max_tick=8))
    cs = _sched(pairs, spec=True, faults=inj, kv_bytes=1 << 20,
                max_batch=2, max_prefill_tokens=16)
    hs = [cs.submit(t, generator=_gen(i)) for i, t in enumerate(_tasks(4))]
    _drive(cs, max_ticks=200)
    assert sum(inj.injected.values()) >= 1
    assert cs.audit_violations == 0
    for want, h in zip(clean, hs):
        assert h.terminal
        if h.status == "ok":
            assert _tokens(h) == want
        else:
            assert h.result is None and h.error is not None and h.error.code
            assert h.error.code in ("deadline", "shed_infeasible",
                                    "shed_overload", "nan_logits",
                                    "engine_error")
    _assert_drained_clean(cs)


# ------------------------------------------------------- tensor parallel

def test_tp2_resilience_matches_tp1(tmp_path):
    """tp=2 over gloo with deadlines that fire (a stall outlasts them:
    one request times out mid-flight, one queued), a feasibility shed,
    the ladder forced down and the stall: rank 0 decides what expires and
    what is shed and the other rank applies it, so the ranks stay in
    lockstep (the scheduler's check_lockstep compares statuses, codes and
    tokens) and give tp=1's statuses, codes and tokens.  The sweep
    broadcasts only on ticks that can read a clock."""
    payload = {"params": {}, "cfg": {}}
    for which, cfg, seed in (("base", testbed.MICRO, 0),
                             ("small", testbed.MICRO_SMALL, 1)):
        params = Model(cfg).init(seed, device="cpu")
        payload["params"][which] = {k: v.numpy() for k, v in
                                    flatten(params).items()}
        payload["cfg"][which] = {f.name: getattr(cfg, f.name)
                                 for f in dataclasses.fields(cfg)}
    ranks = run_ranks(2, "cpu", torch_tp_ranks.resilience, (payload,),
                      RANKS_TIMEOUT_S, 1, str(tmp_path))
    tp1 = torch_tp_ranks.resilience(None, payload)
    sent = [r.pop("broadcasts") for r in ranks]
    assert ranks[0] == ranks[1]
    assert ranks[0] == tp1
    # one broadcast of arrivals a workload turn (ticks + 1), and a sweep
    # broadcast on the ticks with a deadline pending, not on the others
    turns = tp1["ticks"] + 1
    assert sent[0] == sent[1] and turns < sent[0] < 2 * turns - 1
    assert tp1["statuses"] == ["ok", "timeout", "timeout", "ok", "shed", "ok"]
    assert tp1["codes"] == [None, "deadline", "deadline", None,
                            "shed_infeasible", None]
    assert tp1["where"] == [None, "mid-flight", "queued", None, None, None]
    assert (tp1["timeouts"], tp1["shed"]) == (2, 1)
    assert tp1["stalled_ticks"] == 1 and tp1["level"] >= 2
    assert tp1["audit_violations"] == 0
