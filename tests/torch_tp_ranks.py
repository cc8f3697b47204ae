"""The rank side of ``tests/test_torch_tp.py``: what each rank of a
2-rank gloo group runs (and the test process runs at tp=1, with no
context), returning plain data (lists, numpy arrays) so that nothing
crosses a process boundary as a shared tensor.  Imports no JAX: the
spawned ranks import this module by name."""

from __future__ import annotations

import dataclasses
import random
from typing import Dict

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import params_from_numpy
from repro_torch.core.controller import SpecReason, SpecReasonConfig
from repro_torch.core.policies import StaticThreshold
from repro_torch.data import tasks
from repro_torch.kernels import ops
from repro_torch.kernels.paged_tp import (tp_paged_append_attention,
                                          tp_paged_decode_attention)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.sampling.sample import SamplingParams
from repro_torch.serving.batch_engine import BatchEngine
from repro_torch.serving.engine import Engine
from repro_torch.serving.kv_manager import KVBudget, KVManager
from repro_torch.serving.scheduler import ContinuousScheduler

# the scenarios of the reference's tests/test_tp_serving.py, by its
# ``_serve`` arguments
SCENARIOS = {
    "greedy": dict(seed=0),
    "sampled": dict(temperature=0.8, seed=3),
    "spec": dict(spec=True, seed=4),
    "prefix": dict(seed=5, resubmit=True),
    "pressured": dict(n_requests=4, kv_bytes=90_000, kv_fraction=0.5,
                      prefix_cache=False),
    # the base with a sliding window of 8, which every request outgrows:
    # #3 and #4 take the window per rank through ``paged_tp``
    "window": dict(seed=6, window=8),
}


def engines(payload) -> tuple:
    """The (base, small) Engines of the payload's configs and bridged
    parameters, on the CPU."""
    out = []
    for which in ("base", "small"):
        cfg = ModelConfig(**payload["cfg"][which]).validate()
        params = params_from_numpy(payload["params"][which], device="cpu")
        out.append(Engine(Model(cfg), params, max_len=256, fused=False))
    return tuple(out)


def serve(pair, tp, n_requests=3, temperature=0.0, spec=False, gamma=3,
          seed=0, max_batch=4, kv_bytes=1 << 26, kv_fraction=0.8,
          context_capacity=128, prefix_cache=True, resubmit=False,
          window=0) -> Dict:
    """One workload through a fresh scheduler (the reference's
    ``_serve``): each request's tokens and step trace, and the
    scheduler's counters.  ``window``: the base's sliding window (0:
    the payload's config)."""
    base, small = pair
    if window:
        base = Engine(Model(dataclasses.replace(
            base.model.cfg, sliding_window=window)), base.params,
            max_len=256, fused=False)
    cfg = SpecReasonConfig(policy=StaticThreshold(5.0), token_budget=32,
                           max_steps=4, use_spec_decode=spec,
                           spec_gamma=gamma, fused_decode=False,
                           sampling=SamplingParams(temperature=temperature))
    rng = random.Random(seed)
    reqs = [tasks.sample_task(rng) for _ in range(n_requests)]
    kv = KVManager(base.model.cfg, small.model.cfg,
                   KVBudget(total_bytes=kv_bytes, base_fraction=kv_fraction))
    cs = ContinuousScheduler(SpecReason(base, small, cfg), kv,
                             max_batch=max_batch,
                             context_capacity=context_capacity,
                             prefix_cache=prefix_cache, tp=tp)

    def submit():
        return [cs.submit(t, generator=torch.Generator().manual_seed(
            100 * seed + i)) for i, t in enumerate(reqs)]
    handles = submit()
    cs.drain()
    if resubmit:
        handles += submit()
        cs.drain()
    hits = cs.caches["base"].stats.hits if cs.caches else 0
    cs.clear_prefix_cache()
    return dict(
        traces=[(r.thinking_ids, [int(t) for t in r.answer_ids],
                 [(s.source, s.accepted, list(s.tokens)) for s in r.steps],
                 (r.spec_stats.proposed, r.spec_stats.accepted,
                  r.spec_stats.rounds))
                for r in (h.result for h in handles)],
        prompt_lens=[len(tasks.question_tokens(t)) for t in reqs],
        ticks=cs.ticks, preemptions=cs.preemptions, cache_hits=hits,
        pools=cs.pool_utilization(),
        spec_tp_size=cs.spec_be.tp_size if cs.spec_be else None,
        store_heads=cs.base_be.store.k.shape[2],
        views=cs.base_be.store.device_views())


def kernel_case() -> Dict[str, np.ndarray]:
    """Whole inputs of one decode and one span call: 3 rows over 16
    pages of 4 slots, 4 query heads over 2 kv heads of 16."""
    rng = np.random.default_rng(0)
    b, t, h, kh, hd, pages, nb, bs = 3, 4, 4, 2, 16, 16, 3, 4

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return dict(
        q=f32(b, h, hd), k_pages=f32(pages, kh, bs, hd),
        v_pages=f32(pages, kh, bs, hd),
        tables=rng.permutation(pages)[:b * nb].reshape(b, nb)
        .astype(np.int32),
        lengths=np.array([12, 1, 7], np.int32),
        aq=f32(b, t, h, hd), k_new=f32(b, t, kh, hd),
        v_new=f32(b, t, kh, hd), ctx=np.array([5, 3, 8], np.int32),
        span=np.array([4, 2, 1], np.int32))


def logits(pair, tp) -> Dict[str, np.ndarray]:
    """The base's logits for a ragged 2-row extend, then one batched
    decode step, on a standalone engine (per-token loop)."""
    base, _ = pair
    be = BatchEngine(base.model, base.params, batch=2, capacity=64,
                     fused=False, tp=tp)
    rows = [be.alloc_row(), be.alloc_row()]
    prompts = [[3, 9, 14, 2, 7, 30, 11], [5, 6, 21]]
    ext = be.extend_rows(rows, prompts, want_logits=True)
    be.feed_rows(rows, [12, 40])
    return {"extend": np.stack([ext[0][-1].cpu().numpy(),
                                ext[1][-1].cpu().numpy()]),
            "decode": be.last_logits.cpu().numpy()}


def kernels(tp, case, device="cpu") -> Dict[str, np.ndarray]:
    """``paged_tp``'s decode and append over this rank's heads of the
    case's whole inputs on ``device``, gathered."""
    t = {k: torch.from_numpy(v).to(device) for k, v in case.items()}
    h, kh = t["q"].shape[1], t["k_pages"].shape[1]
    qs, ks = tp.local_heads(h), tp.local_heads(kh)
    kp, vp = t["k_pages"][:, ks], t["v_pages"][:, ks]
    dec = tp_paged_decode_attention(tp, t["q"][:, qs], kp, vp, t["tables"],
                                    t["lengths"], heads=(h, kh))
    app = tp_paged_append_attention(
        tp, t["aq"][:, :, qs], t["k_new"][:, :, ks], t["v_new"][:, :, ks],
        kp, vp, t["tables"], t["ctx"], t["span"], heads=(h, kh))
    return {"decode": tp.gather_heads(dec).cpu().numpy(),
            "append": tp.gather_heads(app).cpu().numpy()}


def plain_kernels(case) -> Dict[str, np.ndarray]:
    """The unsharded plain versions of the same case, on the CPU."""
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    return {
        "decode": ops.paged_decode_attention(
            t["q"], t["k_pages"], t["v_pages"], t["tables"],
            t["lengths"]).numpy(),
        "append": ops.paged_append_attention(
            t["aq"], t["k_new"], t["v_new"], t["k_pages"], t["v_pages"],
            t["tables"], t["ctx"], t["span"]).numpy()}


def card(tp) -> Dict:
    """The card-only case (``tests/test_torch_cuda.py``): testbed BASE
    (seed 0) on a standalone engine's extend and decode step at rank
    ``tp.rank`` of two ranks sharing the card, or at tp=1 (``tp`` None),
    with the paged kernels' launch counts; each rank also runs
    ``paged_tp`` on ``kernel_case`` on the card."""
    from repro_torch.configs import testbed
    from repro_torch.kernels import paged_tp
    from repro_torch.kernels.paged_append_attention import \
        paged_append_attention
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda") if tp is None else tp.device
    wrappers = (paged_decode_attention, paged_append_attention,
                paged_tp.tp_paged_decode_attention,
                paged_tp.tp_paged_append_attention)
    for w in wrappers:
        w.launches = 0
    model = Model(testbed.BASE)
    base = Engine(model, model.init(0, device="cpu" if tp else dev))
    out = logits((base, None), tp)
    out["launches"] = [w.launches for w in wrappers]
    out["layers"] = model.cfg.n_layers
    if tp is not None:
        out["kernels"] = kernels(tp, kernel_case(), dev)
        out["backend"] = tp.backend
    return out


def run(tp, payload) -> Dict:
    """Every scenario at this rank (``tp`` None: tp=1 in this process)."""
    pair = engines(payload)
    out = {name: serve(pair, tp, **kw) for name, kw in SCENARIOS.items()}
    out["logits"] = logits(pair, tp)
    if tp is not None:
        out["kernels"] = kernels(tp, payload["kernel_case"])
        out["gathers"] = tp.gathers
        out["describe"] = tp.describe()
        out["threads"] = torch.get_num_threads()
    return out


# the tp resilience scenario: a stall of STALL_S at tick 2 outlasts the
# short deadline, so requests 1 (in flight) and 2 (queued) time out at
# tick 2's sweep, and a feasibility factor this large sheds request 4
# (queued behind higher priorities, long deadline) at the first sweep
# after a finish gave the service estimate
SHORT_DEADLINE_S = 1.0
STALL_S = 1.5
RESILIENCE_OPTS = [
    dict(priority=1), dict(priority=1, deadline_s=SHORT_DEADLINE_S),
    dict(priority=1, deadline_s=SHORT_DEADLINE_S), dict(priority=1),
    dict(priority=0, deadline_s=600.0), dict(priority=1)]


def resilience(tp, payload) -> Dict:
    """One greedy workload with deadlines that fire mid-flight and
    queued, a feasibility shed, the ladder forced to step down every
    tick and a stall fault (``tests/test_torch_resilience.py``):
    statuses, error codes, where each timeout struck, tokens and the
    scheduler's counters, at this rank (``tp`` None: tp=1 here), and a
    rank's count of broadcasts."""
    from repro_torch.serving.faults import Fault, FaultInjector, FaultPlan
    from repro_torch.serving.resilience import ResilienceConfig
    from repro_torch.serving.workload import run_workload
    base, small = engines(payload)
    cfg = SpecReasonConfig(policy=StaticThreshold(4.5), token_budget=32,
                           max_steps=4, use_spec_decode=True, spec_gamma=3,
                           fused_decode=False,
                           sampling=SamplingParams(temperature=0.0))
    kv = KVManager(base.model.cfg, small.model.cfg,
                   KVBudget(total_bytes=1 << 22))
    cs = ContinuousScheduler(
        SpecReason(base, small, cfg), kv, max_batch=2,
        context_capacity=128, tp=tp, audit=True,
        resilience=ResilienceConfig(degrade=True, high_water=0.0,
                                    low_water=0.0, patience=1,
                                    shed_policy="priority",
                                    feasibility_factor=1e6),
        faults=FaultInjector(FaultPlan([Fault(tick=2, kind="stall",
                                              duration=1,
                                              stall_s=STALL_S)])))
    rng = random.Random(8)
    reqs = [tasks.sample_task(rng) for _ in RESILIENCE_OPTS]
    handles = run_workload(
        cs, [(t, torch.Generator().manual_seed(i))
             for i, t in enumerate(reqs)], [0.0] * len(reqs),
        opts=RESILIENCE_OPTS)
    out = {} if tp is None else {"broadcasts": tp.broadcasts}
    return dict(
        out,
        statuses=[h.status for h in handles],
        codes=[h.error.code if h.error else None for h in handles],
        where=[next((w for w in ("mid-flight", "queued")
                     if h.error and w in h.error.message), None)
               for h in handles],
        tokens=[(h.result.thinking_ids, [int(t) for t in h.result.answer_ids])
                if h.result else None for h in handles],
        ticks=cs.ticks, stalled_ticks=cs.stalled_ticks,
        level=cs.res.level, transitions=len(cs.res.transitions),
        timeouts=cs.timeouts, shed=cs.shed_requests,
        audit_violations=cs.audit_violations)
