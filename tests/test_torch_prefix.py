"""The port's radix prefix cache over paged rows (zero-copy: cached blocks
are pool blocks adopted into a row's table), best-of-N and the majority
vote, against the JAX package:

  * ``RadixCache`` against the JAX package's under seeded random
    sequences of insert, match and adopt, peek, evict, pin, unpin, clear
    and free: the same return values, pool refcounts and free lists,
    trie nodes, stats and meter counters after every operation; plus the
    JAX package's named contracts (block-aligned matching, insert dedup,
    adopt and free, the LRU cascade, inserts at the cap, the attach
    point, meter attribution, the common-block-prefix rule);
  * the continuous scheduler with the cache on against the JAX
    scheduler's, greedy on the random-init MICRO pair: best-of-N 3 and a
    template family, chunked prefill on and off, spec decode on, and a
    pressured run with evictions and readmission; per-request traces,
    hit tokens, ticks, prefill chunks, preemptions, defers and
    ``cache_stats()`` equal;
  * inside the port: cache on == off, greedy and at 0.8 from the same
    generators, and the pools empty after ``clear_prefix_cache()``; a
    hit's suffix prefill over adopted pages gives a cold prefill's
    logits;
  * the serve CLI with ``--num-samples 3 --vote`` on the CPU prints the
    JAX CLI's think, answer and vote lines (greedy).

Tolerances: utilities 1e-4 (tests/test_torch_controller.py); logits of a
hit against a cold row 1e-5 (tests/test_torch_batch.py).
"""

import random
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import testbed as jtestbed
from repro.core import controller as jcontroller
from repro.core.policies import StaticThreshold as JThreshold
from repro.launch import serve as jserve
from repro.models.model import Model as JModel
from repro.sampling.sample import SamplingParams as JSampling
from repro.serving import kv_manager as jkv
from repro.serving import paged_kv as jpaged
from repro.serving import prefix_cache as jprefix
from repro.serving import workload as jworkload
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Meter as JMeter
from repro.serving.scheduler import ContinuousScheduler as JScheduler
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import testbed
from repro_torch.core import controller
from repro_torch.core.policies import StaticThreshold
from repro_torch.data import tasks
from repro_torch.launch import serve
from repro_torch.models.model import Model
from repro_torch.sampling.sample import SamplingParams
from repro_torch.serving import kv_manager as tkv
from repro_torch.serving import workload
from repro_torch.serving.batch_engine import BatchEngine
from repro_torch.serving.engine import Engine, Meter
from repro_torch.serving.loader import save_random_testbed
from repro_torch.serving.paged_kv import PagedKVPool, PagedSeq, PoolExhausted
from repro_torch.serving.prefix_cache import RadixCache
from repro_torch.serving.scheduler import ContinuousScheduler

BS = 4              # the cache tests' block size: multi-block prompts
UTILITY_TOL = 1e-4
LOGIT_TOL = 1e-5
THRESHOLD = 4.5
BUDGET = 40
KV_BYTES = 1 << 20
# a KV budget under which the best-of-N workload over 3 rows preempts
# and evicts (context_capacity 64)
PRESSURE_BYTES = 60_000


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- the trie


def _fetch(t0, t1):
    """The JAX cache's KV source: zeros of (L=1, n, kv=1, hd=2)."""
    z = jnp.zeros((1, t1 - t0, 1, 2), jnp.float32)
    return z, z


def _evictable_blocks(cache):
    """The JAX cache's ``evictable_blocks`` for the port's: cached blocks
    held by the cache alone and not pinned (such a node has no in-flight
    descendant: a sequence holding a descendant holds the whole chain)."""
    return sum(not n.pinned and cache.pool.refcount(n.block) == 1
               for n in cache.iter_nodes())


class _Pair:
    """The JAX package's cache and the port's over twin pools: every
    operation runs on both and must return the same."""

    def __init__(self, num_blocks, cap):
        self.jpool = jpaged.PagedKVPool(num_blocks, BS)
        self.tpool = PagedKVPool(num_blocks, BS)
        self.jmeter, self.tmeter = JMeter(), Meter()
        store = jprefix.PrefixKVStore(cap, n_layers=1, kv_heads=1,
                                      head_dim=2, block_size=BS)
        self.j = jprefix.RadixCache(self.jpool, store, meter=self.jmeter)
        self.t = RadixCache(self.tpool, cap, meter=self.tmeter)
        self.live = []           # (JAX seq, port seq)

    def seqs(self, n_tokens):
        """A fresh sequence of n tokens on each pool (None if exhausted:
        both must be)."""
        js, ts = jpaged.PagedSeq(self.jpool), PagedSeq(self.tpool)
        raised = []
        for s, exc in ((js, jpaged.PoolExhausted), (ts, PoolExhausted)):
            try:
                s.append(n_tokens)
                raised.append(False)
            except exc:
                raised.append(True)
        assert raised[0] == raised[1]
        return None if raised[0] else (js, ts)

    def insert(self, tokens):
        pair = self.seqs(len(tokens))
        if pair is None:
            return None
        js, ts = pair
        nb = len(tokens) // BS
        got = (self.j.insert(tokens[:nb * BS], js.blocks[:nb], _fetch),
               self.t.insert(tokens[:nb * BS], ts.blocks[:nb]))
        self.live.append(pair)
        return got

    def match_adopt(self, tokens):
        jb, _, jhit = self.j.match(tokens)
        tb, thit = self.t.match(tokens)
        if thit:
            js, ts = jpaged.PagedSeq(self.jpool), PagedSeq(self.tpool)
            js.adopt(jb, jhit)
            ts.adopt(tb, thit)
            self.live.append((js, ts))
        return (jb, jhit), (tb, thit)

    def check(self):
        np.testing.assert_array_equal(self.tpool.refcounts(),
                                      self.jpool.refcounts())
        assert self.tpool._free == self.jpool._free
        assert self.t.stats.as_dict() == self.j.stats.as_dict()
        for k in ("cache_hit_tokens", "cache_lookup_tokens",
                  "cache_evictions"):
            assert getattr(self.tmeter, k) == getattr(self.jmeter, k)
        assert self.tmeter.cache_hit_rate == self.jmeter.cache_hit_rate
        assert self.t.cached_blocks == self.j.cached_blocks
        assert _evictable_blocks(self.t) == self.j.evictable_blocks()

        def nodes(c):
            return sorted((n.chain_hash, n.tokens, n.block, n.last_used,
                           n.pinned, len(n.children)) for n in c.iter_nodes())
        assert nodes(self.t) == nodes(self.j)


def _prompts(rng, n=12):
    """Prompts over three shared roots with ragged extensions."""
    roots = [[rng.randint(10, 40) for _ in range(rng.randint(3, 12))]
             for _ in range(3)]
    return [rng.choice(roots) + [rng.randint(10, 13)
                                 for _ in range(rng.randint(0, 9))]
            for _ in range(n)]


@pytest.mark.parametrize("seed", range(6))
def test_radix_cache_matches_jax_under_random_ops(seed):
    rng = random.Random(seed)
    cap = rng.choice([2, 3, 5, 64])
    c = _Pair(num_blocks=rng.choice([10, 16, 40]), cap=cap)
    prompts = _prompts(rng)
    ops = ("insert", "insert", "match", "match", "peek", "evict", "pin",
           "unpin", "free", "free", "clear")
    for _ in range(120):
        op = rng.choice(ops)
        p = rng.choice(prompts)
        if op == "insert":
            got = c.insert(p)
            assert got is None or got[0] == got[1]
        elif op == "match":
            (jb, jhit), (tb, thit) = c.match_adopt(p)
            assert (tb, thit) == (jb, jhit)
        elif op == "peek":
            assert c.t.peek(p) == c.j.peek(p)
        elif op == "evict":
            k = rng.randint(1, 4)
            assert c.t.evict(k) == c.j.evict(k)
        elif op in ("pin", "unpin"):
            assert getattr(c.t, op)(p) == getattr(c.j, op)(p)
        elif op == "free" and c.live:
            js, ts = c.live.pop(rng.randrange(len(c.live)))
            js.free()
            ts.free()
        elif op == "clear":
            assert c.t.clear() == c.j.clear()
        c.check()
    for js, ts in c.live:
        js.free()
        ts.free()
    for p in prompts:
        assert c.t.unpin(p) == c.j.unpin(p)
    assert c.t.clear() == c.j.clear()
    c.check()
    assert c.tpool.num_used == c.jpool.num_used == 0


def _mk_cache(num_blocks=16, cap=8, meter=None):
    pool = PagedKVPool(num_blocks, BS)
    return pool, RadixCache(pool, cap, meter=meter)


def _insert(cache, pool, tokens):
    """Prefill-then-insert as the scheduler does: a fresh sequence owns
    the prompt's blocks, the cache retains the full ones."""
    seq = PagedSeq(pool)
    seq.append(len(tokens))
    nb = len(tokens) // BS
    cache.insert(tokens[:nb * BS], seq.blocks[:nb])
    return seq


def test_match_is_block_aligned_and_never_whole_prompt():
    pool, cache = _mk_cache()
    toks = list(range(10))              # 2 full blocks + partial
    seq = _insert(cache, pool, toks)
    assert cache.cached_blocks == 2
    blocks, hit = cache.match(toks + [99])
    assert hit == 8 and blocks == seq.blocks[:2]
    assert cache.match(toks[:4] + [77] * 5)[1] == 4
    # a lookup of exactly the cached span drops its last block
    assert cache.match(toks[:8])[1] == 4
    assert cache.match([0, 1])[1] == 0
    assert cache.stats.lookups == 4 and cache.stats.hits == 3


def test_insert_dedups_and_counts():
    pool, cache = _mk_cache()
    toks = list(range(8))
    s1 = _insert(cache, pool, toks)
    used = pool.num_used
    s2 = _insert(cache, pool, toks)
    assert cache.cached_blocks == 2 and cache.stats.inserted_blocks == 2
    assert [pool.refcount(b) for b in s1.blocks] == [2, 2]
    assert [pool.refcount(b) for b in s2.blocks] == [1, 1]
    assert pool.num_used == used + 2


def test_adopt_shares_and_free_keeps_cache_alive():
    pool, cache = _mk_cache()
    toks = list(range(12))
    owner = _insert(cache, pool, toks)
    blocks, hit = cache.match(toks + [50])
    assert blocks == owner.blocks[:3]   # zero-copy: the owner's own pages
    reader = PagedSeq(pool)
    reader.adopt(blocks, hit)
    assert [pool.refcount(b) for b in blocks] == [3, 3, 3]
    owner.free()
    reader.free()
    assert [pool.refcount(b) for b in blocks] == [1, 1, 1]


def test_eviction_lru_cascades_and_spares_inflight_and_pinned():
    pool, cache = _mk_cache(num_blocks=32, cap=16)
    a, b = list(range(8)), list(range(8, 20))
    _insert(cache, pool, a).free()
    _insert(cache, pool, b).free()
    assert cache.cached_blocks == 5 == _evictable_blocks(cache)
    cache.match(a + [99])               # B becomes LRU
    assert cache.evict(1) == 1 and cache.cached_blocks == 4
    blocks, hit = cache.match(a + [99])
    reader = PagedSeq(pool)
    reader.adopt(blocks, hit)
    assert cache.evict(100) == 2        # B's cascade only
    assert cache.cached_blocks == 2 and _evictable_blocks(cache) == 0
    reader.free()
    assert cache.pin(a) == 2 and cache.evict(100) == 0
    cache.unpin(a)
    assert cache.evict(100) == 2
    assert cache.cached_blocks == 0 and pool.num_used == 0


def test_insert_at_the_cap_evicts_lru_and_never_inflight():
    pool, cache = _mk_cache(num_blocks=32, cap=2)
    a, b = list(range(8)), list(range(8, 16))
    _insert(cache, pool, a).free()
    _insert(cache, pool, b).free()      # displaces A
    assert cache.cached_blocks == 2 and cache.stats.evicted_blocks == 2
    assert cache.match(b + [99])[1] == 8 and cache.match(a + [99])[1] == 0
    owner = _insert(cache, pool, a)     # displaces B; A's owner stays live
    before = [pool.refcount(x) for x in owner.blocks]
    _insert(cache, pool, list(range(20, 36))).free()
    assert [pool.refcount(x) for x in owner.blocks] == before
    assert cache.cached_blocks == 2 and cache.match(a + [99])[1] == 8


def test_insert_never_evicts_its_own_attach_point():
    pool, cache = _mk_cache(num_blocks=16, cap=1)
    a = list(range(4))
    _insert(cache, pool, a).free()
    ext = a + list(range(4, 8))
    seq = PagedSeq(pool)
    seq.append(len(ext))
    assert cache.insert(ext, seq.blocks) == 0
    assert cache.cached_blocks == 1 and cache.match(a + [9])[1] == 4
    seq.free()
    assert cache.evict(10) == 1 and pool.num_used == 0


def test_meter_attribution():
    meter = Meter()
    pool, cache = _mk_cache(meter=meter)
    toks = list(range(8))
    _insert(cache, pool, toks).free()
    cache.match(toks + [99])
    assert (meter.cache_hit_tokens, meter.cache_lookup_tokens) == (8, 9)
    cache.evict(10)
    assert meter.cache_evictions == 2 and meter.cache_hit_rate == 8 / 9
    assert meter.as_dict()["cache_hit_tokens"] == 8


# ------------------------------------------------------------ scheduling


@pytest.fixture(scope="module")
def pairs():
    out = []
    for name, seed in (("MICRO", 0), ("MICRO_SMALL", 1)):
        jm = JModel(getattr(jtestbed, name))
        jp = jm.init(jax.random.PRNGKey(seed))
        tp = tckpt.params_from_numpy(jckpt._flatten(jp), device="cpu")
        out.append((JEngine(jm, jp, max_len=1024, fused=False),
                    Engine(Model(getattr(testbed, name)), tp, max_len=1024,
                           fused=False)))
    (jb, tb), (js, ts) = out
    return (jb, js), (tb, ts)


def _best_of_n(seed=0, n_tasks=2, n=3):
    rng = random.Random(seed)
    # three ops at least: a prompt longer than one 16-token block
    return [t for t in (tasks.sample_task(rng, min_steps=3)
                        for _ in range(n_tasks)) for _ in range(n)]


def _family(seed=2, n=4):
    return workload.template_task_family(random.Random(seed), n,
                                         shared_ops=4)


WORKLOADS = {"best_of_3": _best_of_n, "family": _family}


def _port_sched(pairs, temperature=0.0, spec=False, kv_bytes=KV_BYTES,
                **kw):
    _, (tb, ts) = pairs
    cfg = controller.SpecReasonConfig(
        policy=StaticThreshold(THRESHOLD), token_budget=BUDGET,
        sampling=SamplingParams(temperature), use_spec_decode=spec,
        spec_gamma=3)
    kv = tkv.KVManager(tb.model.cfg, ts.model.cfg, tkv.KVBudget(kv_bytes))
    return ContinuousScheduler(controller.SpecReason(tb, ts, cfg), kv,
                               max_batch=3, **kw)


def _port_run(pairs, task_list, **kw):
    events = []
    sched = _port_sched(pairs, on_event=events.append, **kw)
    handles = [sched.submit(t, generator=torch.Generator().manual_seed(i))
               for i, t in enumerate(task_list)]
    sched.drain()
    return sched, handles, Counter(e.kind for e in events)


def _jax_run(pairs, task_list, spec=False, kv_bytes=KV_BYTES, **kw):
    (jb, js), _ = pairs
    events = []
    cfg = jcontroller.SpecReasonConfig(
        policy=JThreshold(THRESHOLD), token_budget=BUDGET,
        sampling=JSampling(0.0), use_spec_decode=spec, spec_gamma=3)
    sched = JScheduler(jcontroller.SpecReason(jb, js, cfg),
                       jkv.KVManager(jb.model.cfg, js.model.cfg,
                                     jkv.KVBudget(kv_bytes)),
                       max_batch=3, on_event=events.append, **kw)
    handles = [sched.submit(t, key=jax.random.PRNGKey(i))
               for i, t in enumerate(task_list)]
    sched.drain(jax.random.PRNGKey(0))
    return sched, handles, Counter(e.kind for e in events)


def _trace(res):
    return (res.thinking_ids, [int(t) for t in res.answer_ids],
            [(s.source, s.accepted, list(s.tokens)) for s in res.steps],
            res.spec_stats.as_dict())


@pytest.mark.parametrize("load,chunked,spec,pressured", [
    ("best_of_3", True, False, False), ("best_of_3", False, False, False),
    ("family", True, False, False), ("family", False, False, False),
    ("best_of_3", True, True, False), ("best_of_3", True, False, True)])
def test_cached_scheduler_matches_jax(pairs, load, chunked, spec,
                                      pressured):
    task_list = WORKLOADS[load]()
    kw = dict(spec=spec, prefix_cache=True, chunked_prefill=chunked,
              max_prefill_tokens=16)
    if pressured:
        kw.update(kv_bytes=PRESSURE_BYTES, context_capacity=64)
    js, jh, jev = _jax_run(pairs, task_list, **kw)
    ts, th, tev = _port_run(pairs, task_list, **kw)
    for a, b in zip(th, jh):
        assert _trace(a.result) == _trace(b.result)
        np.testing.assert_allclose([s.utility for s in a.result.steps],
                                   [s.utility for s in b.result.steps],
                                   atol=UTILITY_TOL, rtol=0)
        assert (a.prompt_tokens, a.cache_hit_tokens) == \
            (b.prompt_tokens, b.cache_hit_tokens)
    assert (ts.ticks, ts.prefill_chunks, ts.preemptions) == \
        (js.ticks, js.prefill_chunks, js.preemptions)
    assert tev == jev
    assert ts.cache_stats() == js.cache_stats()
    stats = ts.cache_stats()
    assert stats["base"]["hit_tokens"] > 0
    # one lookup an admission, a readmission after preemption included
    assert stats["base"]["lookups"] == len(task_list) + ts.preemptions
    if pressured:
        assert ts.preemptions > 0 and sum(
            s["evicted_blocks"] for s in stats.values()) > 0
    elif chunked and not spec:
        assert tev["defer"] > 0
    ts.clear_prefix_cache()
    assert ts.pool_utilization() == {"base": 0.0, "small": 0.0}


@pytest.mark.parametrize("temperature,spec", [(0.0, False), (0.8, False),
                                              (0.8, True)])
@pytest.mark.parametrize("load", ["best_of_3", "family"])
def test_cache_on_equals_cache_off_in_the_port(pairs, temperature, spec,
                                               load):
    task_list = WORKLOADS[load]()
    on, h_on, _ = _port_run(pairs, task_list, temperature=temperature,
                            spec=spec, prefix_cache=True)
    off, h_off, _ = _port_run(pairs, task_list, temperature=temperature,
                              spec=spec, prefix_cache=False)
    assert [_trace(h.result) for h in h_on] == \
        [_trace(h.result) for h in h_off]
    assert sum(h.cache_hit_tokens for h in h_on) > 0
    assert off.cache_stats() == {} and off.clear_prefix_cache() == 0
    # the hits' prompt tokens were not prefilled: less prefill work
    assert on.base_be.meter.prefill_tokens < off.base_be.meter.prefill_tokens
    assert on.pool_utilization()["base"] > 0.0      # cached blocks held
    assert on.clear_prefix_cache() > 0
    assert on.pool_utilization() == {"base": 0.0, "small": 0.0}
    assert off.pool_utilization() == {"base": 0.0, "small": 0.0}


def test_best_of_n_generators_and_vote(pairs):
    gens = [torch.Generator().manual_seed(s) for s in (7, 8)]
    t = _best_of_n(n=1)
    ex = workload.expand_best_of_n(list(zip(t, gens)), 3)
    assert [task for task, _ in ex] == [t[0]] * 3 + [t[1]] * 3
    seeds = [g.initial_seed() for _, g in ex]
    assert seeds == [workload.sample_seed(s, j) for s in (7, 8)
                     for j in range(3)] and len(set(seeds)) == 6
    with pytest.raises(ValueError):
        workload.expand_best_of_n(list(zip(t, gens)), 0)
    # sampled best-of-N through the scheduler: samples of one prompt
    # diverge, and their vote is the JAX package's rule
    sched = _port_sched(pairs, temperature=0.8)
    handles = [sched.submit(task, generator=g) for task, g in ex]
    sched.drain()
    assert len({tuple(h.result.thinking_ids) for h in handles[:3]}) > 1
    ours = workload.majority_vote(handles, 3)
    theirs = jworkload.majority_vote(handles, 3)
    assert [(v.winner_ids, v.counts, v.agreement, v.survivors)
            for v in ours] == [(v.winner_ids, v.counts, v.agreement,
                                v.survivors) for v in theirs]
    summary = workload.summarize(handles, 1.0)
    assert summary["cache_hit_tokens"] == sum(h.cache_hit_tokens
                                              for h in handles) > 0
    assert 0 < summary["cache_hit_rate"] < 1


def test_template_family_and_common_prefix_rule_match_jax(pairs):
    ours = workload.template_task_family(random.Random(0), 4, shared_ops=6)
    theirs = jworkload.template_task_family(random.Random(0), 4,
                                            shared_ops=6)
    assert [(t.start, t.ops) for t in ours] == \
        [(t.start, t.ops) for t in theirs]
    q0 = tasks.question_tokens(ours[0])
    for t in ours[1:]:
        q = tasks.question_tokens(t)
        assert q[:5 + 4 * 6] == q0[:5 + 4 * 6] and q != q0
    sched = _port_sched(pairs)
    (jb, js), _ = pairs
    jsched = JScheduler(jcontroller.SpecReason(jb, js,
                                               jcontroller.SpecReasonConfig()),
                        jkv.KVManager(jb.model.cfg, js.model.cfg,
                                      jkv.KVBudget(KV_BYTES)), max_batch=3)
    bs = sched.kv.block_size
    p = list(range(100, 100 + 2 * bs + 3))
    cases = [list(p), p[:bs] + [7] * (2 * bs), [9] * len(p)]
    for q in cases + [p[:2 * bs]]:
        for cand in (p, p[:2 * bs]):
            assert sched._common_block_prefix(cand, q) == \
                jsched._common_block_prefix(cand, q)
    assert [sched._common_block_prefix(p, q) for q in cases] == \
        [2 * bs, bs, 0]
    assert sched._common_block_prefix(p[:2 * bs], p) == bs


def test_hit_suffix_prefill_over_adopted_pages_matches_cold(pairs):
    """Zero-copy hit: a row that adopts the cached blocks of another
    row's prompt and prefills only the suffix gives the cold row's
    logits; nothing is copied (the hit row's table holds the owner's
    pages).  The cold prompt is prefilled beside a sibling in one 2-row
    call and the suffix in a 1-row call, so the cached K/V were projected
    at another row count."""
    _, (tb, _) = pairs
    be = BatchEngine(tb.model, tb.params, batch=3, capacity=256)
    cache = RadixCache(be.pool, 8)
    rng = np.random.default_rng(0)
    prompt = [int(t) for t in rng.integers(10, 38, 45)]
    sibling = [int(t) for t in rng.integers(10, 38, 29)]
    cold, sib = PagedSeq(be.pool), PagedSeq(be.pool)
    r0, r2 = be.alloc_row(cold), be.alloc_row(sib)
    be.append_seq(cold, len(prompt))
    be.append_seq(sib, len(sibling))
    be.prefill_rows([r0, r2], [prompt, sibling], [0, 0])
    assert cache.insert(prompt, cold.blocks) == 2
    blocks, hit = cache.match(prompt)
    assert hit == 32 and blocks == cold.blocks[:2]
    seq = PagedSeq(be.pool)
    seq.adopt(blocks, hit)
    r1 = be.adopt_row(seq)
    assert be.pos[r1] == hit
    be.append_seq(seq, len(prompt) - hit)
    be.prefill_rows([r1], [prompt[hit:]], [hit])
    torch.testing.assert_close(be.last_logits[r1], be.last_logits[r0],
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert seq.blocks[:2] == cold.blocks[:2]
    be.free_row(r0)
    be.free_row(r1)
    be.free_row(r2)
    assert cache.clear() == 2 and be.pool.num_used == 0


def test_serve_best_of_n_vote_cli_on_cpu_matches_jax_cli(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    save_random_testbed(ckpt, seed=4)
    argv = ["--scheduler", "continuous", "-n", "2", "--num-samples", "3",
            "--vote", "--batch", "3", "--budget", "16", "--temperature",
            "0", "--threshold", str(THRESHOLD), "--ckpt-dir", ckpt]
    report = serve.main(argv + ["--device", "cpu", "--meters"])
    ours = capsys.readouterr().out
    assert report.stats["prefix_cache"] and report.stats["num_samples"] == 3
    assert report.stats["vote"] and len(report.votes) == 2
    assert report.stats["cache_hit_tokens"] > 0
    assert report.sched.cache_stats()["base"]["hits"] > 0
    jserve.main(argv)
    theirs = capsys.readouterr().out

    def lines(out):
        reqs = [(ln.split("think=")[1].split()[0],
                 ln.split("cache[hit=")[1].split("]")[0],
                 ln.split("answer=")[1])
                for ln in out.splitlines() if ln.startswith("[continuous]")]
        return reqs, [ln for ln in out.splitlines()
                      if ln.startswith("[vote]")]
    assert len(lines(ours)[0]) == 6 and len(lines(ours)[1]) == 2
    assert lines(ours) == lines(theirs)
    assert ", cache " in ours           # the meter line's cache part


def test_cli_flag_checks():
    base = ["--scheduler", "continuous", "--device", "cpu"]
    for argv in (base + ["--num-samples", "0"], base + ["--vote"],
                 ["--num-samples", "2", "--device", "cpu"]):
        with pytest.raises(SystemExit):
            serve.parse_args(argv)
    args = serve.parse_args(base + ["--num-samples", "4", "--vote"])
    assert (args.num_samples, args.vote, args.no_prefix_cache) == \
        (4, True, False)
