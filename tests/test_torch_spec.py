"""Token-level speculative decoding in the port against the JAX package:
the acceptance rule fed the same uniforms and Gumbel noise, the
sequential ``spec_decode`` and the spec-decode schemes (greedy), and,
inside the port, the batched ``BatchSpecEngine`` against the sequential
routine (greedy and sampled, ragged budgets and stop sets).

The JAX package draws its uniforms and noise from key splits; the test
replays its split order to recover the numbers it drew, and hands them
to the port's ``accept_row``.  Decisions and tokens are compared exactly;
utilities at 1e-4 (see tests/test_torch_controller.py).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import testbed as jtestbed
from repro.core import baselines as jbaselines
from repro.core import controller as jcontroller
from repro.core import spec_decode as jspec
from repro.core.policies import StaticThreshold as JThreshold
from repro.models.model import Model as JModel
from repro.sampling import sample as jsample
from repro.serving.engine import Engine as JEngine
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import testbed
from repro_torch.core import baselines, controller
from repro_torch.core import spec_decode as tspec
from repro_torch.core.policies import StaticThreshold
from repro_torch.data import tasks
from repro_torch.models.model import Model
from repro_torch.sampling.sample import SamplingParams
from repro_torch.serving.batch_engine import BatchEngine
from repro_torch.serving.engine import Engine
from repro_torch.serving.spec_engine import BatchSpecEngine, SpecRow
from repro_torch.tokenizer import toy as tk

UTILITY_TOL = 1e-4
V, G = 16, 4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rounds(seed):
    """Six rows of one round: all accepted, accept-then-reject, an
    accepted stop id, g = 0, random, g = 1."""
    rng = np.random.default_rng(seed)
    gs = [4, 4, 2, 0, 3, 1]
    toks = rng.integers(0, V, (len(gs), G)).astype(np.int32)
    logits = rng.standard_normal((len(gs), G, V)).astype(np.float32)
    q = rng.dirichlet(np.ones(V), (len(gs), G)).astype(np.float32)
    bonus = rng.standard_normal((len(gs), V)).astype(np.float32)
    for b, n_ok in ((0, 4), (1, 2), (2, 1), (5, 1)):
        for i in range(n_ok):
            logits[b, i, toks[b, i]] += 12.0
    logits[1, 2, toks[1, 2]] -= 30.0
    stops = [[], [], [int(toks[2, 0])], [], [int(toks[4, 1])], []]
    return gs, toks, logits, q, bonus, stops


def _jax_draws(key, examined):
    """The uniforms and the Gumbel vector the JAX acceptance program drew
    for a sampled row that examined ``examined`` tokens."""
    key = jax.random.split(key)[0]          # the folded post-draft advance
    us = []
    for _ in range(G):
        s = jax.random.split(key)
        us.append(float(jax.random.uniform(s[1])))
        if len(us) <= examined:
            key = s[0]
    noise = jax.random.gumbel(jax.random.split(key)[1], (V,), jnp.float32)
    return torch.tensor(us), torch.tensor(np.asarray(noise))


@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 0),
                                               (1.0, 6)])
@pytest.mark.parametrize("seed", [0, 1])
def test_accept_row_matches_jax_acceptance_step(temperature, top_k, seed):
    gs, toks, logits, q, bonus, stops = _rounds(seed)
    keys = jnp.stack([jax.random.PRNGKey(100 * seed + b)
                      for b in range(len(gs))])
    stop_arr, stop_mask = jspec.build_stop_arrays(stops)
    jsp = jsample.SamplingParams(temperature, top_k)
    suffix, m, n_acc, hit, _ = jspec.acceptance_step(
        jnp.asarray(toks), jnp.asarray(q), jnp.asarray(logits),
        jnp.asarray(bonus), jnp.asarray(gs, jnp.int32), keys,
        jnp.asarray(stop_arr), jnp.asarray(stop_mask),
        jnp.zeros(len(gs), bool), jsp)
    tsp = SamplingParams(temperature, top_k)
    seen = set()
    for b, g in enumerate(gs):
        args = ([int(t) for t in toks[b, :g]], torch.from_numpy(q[b, :g]),
                torch.from_numpy(logits[b, :g]), torch.from_numpy(bonus[b]),
                stops[b], tsp)
        if temperature > 0 and g:
            u, _ = _jax_draws(keys[b], G)
            sfx, acc, stop = tspec.accept_row(*args, u, torch.zeros(V))
            examined = acc if stop or acc == g else acc + 1
            u, noise = _jax_draws(keys[b], examined)
            sfx, acc, stop = tspec.accept_row(*args, u, noise)
        else:
            sfx, acc, stop = tspec.accept_row(*args)
        exp = [int(t) for t in np.asarray(suffix)[b, :int(m[b])]]
        assert (sfx, acc, stop) == (exp, int(n_acc[b]), bool(hit[b])), b
        seen.add("stop" if stop and acc and sfx[-1] == toks[b, acc - 1]
                 else "all" if acc == g else "reject")
    assert seen == {"stop", "all", "reject"}


# ---------------------------------------------------------------------------
# the sequential routine and the schemes, against JAX (greedy)
# ---------------------------------------------------------------------------

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


def _prompt(i):
    return tasks.question_tokens(tasks.sample_task(random.Random(i)))


@pytest.mark.parametrize("budget,stops", [(24, [tk.EOS]),
                                          (40, [tk.STEP, tk.THINK_END])])
def test_sequential_spec_decode_matches_jax(pairs, budget, stops):
    (jb, js), (tb, ts) = pairs
    prompt = _prompt(budget)
    res = {}
    for name, (base, small, key) in {
            "jax": (jb, js, jax.random.PRNGKey(0)),
            "port": (tb, ts, torch.Generator())}.items():
        base.meter.reset()
        b = base.extend(base.new_session(), prompt)
        s = small.extend(small.new_session(), prompt)
        sp = (jsample.SamplingParams() if name == "jax"
              else SamplingParams())
        mod = jspec if name == "jax" else tspec
        stats = mod.SpecDecodeStats()
        kw = {"fused": False} if name == "jax" else {}
        ids, b, s = mod.spec_decode(base, small, b, s, budget, stops, sp,
                                    key, gamma=4, stats=stats, **kw)
        res[name] = ([int(t) for t in ids], b.pos, s.pos, stats.as_dict(),
                     base.meter.spec_rounds, base.meter.spec_accepted)
        last = np.asarray(b.last_logits, np.float32)
        res[name + "_logits"] = last
    assert res["port"] == res["jax"]
    np.testing.assert_allclose(res["port_logits"], res["jax_logits"],
                               rtol=5e-5, atol=5e-5)


METER_KEYS = ("prefill_tokens", "prefill_calls", "decode_tokens",
              "decode_calls", "spec_rounds", "spec_proposed",
              "spec_accepted")


def test_specreason_decode_scheme_matches_jax(pairs):
    (jb, js), (tb, ts) = pairs
    prompt = _prompt(3)
    jcfg = jcontroller.SpecReasonConfig(
        policy=JThreshold(4.5), token_budget=48,
        sampling=jsample.SamplingParams(0.0), fused_decode=False,
        use_spec_decode=True)
    tcfg = controller.SpecReasonConfig(
        policy=StaticThreshold(4.5), token_budget=48,
        sampling=SamplingParams(0.0), use_spec_decode=True)
    jr = jcontroller.SpecReason(jb, js, jcfg).run(prompt,
                                                  jax.random.PRNGKey(0))
    tr = controller.SpecReason(tb, ts, tcfg).run(prompt, torch.Generator())
    assert tr.thinking_ids == jr.thinking_ids
    assert tr.answer_ids == [int(t) for t in jr.answer_ids]
    assert [(s.source, s.accepted) for s in tr.steps] == \
        [(s.source, s.accepted) for s in jr.steps]
    np.testing.assert_allclose([s.utility for s in tr.steps],
                               [s.utility for s in jr.steps],
                               atol=UTILITY_TOL, rtol=0)
    assert tr.spec_stats.as_dict() == jr.spec_stats.as_dict()
    assert tr.spec_stats.rounds > 0
    for name in tr.meters:
        assert {k: tr.meters[name][k] for k in METER_KEYS} == \
            {k: jr.meters[name][k] for k in METER_KEYS}, name


def test_specdecode_baseline_matches_jax(pairs):
    (jb, js), (tb, ts) = pairs
    prompt = _prompt(5)
    jr = jbaselines.spec_decode_reason(jb, js, prompt, jax.random.PRNGKey(0),
                                       32, jsample.SamplingParams(0.0),
                                       fused=False)
    tr = baselines.spec_decode_reason(tb, ts, prompt, torch.Generator(), 32,
                                      SamplingParams(0.0))
    assert tr.thinking_ids == jr.thinking_ids
    assert tr.answer_ids == [int(t) for t in jr.answer_ids]
    assert tr.spec_stats.as_dict() == jr.spec_stats.as_dict()


# ---------------------------------------------------------------------------
# batched == sequential inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_batched_spec_engine_matches_sequential(temperature):
    """Every row of one batched spec-decode call emits what the
    sequential routine emits from the same generator seed: ragged
    budgets and stop sets, rows finishing at different rounds."""
    bm, sm = Model(testbed.MICRO), Model(testbed.MICRO_SMALL)
    bp, spp = bm.init(0, device="cpu"), sm.init(1, device="cpu")
    base, small = Engine(bm, bp, max_len=256), Engine(sm, spp, max_len=256)
    bbe = BatchEngine(bm, bp, batch=4, capacity=256)
    sbe = BatchEngine(sm, spp, batch=4, capacity=256)
    sp = SamplingParams(temperature=temperature)
    prompts = [_prompt(10 + i) for i in range(3)]
    budgets = [17, 6, 25]
    stops = [[tk.EOS], [], [tk.STEP, tk.THINK_END]]
    expect = []
    for i, pr in enumerate(prompts):
        b = base.extend(base.new_session(), pr)
        s = small.extend(small.new_session(), pr)
        stats = tspec.SpecDecodeStats()
        ids, b, s = tspec.spec_decode(base, small, b, s, budgets[i],
                                      stops[i], sp,
                                      torch.Generator().manual_seed(i),
                                      gamma=3, stats=stats)
        expect.append((ids, stats.as_dict(), b.last_logits[0]))
    rows = [(bbe.alloc_row(), sbe.alloc_row()) for _ in prompts]
    bbe.extend_rows([r for r, _ in rows], prompts)
    sbe.extend_rows([r for _, r in rows], prompts)
    items = [SpecRow(br, dr, budgets[i], stops[i],
                     torch.Generator().manual_seed(i))
             for i, (br, dr) in enumerate(rows)]
    outs, stats = BatchSpecEngine(bbe, sbe, gamma=3).decode_rows(items, sp)
    for i, (ids, st, last) in enumerate(expect):
        assert outs[i] == ids and stats[i].as_dict() == st
        torch.testing.assert_close(bbe.last_logits[rows[i][0]], last,
                                   rtol=1e-5, atol=1e-5)
    assert sum(s.rounds for s in stats) == bbe.meter.spec_rounds > 3
