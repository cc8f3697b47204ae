"""The port's fused decode loop (``Engine.generate_fused``) on an ssm
(mamba2) model, on the CPU, where its body of masked one-token steps
runs eagerly over the engine's static conv/ssm pair (on the card the same
body is replayed as a CUDA graph: tests/test_torch_cuda.py).

The reduced mamba2-1.3b with the toy vocabulary, one torch thread.  Held
to the port's per-token loop (``generate_eager``): tokens, position,
Meter counts and the generator's position exactly; probabilities rtol
2e-4, atol 2e-5; last logits and the conv/ssm state atol = rtol = 2e-4
(as tests/test_torch_fused.py holds the dense loops).  A masked step
leaves the state exactly as it was; a snapshot taken before a fused call
survives it; requests on one engine replay one loop key.  Held to the
JAX package's ``generate_fused`` (tokens, logits at 5e-5) and to its
SpecReason controller (step trace, decisions, utilities at 1e-4) from
the same parameters, greedy.
"""

import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import registry as jregistry
from repro.configs import testbed as jtestbed
from repro.core import controller as jcontroller
from repro.core.policies import StaticThreshold as JThreshold
from repro.models.model import Model as JModel
from repro.sampling.sample import SamplingParams as JSampling
from repro.serving.engine import Engine as JEngine
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import testbed
from repro_torch.core import controller
from repro_torch.core.policies import StaticThreshold
from repro_torch.data import tasks
from repro_torch.models.model import Model
from repro_torch.sampling.sample import SamplingParams
from repro_torch.serving import graph_loop
from repro_torch.serving.engine import Engine
from repro_torch.serving.loader import arch_config
from repro_torch.tokenizer import toy as tk

ARCH = "mamba2-1.3b"
LOOP_TOL = dict(rtol=2e-4, atol=2e-4)
PROBS_TOL = dict(rtol=2e-4, atol=2e-5)
TOL = dict(rtol=5e-5, atol=5e-5)
UTILITY_TOL = 1e-4
SAMPLED = SamplingParams(temperature=0.8, top_k=20, top_p=0.95)
METER_KEYS = ("prefill_tokens", "prefill_calls", "decode_tokens")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(JAX engine, port engine) over the reduced mamba2-1.3b with the toy
    vocabulary and the same weights; both decode fused by default."""
    jcfg = dataclasses.replace(jregistry.reduced(ARCH),
                               vocab_size=tk.VOCAB_SIZE, name=ARCH)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    tp = tckpt.params_from_numpy(jckpt._flatten(jp), device="cpu")
    return (JEngine(jm, jp, max_len=256),
            Engine(Model(arch_config(ARCH, reduced=True)), tp, max_len=256))


def _prompt(n=11, seed=0):
    return [int(t) for t in np.random.default_rng(seed).integers(10, 38, n)]


def _run(eng, fused, sp, calls, seed=3, prompt=None):
    """Consecutive generate calls on one generator; returns (per call:
    ids, probs), the final session, the meter and the generator's next
    draw."""
    gen = torch.Generator().manual_seed(seed)
    s = eng.extend(eng.new_session(), prompt or _prompt())
    eng.meter.reset()
    out = []
    for budget, stops in calls:
        ids, s, probs = eng.generate(s, budget, stops, sp, gen,
                                     collect_probs=True, fused=fused)
        out.append((ids, probs))
    return out, s, eng.meter.as_dict(), torch.rand(4, generator=gen)


def test_ssm_engine_defaults_to_the_fused_loop(models):
    """``Engine(model)`` on mamba2 decodes fused, ``fused=True`` is
    accepted, and ``generate`` goes through ``generate_fused``: one
    metered call of whole chunks of steps."""
    _, eng = models
    assert eng.fused and eng.model.cfg.has_ssm
    assert Engine(eng.model, eng.params, fused=True).fused
    s = eng.extend(eng.new_session(), _prompt())
    eng.meter.reset()
    ids, s2, _ = eng.generate(s, 13, [], SamplingParams(),
                              torch.Generator())
    m = eng.meter
    assert len(ids) == 13 and s2.pos == s.pos + 13
    assert m.decode_calls == 1 and m.decode_tokens == 13
    assert m.decode_steps == 16          # two chunks of k = 8
    assert m.decode_syncs == 0           # the CPU reads no pinned status


@pytest.mark.parametrize("sp", [SamplingParams(), SAMPLED],
                         ids=["greedy", "sampled"])
def test_ssm_fused_matches_eager(models, sp):
    _, eng = models
    calls = [(20, [tk.EOS]), (13, [tk.STEP, tk.THINK_END]), (3, [])]
    eo, es, em, enext = _run(eng, False, sp, calls)
    fo, fs, fm, fnext = _run(eng, True, sp, calls)
    assert [ids for ids, _ in fo] == [ids for ids, _ in eo]
    assert fs.pos == es.pos == fs.state.pos
    torch.testing.assert_close(fs.last_logits, es.last_logits, **LOOP_TOL)
    torch.testing.assert_close(fs.state.conv, es.state.conv, **LOOP_TOL)
    torch.testing.assert_close(fs.state.ssm, es.state.ssm, **LOOP_TOL)
    for (_, fp), (_, ep) in zip(fo, eo):
        assert len(fp) == len(ep)
        for a, b in zip(fp, ep):
            np.testing.assert_allclose(a, b, **PROBS_TOL)
    assert {k: fm[k] for k in METER_KEYS} == {k: em[k] for k in METER_KEYS}
    assert em["decode_calls"] == em["decode_steps"] == em["decode_tokens"]
    assert fm["decode_calls"] == len(calls)
    assert fm["decode_steps"] % 4 == 0
    assert 0 <= fm["decode_steps"] - fm["decode_tokens"] \
        < len(calls) * graph_loop.FUSED_CHUNK
    # the generator stands where the per-token loop leaves it
    torch.testing.assert_close(fnext, enext, rtol=0, atol=0)


def test_ssm_stop_inside_the_buffer(models):
    _, eng = models
    greedy = SamplingParams()
    (free, _), = _run(eng, False, greedy, [(12, [])])[0]
    stop_tok = free[5]
    k = free.index(stop_tok)
    (ids, _), = _run(eng, True, greedy, [(12, [stop_tok])])[0]
    assert ids == free[:k + 1] and ids[-1] == stop_tok
    # the stop token joined the state: the session continues from it
    eo, es, _, _ = _run(eng, False, greedy, [(12, [stop_tok]), (4, [])])
    fo, fs, _, _ = _run(eng, True, greedy, [(12, [stop_tok]), (4, [])])
    assert fs.pos == es.pos == len(_prompt()) + k + 1 + 4
    assert [i for i, _ in fo] == [i for i, _ in eo]
    torch.testing.assert_close(fs.state.ssm, es.state.ssm, **LOOP_TOL)
    torch.testing.assert_close(fs.last_logits, es.last_logits, **LOOP_TOL)


def test_ssm_budget_is_not_clamped_to_capacity(models):
    """SSM state has no positional capacity (``capacity`` 0): the fused
    loop decodes the whole budget, also past the engine's max_len."""
    _, t = models
    eng = Engine(t.model, t.params, max_len=16)
    s = eng.extend(eng.new_session(capacity=8), _prompt(12, 2))
    assert s.state.capacity == 0
    greedy = SamplingParams()
    fids, fs, _ = eng.generate(s, 21, [], greedy, torch.Generator(),
                               fused=True)
    eids, es, _ = eng.generate(s, 21, [], greedy, torch.Generator(),
                               fused=False)
    assert len(fids) == 21 and fids == eids
    assert fs.pos == es.pos == 12 + 21
    torch.testing.assert_close(fs.last_logits, es.last_logits, **LOOP_TOL)


def test_ssm_masked_step_leaves_the_state_as_it_was(models):
    """The loop's in-place step (``decode_step`` with ``active``): masked,
    the conv and ssm tensors keep every bit and the position stays;
    active, they hold what the new-tensor step returns, bit for bit."""
    _, eng = models
    m, p = eng.model, eng.params
    s = eng.extend(eng.new_session(), _prompt())
    tok = torch.tensor([[17]])
    want_logits, want = m.decode_step(p, s.state, tok)
    for on in (False, True):
        st = dataclasses.replace(s.state, conv=s.state.conv.clone(),
                                 ssm=s.state.ssm.clone(),
                                 pos=torch.tensor(s.pos))
        conv, ssm = st.conv, st.ssm
        logits, got = m.decode_step(p, st, tok, active=torch.tensor(on))
        assert got.conv is conv and got.ssm is ssm      # in place
        assert int(got.pos) == s.pos + on
        if on:
            torch.testing.assert_close(logits, want_logits, rtol=0, atol=0)
            assert torch.equal(conv, want.conv) and \
                torch.equal(ssm, want.ssm)
        else:
            assert torch.equal(conv, s.state.conv) and \
                torch.equal(ssm, s.state.ssm)


def test_ssm_snapshot_survives_a_fused_call(models):
    """A snapshot taken before a fused call keeps its conv/ssm tensors
    and logits; the returned session holds fresh tensors, not the
    engine's static pair; rollback + replay equals a fresh extend."""
    _, eng = models
    prompt = _prompt(10, 5)
    s = eng.extend(eng.new_session(), prompt)
    snap = s.snapshot()
    assert snap.state.ssm is s.state.ssm          # O(1): shared, not copied
    before = (snap.state.conv.clone(), snap.state.ssm.clone(),
              snap.last_logits.clone())
    ids, s1, _ = eng.generate(s, 9, [], SamplingParams(1.0),
                              torch.Generator().manual_seed(11), fused=True)
    static = eng._ssm_static[1]
    assert s1.state.ssm.data_ptr() != static.ssm.data_ptr() and \
        s1.state.conv.data_ptr() != static.conv.data_ptr()
    kept = s1.state.ssm.clone()
    eng.generate(s1, 5, [], SamplingParams(), torch.Generator(), fused=True)
    assert torch.equal(s1.state.ssm, kept)        # the next call wrote none
    for got, want in zip((snap.state.conv, snap.state.ssm,
                          snap.last_logits), before):
        assert torch.equal(got, want)
    redo = eng.rollback(s1, snap, _prompt(5, 7))
    fresh = eng.extend(eng.new_session(), prompt + _prompt(5, 7))
    assert redo.pos == fresh.pos
    for got, want in ((redo.last_logits, fresh.last_logits),
                      (redo.state.conv, fresh.state.conv),
                      (redo.state.ssm, fresh.state.ssm)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
    # decoding again from the restored snapshot gives the first call's ids
    again, _, _ = eng.generate(eng.rollback(s1, snap), 9, [],
                               SamplingParams(1.0),
                               torch.Generator().manual_seed(11), fused=True)
    assert again == ids


def test_ssm_requests_reuse_one_loop_key(models):
    """Every ssm request allocates new state, but the loop is keyed by the
    engine's static pair: a second request adds no key."""
    _, t = models
    eng = Engine(t.model, t.params, max_len=256)
    greedy = SamplingParams()
    for i in range(2):
        s = eng.extend(eng.new_session(), _prompt(9, i))
        eng.generate(s, 11, [tk.EOS], greedy, torch.Generator())
        if i == 0:
            keys = set(eng._loops)
    assert set(eng._loops) == keys and len(keys) == 1
    assert list(eng._ssm_static) == [1]
    static = eng._ssm_static[1]
    assert {key[:2] for key in keys} == \
        {(static.conv.data_ptr(), static.ssm.data_ptr())}


def test_ssm_fused_greedy_matches_jax_fused(models):
    je, te = models
    for budget, stops in ((20, [tk.EOS]), (9, [tk.STEP])):
        js = je.extend(je.new_session(), _prompt())
        ts = te.extend(te.new_session(), _prompt())
        jids, js, _ = je.generate_fused(js, budget, stops, JSampling(),
                                        jax.random.PRNGKey(0))
        tids, ts, _ = te.generate_fused(ts, budget, stops, SamplingParams(),
                                        torch.Generator())
        assert tids == [int(t) for t in jids]
        assert ts.pos == js.pos
        np.testing.assert_allclose(ts.last_logits.numpy(),
                                   np.asarray(js.last_logits), **TOL)
        np.testing.assert_allclose(ts.state.ssm.numpy(),
                                   np.asarray(js.state.ssm), **TOL)


@pytest.mark.parametrize("i", [0, 1])
def test_ssm_specreason_trace_fused_eager_and_jax(models, i):
    """A greedy SpecReason request on the reduced mamba2 base with the
    MICRO_SMALL drafter: the port under ``fused_decode`` True and False
    and the JAX controller give one step trace."""
    je, te = models
    js_m = JModel(jtestbed.MICRO_SMALL)
    js_p = js_m.init(jax.random.PRNGKey(4))
    ts_p = tckpt.params_from_numpy(jckpt._flatten(js_p), device="cpu")
    jsmall = JEngine(js_m, js_p, max_len=512, fused=False)
    tsmall = Engine(Model(testbed.MICRO_SMALL), ts_p, max_len=512)
    jbase = JEngine(je.model, je.params, max_len=256, fused=False)
    prompt = tasks.question_tokens(tasks.sample_task(random.Random(i)))
    jr = jcontroller.SpecReason(jbase, jsmall, jcontroller.SpecReasonConfig(
        policy=JThreshold(4.5), token_budget=32, max_steps=4,
        sampling=JSampling(0.0), fused_decode=False)).run(
        prompt, jax.random.PRNGKey(i))
    trace = [(s.source, s.accepted, s.tokens) for s in jr.steps]
    for fused in (True, False):
        te.meter.reset()
        tr = controller.SpecReason(te, tsmall, controller.SpecReasonConfig(
            policy=StaticThreshold(4.5), token_budget=32, max_steps=4,
            sampling=SamplingParams(0.0), fused_decode=fused)).run(
            prompt, torch.Generator().manual_seed(i))
        assert tr.thinking_ids == jr.thinking_ids
        assert tr.answer_ids == [int(t) for t in jr.answer_ids]
        assert [(s.source, s.accepted, s.tokens) for s in tr.steps] == trace
        np.testing.assert_allclose([s.utility for s in tr.steps],
                                   [s.utility for s in jr.steps],
                                   atol=UTILITY_TOL, rtol=0)
        for name in tr.meters:
            assert {k: tr.meters[name][k] for k in METER_KEYS} == \
                {k: jr.meters[name][k] for k in METER_KEYS}, name
        base_calls = tr.meters["base"]["decode_calls"]
        if fused:       # one call a regenerated step and the answer
            assert base_calls <= len(tr.steps) + 1
        else:
            assert base_calls == tr.meters["base"]["decode_tokens"]
