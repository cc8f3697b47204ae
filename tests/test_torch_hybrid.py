"""The hybrid family (hymba: windowed GQA attention and a mamba2 mixer side
by side in every layer, their mean added) and a windowed dense model
(starcoder2) in the port, on the CPU, against the JAX package.

The JAX package's ``reduced()`` configs with the toy vocabulary and a
window of 8 (``reduced`` keeps the published 2048 and 4096, which no
small run reaches), hymba also with the window unset.  Parameters are
drawn by the JAX package's ``Model.init`` and carried across by
``params_from_numpy``; one torch thread.

Held to the JAX package: ``forward``, then ``prefill`` of 9 tokens, an
extend of 7 and 12 decodes past the window: logits, K/V caches and the
conv/ssm states at atol = rtol = 2e-5 (fp32 on both sides, sums in
other orders); the fused loop's greedy tokens against the JAX
``Engine``'s (logits 5e-5, as tests/test_torch_fused_ssm.py); one greedy
SpecReason request with the reduced hymba base and a dense drafter
(step trace, decisions, tokens; utilities 1e-4).  Inside the port, as
tests/test_engine.py holds the JAX engine: a padded extend equals
token-wise decode, snapshot / rollback / replay, exact-length extends,
and the fused loop equal to the per-token loop, greedy and at 0.6, with
the window masking keys; requests on one engine replay one loop key.
Also the registry: the three new architectures and the ones it still
refuses.
"""

import dataclasses
import random

import jax
import jax.numpy as jnp
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
from repro_torch.configs import registry, testbed
from repro_torch.core import controller
from repro_torch.core.policies import StaticThreshold
from repro_torch.data import tasks
from repro_torch.models.model import Model
from repro_torch.sampling.sample import SamplingParams
from repro_torch.serving.engine import Engine
from repro_torch.serving.loader import arch_config
from repro_torch.tokenizer import toy as tk

ARCH = "hymba-1.5b"
WINDOW = 8
FP32 = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=5e-5, atol=5e-5)
LOOP_TOL = dict(rtol=2e-4, atol=2e-4)
UTILITY_TOL = 1e-4
METER_KEYS = ("prefill_tokens", "prefill_calls", "decode_tokens")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, window, seed=0):
    """(JAX model, JAX params, port model, port params): ``arch``'s
    reduced config with the toy vocabulary and ``window``."""
    jcfg = dataclasses.replace(jregistry.reduced(arch), name=arch,
                               vocab_size=tk.VOCAB_SIZE,
                               sliding_window=window)
    tcfg = dataclasses.replace(arch_config(arch, reduced=True),
                               sliding_window=window)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, Model(tcfg), tckpt.params_from_numpy(jckpt._flatten(jp),
                                                        device="cpu")


@pytest.fixture(scope="module")
def hymba():
    """(JAX engine, port engine) over the reduced hymba with window 8 and
    the same weights; both decode fused by default."""
    jm, jp, tm, tp = _pair(ARCH, WINDOW, seed=3)
    return JEngine(jm, jp, max_len=64), Engine(tm, tp, max_len=64)


def _prompt(n=11, seed=0):
    return [int(t) for t in np.random.default_rng(seed).integers(10, 38, n)]


def test_registry_has_the_new_archs():
    """``get`` gives the JAX package's configs of the three new archs
    (and of granite-moe, ported since), the others still raise naming
    their family, and the port's reduced hymba is the JAX package's
    field for field."""
    for arch in ("hymba-1.5b", "phi3-mini-3.8b", "starcoder2-7b",
                 "granite-moe-1b-a400m"):
        assert dataclasses.asdict(registry.get(arch)) == \
            dataclasses.asdict(jregistry.get(arch))
    for arch in ("yi-34b", "qwen3-moe-235b-a22b", "whisper-base",
                 "llama-3.2-vision-11b"):
        family = jregistry.get(arch).family
        with pytest.raises(KeyError, match=f"{family} family"):
            registry.get(arch)
    with pytest.raises(KeyError, match="bf16"):
        registry.get("yi-34b")
    red = dataclasses.asdict(registry.reduced(ARCH))
    want = dataclasses.asdict(jregistry.reduced(ARCH))
    assert {k: v for k, v in red.items() if k != "name"} == \
        {k: v for k, v in want.items() if k != "name"}
    assert (red["n_heads"], red["n_kv_heads"], red["ssm_head_dim"],
            red["ssm_chunk"]) == (4, 2, 16, 32) and red["ssm_state"] <= 16
    assert red["sliding_window"] == 2048


@pytest.mark.parametrize("arch,window", [(ARCH, WINDOW), (ARCH, 0),
                                         ("starcoder2-7b", WINDOW)],
                         ids=["hymba-window", "hymba-full", "starcoder2"])
def test_model_matches_jax(arch, window):
    """forward over 28 tokens; prefill 9, extend 7, then 12 decodes past
    the window: logits and the written state against the JAX package."""
    jm, jp, tm, tp = _pair(arch, window)
    assert tm.cfg.family == jm.cfg.family
    toks = np.random.default_rng(1).integers(0, tk.VOCAB_SIZE, (1, 28))
    jl, _ = jax.jit(jm.forward)(jp, jnp.asarray(toks))
    np.testing.assert_allclose(tm.forward(tp, torch.from_numpy(toks))
                               .detach().numpy(), np.asarray(jl), **FP32)
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    js, ts = jm.init_state(1, 40), tm.init_state(1, 40, device="cpu")
    got, want = [], []
    for lo, hi in ((0, 9), (9, 16)):
        a, js = prefill(jp, jnp.asarray(toks[:, lo:hi]), js)
        b, ts = tm.prefill(tp, torch.from_numpy(toks[:, lo:hi]), ts)
        want.append(np.asarray(a)[0])
        got.append(b[0].numpy())
    for t in range(16, 28):
        a, js = decode(jp, js, jnp.asarray(toks[:, t:t + 1]))
        b, ts = tm.decode_step(tp, ts, torch.from_numpy(toks[:, t:t + 1]))
        want.append(np.asarray(a))
        got.append(b.numpy())
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want),
                               **FP32)
    assert ts.pos == int(js.pos) == 28
    pairs = [(ts.k, js.k), (ts.v, js.v)]
    if tm.cfg.has_ssm:
        pairs += [(ts.conv, js.conv), (ts.ssm, js.ssm)]
    for t, j in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **FP32)


def test_hybrid_padded_extend_equals_tokenwise_decode(hymba):
    """One extend of 14 tokens (exact length: SSM state takes no pads)
    equals one token then 13 decodes, past the window."""
    _, eng = hymba
    assert eng.exact_lengths and not eng.can_truncate
    ids = _prompt(14, 4)
    eng.meter.reset()
    s1 = eng.extend(eng.new_session(), ids)
    assert eng.meter.prefill_tokens == 14        # no bucket padding
    s2 = eng.extend(eng.new_session(), ids[:1])
    for t in ids[1:]:
        s2 = eng.decode_one(s2, t)
    assert s1.pos == s2.pos == 14
    for a, b in ((s1.last_logits, s2.last_logits),
                 (s1.state.conv, s2.state.conv),
                 (s1.state.ssm, s2.state.ssm)):
        torch.testing.assert_close(a, b, **LOOP_TOL)


def test_hybrid_snapshot_rollback_replay(hymba):
    """rollback(snapshot, replay) equals a fresh context with the replayed
    tokens; the snapshot shares its tensors (O(1)) and survives; the
    state refuses truncation."""
    _, eng = hymba
    prefix, rejected, replacement = _prompt(7, 1), _prompt(9, 2), \
        _prompt(6, 3)
    snap = eng.extend(eng.new_session(), prefix)
    kept = (snap.state.conv.clone(), snap.state.ssm.clone(),
            snap.last_logits.clone())
    shot = snap.snapshot()
    assert shot.state.k is snap.state.k and shot.state.ssm is snap.state.ssm
    bad = eng.extend(snap, rejected)
    _, bad, _ = eng.generate(bad, 5, [], SamplingParams(),
                             torch.Generator())
    redo = eng.rollback(bad, shot, replacement)
    fresh = eng.extend(eng.new_session(), prefix + replacement)
    assert redo.pos == fresh.pos
    for a, b in ((redo.last_logits, fresh.last_logits),
                 (redo.state.conv, fresh.state.conv),
                 (redo.state.ssm, fresh.state.ssm)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for got, want in zip((snap.state.conv, snap.state.ssm,
                          snap.last_logits), kept):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="SSM"):
        eng.truncate(redo, 3, redo.last_logits)


def _run(eng, fused, sp, calls, seed=3):
    """Consecutive generate calls on one generator from one prompt;
    returns (per call: ids, probs), the final session, the meter and the
    generator's next draw."""
    gen = torch.Generator().manual_seed(seed)
    s = eng.extend(eng.new_session(), _prompt())
    eng.meter.reset()
    out = []
    for budget, stops in calls:
        ids, s, probs = eng.generate(s, budget, stops, sp, gen,
                                     collect_probs=True, fused=fused)
        out.append((ids, probs))
    return out, s, eng.meter.as_dict(), torch.rand(4, generator=gen)


@pytest.mark.parametrize("sp", [SamplingParams(),
                                SamplingParams(temperature=0.6)],
                         ids=["greedy", "sampled"])
def test_hybrid_fused_matches_eager(hymba, sp):
    """The fused loop against the per-token loop from an 11-token prompt
    over 36 tokens, so the window masks keys: tokens, position, logits,
    K/V, conv/ssm, Meter counts and the generator's position."""
    _, eng = hymba
    assert eng.fused
    calls = [(20, [tk.EOS]), (13, [tk.STEP, tk.THINK_END]), (3, [])]
    eo, es, em, enext = _run(eng, False, sp, calls)
    fo, fs, fm, fnext = _run(eng, True, sp, calls)
    assert [ids for ids, _ in fo] == [ids for ids, _ in eo]
    assert fs.pos == es.pos > 11 + WINDOW
    torch.testing.assert_close(fs.last_logits, es.last_logits, **LOOP_TOL)
    n = fs.pos
    for a, b in ((fs.state.k[:, :, :n], es.state.k[:, :, :n]),
                 (fs.state.v[:, :, :n], es.state.v[:, :, :n]),
                 (fs.state.conv, es.state.conv),
                 (fs.state.ssm, es.state.ssm)):
        torch.testing.assert_close(a, b, **LOOP_TOL)
    for (_, fp), (_, ep) in zip(fo, eo):
        assert len(fp) == len(ep)
        for a, b in zip(fp, ep):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    assert {k: fm[k] for k in METER_KEYS} == {k: em[k] for k in METER_KEYS}
    assert fm["decode_calls"] == len(calls)
    torch.testing.assert_close(fnext, enext, rtol=0, atol=0)


def test_hybrid_requests_reuse_one_loop_key(hymba):
    """A hybrid session's K/V pair comes from the engine's pool and its
    conv/ssm are its own: a second request replays the first one's loop
    key, which names the pooled pair and the static conv/ssm pair."""
    _, t = hymba
    eng = Engine(t.model, t.params, max_len=64)
    for i in range(2):
        s = eng.extend(eng.new_session(), _prompt(9, i))
        ids, s, _ = eng.generate(s, 11, [tk.EOS], SamplingParams(),
                                 torch.Generator())
        if i == 0:
            keys = set(eng._loops)
            first = (s.state.k.data_ptr(), s.state.v.data_ptr())
        del s
    assert set(eng._loops) == keys and len(keys) == 1
    static = eng._ssm_static[1]
    key, = keys
    assert key[:2] == first and \
        key[-2:] == (static.conv.data_ptr(), static.ssm.data_ptr())
    pool, = eng._kv_pool.values()
    assert len(pool) == 1


def test_hybrid_fused_greedy_matches_jax_engine(hymba):
    je, te = hymba
    for budget, stops in ((24, [tk.EOS]), (9, [tk.STEP])):
        js = je.extend(je.new_session(), _prompt())
        ts = te.extend(te.new_session(), _prompt())
        jids, js, _ = je.generate_fused(js, budget, stops, JSampling(),
                                        jax.random.PRNGKey(0))
        tids, ts, _ = te.generate(ts, budget, stops, SamplingParams(),
                                  torch.Generator())
        assert tids == [int(t) for t in jids]
        assert ts.pos == js.pos
        np.testing.assert_allclose(ts.last_logits.numpy(),
                                   np.asarray(js.last_logits), **TOL)
        np.testing.assert_allclose(ts.state.ssm.numpy(),
                                   np.asarray(js.state.ssm), **TOL)


def test_hybrid_specreason_trace_matches_jax(hymba):
    """A greedy SpecReason request on the reduced hymba base with the
    MICRO_SMALL drafter: the port, fused and per-token, and the JAX
    controller give one step trace (the base rolls back by snapshot)."""
    je, te = hymba
    js_m = JModel(jtestbed.MICRO_SMALL)
    js_p = js_m.init(jax.random.PRNGKey(4))
    ts_p = tckpt.params_from_numpy(jckpt._flatten(js_p), device="cpu")
    jsmall = JEngine(js_m, js_p, max_len=64, fused=False)
    tsmall = Engine(Model(testbed.MICRO_SMALL), ts_p, max_len=64)
    prompt = tasks.question_tokens(tasks.sample_task(random.Random(0)))
    jr = jcontroller.SpecReason(je, jsmall, jcontroller.SpecReasonConfig(
        policy=JThreshold(4.5), token_budget=16, max_steps=3,
        sampling=JSampling(0.0), fused_decode=False)).run(
        prompt, jax.random.PRNGKey(0))
    trace = [(s.source, s.accepted, s.tokens) for s in jr.steps]
    for fused in (True, False):
        tr = controller.SpecReason(te, tsmall, controller.SpecReasonConfig(
            policy=StaticThreshold(4.5), token_budget=16, max_steps=3,
            sampling=SamplingParams(0.0), fused_decode=fused)).run(
            prompt, torch.Generator().manual_seed(0))
        assert tr.thinking_ids == jr.thinking_ids
        assert tr.answer_ids == [int(t) for t in jr.answer_ids]
        assert [(s.source, s.accepted, s.tokens) for s in tr.steps] == trace
        np.testing.assert_allclose([s.utility for s in tr.steps],
                                   [s.utility for s in jr.steps],
                                   atol=UTILITY_TOL, rtol=0)
        for name in tr.meters:
            assert {k: tr.meters[name][k] for k in METER_KEYS} == \
                {k: jr.meters[name][k] for k in METER_KEYS}, name
