"""The port's fused decode loop (``Engine.generate_fused``) on the CPU,
where its body of masked one-token steps runs eagerly (on the card the
same body is replayed as a CUDA graph: tests/test_torch_cuda.py).

Held to the port's per-token loop (``generate_eager``): tokens, position,
last logits (atol = rtol = 2e-4, as tests/test_engine.py holds the JAX
package's two loops), probabilities (rtol 2e-4, atol 2e-5), Meter counts
and the generator's position, greedy and sampled; a stop inside the
buffer; the budget clamp at the cache's end, whose masked step at
``pos == C`` leaves slot C - 1 as it was; snapshots across a fused call;
pooled KV pairs.  Held to the JAX package's ``generate_fused`` and to
its SpecReason controller with ``fused_decode=True`` from the same
parameters, greedy: tokens, step trace and decisions, logits at 5e-5 and
utilities at 1e-4 (tests/test_torch_engine.py, test_torch_controller.py).
"""

import random

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
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
def pair():
    """The JAX MICRO pair (fused loop, its default) and the port's over
    the same parameters."""
    out = []
    for name, seed in (("MICRO", 0), ("MICRO_SMALL", 1)):
        jm = JModel(getattr(jtestbed, name))
        jp = jm.init(jax.random.PRNGKey(seed))
        tp = tckpt.params_from_numpy(jckpt._flatten(jp), device="cpu")
        out.append((JEngine(jm, jp, max_len=256),
                    Engine(Model(getattr(testbed, name)), tp, max_len=256)))
    return out


def _prompt(n=11, seed=0):
    return [int(t) for t in np.random.default_rng(seed).integers(10, 38, n)]


def _run(eng, fused, sp, calls, seed=3, prompt=None):
    """Two or more consecutive generate calls on one generator; returns
    (per call: ids, probs), the final session, the meter and the
    generator's next draw."""
    gen = torch.Generator().manual_seed(seed)
    s = eng.extend(eng.new_session(), prompt or _prompt())
    eng.meter.reset()
    out = []
    for budget, stops in calls:
        ids, s, probs = eng.generate(s, budget, stops, sp, gen,
                                     collect_probs=True, fused=fused)
        out.append((ids, probs))
    return out, s, eng.meter.as_dict(), torch.rand(4, generator=gen)


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("sp", [SamplingParams(), SAMPLED],
                         ids=["greedy", "sampled"])
def test_fused_matches_eager(pair, which, sp):
    eng = pair[which][1]
    calls = [(20, [tk.EOS]), (13, [tk.STEP, tk.THINK_END]), (3, [])]
    eo, es, em, enext = _run(eng, False, sp, calls)
    fo, fs, fm, fnext = _run(eng, True, sp, calls)
    assert [ids for ids, _ in fo] == [ids for ids, _ in eo]
    assert fs.pos == es.pos == fs.state.pos
    torch.testing.assert_close(fs.last_logits, es.last_logits, **LOOP_TOL)
    for (_, fp), (_, ep) in zip(fo, eo):
        assert len(fp) == len(ep)
        for a, b in zip(fp, ep):
            np.testing.assert_allclose(a, b, **PROBS_TOL)
    assert {k: fm[k] for k in METER_KEYS} == {k: em[k] for k in METER_KEYS}
    assert em["decode_calls"] == em["decode_steps"] == em["decode_tokens"]
    # one metered call each, and whole chunks of steps (k = 8, or the
    # budget's power of two below it: 4 for the 3-token call)
    assert fm["decode_calls"] == len(calls)
    assert fm["decode_steps"] % 4 == 0
    assert 0 <= fm["decode_steps"] - fm["decode_tokens"] \
        < len(calls) * graph_loop.FUSED_CHUNK
    # the generator stands where the per-token loop leaves it
    torch.testing.assert_close(fnext, enext, rtol=0, atol=0)


def test_stop_inside_the_buffer(pair):
    eng = pair[0][1]
    greedy = SamplingParams()
    (free, _), = _run(eng, False, greedy, [(12, [])])[0]
    assert len(free) == 12
    stop_tok = free[5]
    k = free.index(stop_tok)
    (ids, _), = (_run(eng, True, greedy, [(12, [stop_tok])])[0])
    assert ids == free[:k + 1] and ids[-1] == stop_tok
    # the stop token joined the context: the session continues from it
    eo, es, _, _ = _run(eng, False, greedy, [(12, [stop_tok]), (4, [])])
    fo, fs, _, _ = _run(eng, True, greedy, [(12, [stop_tok]), (4, [])])
    assert fs.pos == es.pos == len(_prompt()) + k + 1 + 4
    assert [i for i, _ in fo] == [i for i, _ in eo]
    torch.testing.assert_close(fs.last_logits, es.last_logits, **LOOP_TOL)


def test_budget_clamped_at_capacity(pair):
    """Three slots left: the fused loop decodes three tokens in a chunk of
    four, whose masked last step runs at pos == C and writes back slot
    C - 1 (which holds the third token)."""
    _, t = pair[0]
    eng = Engine(t.model, t.params, max_len=32)
    greedy = SamplingParams()
    cap = 32
    prompt = _prompt(cap - 3, seed=2)
    runs = {}
    for fused, budget in ((False, 3), (True, 50)):
        s = eng.extend(eng.new_session(), prompt)
        ids, s, _ = eng.generate(s, budget, [], greedy, torch.Generator(),
                                 fused=fused)
        runs[fused] = (ids, s, s.state.k.clone(), s.state.v.clone(),
                       eng.meter.decode_steps)
        eng.meter.reset()
    (eids, es, ek, ev, _), (fids, fs, fk, fv, steps) = runs[False], \
        runs[True]
    assert len(fids) == 3 and fids == eids
    assert fs.pos == es.pos == cap and steps == 4
    torch.testing.assert_close(fk[:, :, cap - 1], ek[:, :, cap - 1],
                               rtol=0, atol=0)
    torch.testing.assert_close((fk, fv), (ek, ev), rtol=0, atol=0)
    torch.testing.assert_close(fs.last_logits, es.last_logits, **LOOP_TOL)
    ids, s2, _ = eng.generate(fs, 5, [], greedy, torch.Generator(),
                              fused=True)
    assert ids == [] and s2 is fs


def test_snapshot_survives_a_fused_call(pair):
    """A snapshot taken before a fused call reads the same logits after
    the call, after a truncate back to it and after a rollback to it, and
    decoding again from it gives the first call's tokens."""
    eng = pair[0][1]
    greedy = SamplingParams()
    gen = torch.Generator()
    s0 = eng.extend(eng.new_session(), _prompt())
    snap = s0.snapshot()
    logits0 = snap.last_logits.clone()
    ids, s1, _ = eng.generate(s0, 10, [], greedy, gen, fused=True)
    torch.testing.assert_close(snap.last_logits, logits0, rtol=0, atol=0)
    back = eng.truncate(s1, snap.pos, snap.last_logits)
    again, s2, _ = eng.generate(back, 10, [], greedy, gen, fused=True)
    assert again == ids
    torch.testing.assert_close(s2.last_logits, s1.last_logits, rtol=0,
                               atol=0)
    rolled = eng.rollback(s2, snap)
    torch.testing.assert_close(rolled.last_logits, logits0, rtol=0, atol=0)
    once_more, _, _ = eng.generate(rolled, 10, [], greedy, gen, fused=True)
    assert once_more == ids


def test_new_session_reuses_a_free_pair(pair):
    """A dense engine hands a KV pair out again, zeroed, once no live
    state holds it, and allocates while one does."""
    eng = Engine(pair[0][1].model, pair[0][1].params, max_len=64)
    a = eng.extend(eng.new_session(), _prompt())
    ptr = a.state.k.data_ptr()
    snap = a.snapshot()
    del a
    b = eng.new_session()              # the snapshot still holds the pair
    assert b.state.k.data_ptr() != ptr
    del snap
    c = eng.new_session()
    assert c.state.k.data_ptr() == ptr and not c.state.k.any() \
        and not c.state.v.any()


def test_fused_greedy_matches_jax_fused(pair):
    for je, te in pair:
        for budget, stops in ((20, [tk.EOS]), (9, [tk.STEP])):
            js = je.extend(je.new_session(), _prompt())
            ts = te.extend(te.new_session(), _prompt())
            jids, js, _ = je.generate_fused(js, budget, stops, JSampling(),
                                            jax.random.PRNGKey(0))
            tids, ts, _ = te.generate_fused(ts, budget, stops,
                                            SamplingParams(),
                                            torch.Generator())
            assert tids == [int(t) for t in jids]
            assert ts.pos == js.pos
            np.testing.assert_allclose(ts.last_logits.numpy(),
                                       np.asarray(js.last_logits), **TOL)


@pytest.mark.parametrize("i", [0, 1])
def test_specreason_trace_fused_eager_and_jax(pair, i):
    """A greedy SpecReason request: the port under ``fused_decode`` True
    and False and the JAX controller's fused loop give one step trace."""
    (jb, tb), (js, ts) = pair
    prompt = tasks.question_tokens(tasks.sample_task(random.Random(i)))
    jr = jcontroller.SpecReason(jb, js, jcontroller.SpecReasonConfig(
        policy=JThreshold(4.5), token_budget=48,
        sampling=JSampling(0.0))).run(prompt, jax.random.PRNGKey(i))
    trace = [(s.source, s.accepted, s.tokens) for s in jr.steps]
    for fused in (True, False):
        tr = controller.SpecReason(tb, ts, controller.SpecReasonConfig(
            policy=StaticThreshold(4.5), token_budget=48,
            sampling=SamplingParams(0.0), fused_decode=fused)).run(
            prompt, torch.Generator().manual_seed(i))
        assert tr.thinking_ids == jr.thinking_ids
        assert tr.answer_ids == [int(t) for t in jr.answer_ids]
        assert [(s.source, s.accepted, s.tokens) for s in tr.steps] == trace
        np.testing.assert_allclose([s.utility for s in tr.steps],
                                   [s.utility for s in jr.steps],
                                   atol=UTILITY_TOL, rtol=0)
        calls = tr.meters["small"]["decode_calls"]
        if fused:
            # one call a drafted step (the runs draft every step)
            assert calls == sum(s.source == "small" for s in tr.steps)
        assert tr.meters["small"]["decode_tokens"] == \
            jr.meters["small"]["decode_tokens"]


def test_fused_refused_for_ssm():
    model = Model(arch_config("mamba2-1.3b", reduced=True))
    params = model.init(0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 1"):
        Engine(model, params, fused=True)
    eng = Engine(model, params)
    assert not eng.fused
    s = eng.extend(eng.new_session(), [tk.BOS, tk.THINK])
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 1"):
        eng.generate(s, 4, [], SamplingParams(), torch.Generator(),
                     fused=True)
    ids, _, _ = eng.generate(s, 2, [], SamplingParams(), torch.Generator())
    assert len(ids) == 2


def test_launch_counts_follow_captures(monkeypatch):
    """A wrapper's launch counts at once outside a capture; inside
    ``counts.capturing()`` it goes to the capture's tally, which every
    replay adds; a capture outside ``capturing()`` counts nothing."""
    from repro_torch.kernels import counts

    def kernel():
        pass
    kernel.launches = 0
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    counts.launched(kernel)
    capturing[0] = True
    with counts.capturing() as tally:
        counts.launched(kernel)
        counts.launched(kernel)
    counts.launched(kernel)
    capturing[0] = False
    assert kernel.launches == 1 and tally == {kernel: 2}
    counts.replayed(tally)
    counts.replayed(tally)
    assert kernel.launches == 5
