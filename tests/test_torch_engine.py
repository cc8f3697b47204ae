"""The port's sequential Engine and sampling against the JAX package's:
greedy tokens and Meter counts of the Engine (the JAX per-token loop,
``fused=False``, is the one whose metering the port follows), logit
adjustment, probabilities and Gumbel sampling fed the same numpy noise;
and the port's own rollback rules: ``truncate`` against extend-replay,
and snapshots that share in-place caches (reject-then-redraft and the
verifier's score slot) against fresh runs.

Both packages get the same weights (JAX ``Model.init`` bridged through
numpy).  Tolerances: logits and probabilities atol = rtol = 5e-5 (see
tests/test_torch_model.py); within the port, rollback against a fresh run
atol = rtol = 1e-5 (same code, same shapes; only the cache contents past
the position differ, and those are masked).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import testbed as jtestbed
from repro.models.model import Model as JModel
from repro.sampling import sample as jsample
from repro.serving.engine import Engine as JEngine
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import testbed
from repro_torch.core.verifier import Verifier
from repro_torch.models.model import Model as TModel
from repro_torch.sampling import sample as tsample
from repro_torch.serving.engine import Engine, Meter
from repro_torch.tokenizer import toy as tk

TOL = dict(rtol=5e-5, atol=5e-5)
SELF_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engines(name, seed=0, max_len=256):
    jm = JModel(getattr(jtestbed, name))
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = tckpt.params_from_numpy(jckpt._flatten(jp), device="cpu")
    return (JEngine(jm, jp, max_len=max_len, fused=False),
            Engine(TModel(getattr(testbed, name)), tp, max_len=max_len,
                   fused=False))


def _prompt(n=11, seed=0):
    return [int(t) for t in np.random.default_rng(seed).integers(10, 38, n)]


METER_KEYS = ("prefill_tokens", "prefill_calls", "decode_tokens",
              "decode_calls")


@pytest.mark.parametrize("name", ["MICRO", "SMALL"])
def test_greedy_tokens_and_meters_match_jax(name):
    je, te = _engines(name)
    greedy = jsample.SamplingParams(), tsample.SamplingParams()
    gen = torch.Generator().manual_seed(0)
    js = je.extend(je.new_session(), _prompt())
    ts = te.extend(te.new_session(), _prompt())
    np.testing.assert_allclose(ts.last_logits.numpy(),
                               np.asarray(js.last_logits), **TOL)
    jids, js, _ = je.generate(js, 20, [tk.EOS], greedy[0],
                              jax.random.PRNGKey(0))
    tids, ts, _ = te.generate(ts, 20, [tk.EOS], greedy[1], gen)
    assert tids == jids
    js = je.extend(js, _prompt(5, 1))
    ts = te.extend(ts, _prompt(5, 1))
    jids, js, jprobs = je.generate(js, 12, [tk.STEP, tk.THINK_END],
                                   greedy[0], jax.random.PRNGKey(1),
                                   collect_probs=True)
    tids, ts, tprobs = te.generate(ts, 12, [tk.STEP, tk.THINK_END],
                                   greedy[1], gen, collect_probs=True)
    assert tids == jids and ts.pos == js.pos
    np.testing.assert_array_equal(np.stack(tprobs), np.stack(jprobs))
    np.testing.assert_allclose(ts.last_logits.numpy(),
                               np.asarray(js.last_logits), **TOL)
    jm, tm = je.meter.as_dict(), te.meter.as_dict()
    assert {k: tm[k] for k in METER_KEYS} == {k: jm[k] for k in METER_KEYS}
    assert tm["prefill_tokens"] == 16 + 8       # padded buckets


def test_generate_stop_budget_and_errors():
    _, te = _engines("MICRO")
    sp = tsample.SamplingParams()
    s = te.extend(te.new_session(), _prompt())
    first = int(torch.argmax(s.last_logits[0]))
    ids, s2, _ = te.generate(s, 10, [first], sp, torch.Generator())
    assert ids == [first] and s2.pos == s.pos + 1     # stop id is fed back
    ids, _, _ = te.generate(s, 3, [], sp, torch.Generator())
    assert len(ids) == 3
    with pytest.raises(ValueError, match="prefill before generate"):
        te.generate(te.new_session(), 3, [], sp, torch.Generator())
    with pytest.raises(ValueError, match="bucket max"):
        te.extend(te.new_session(capacity=1024), [1] * 257)
    small = te.new_session(capacity=16)
    with pytest.raises(ValueError, match="context overflow"):
        te.extend(small, [1] * 17)


def test_meter_reset_keeps_types():
    m = Meter(prefill_tokens=3, prefill_time=1.5, decode_calls=2)
    m.reset()
    assert m == Meter() and isinstance(m.prefill_tokens, int) \
        and isinstance(m.decode_time, float)


# ---------------------------------------------------------------------------
# rollback over in-place caches
# ---------------------------------------------------------------------------

def test_truncate_matches_extend_replay():
    _, te = _engines("SMALL")
    a, b, c = _prompt(9, 2), _prompt(6, 3), _prompt(4, 4)
    s = te.extend(te.new_session(), a)
    logits_b, s_ab = te.extend_logits(s, b)
    # roll back two tokens of b, then continue with c
    keep = len(a) + len(b) - 2
    t = te.truncate(s_ab, keep, logits_b[len(b) - 3])
    t = te.extend(t, c)
    fresh = te.extend(te.new_session(), a + b[:-2] + c)
    assert t.pos == fresh.pos
    np.testing.assert_allclose(t.last_logits.numpy(),
                               fresh.last_logits.numpy(), **SELF_TOL)


def test_reject_then_redraft_matches_fresh_run():
    """A snapshot shares its caches with the states after it; a rejected
    draft written past the snapshot must not leak into a redraft."""
    _, te = _engines("SMALL")
    sp = tsample.SamplingParams(temperature=1.0)
    gen = torch.Generator().manual_seed(11)
    prompt = _prompt(10, 5)
    s = te.extend(te.new_session(), prompt)
    snap = s.snapshot()
    draft, s_draft, _ = te.generate(s, 9, [], sp, gen)   # rejected
    s_draft = te.extend(s_draft, _prompt(7, 6))          # and more junk
    redo = te.rollback(s_draft, snap, _prompt(5, 7))     # the redraft
    redo_ids, redo, _ = te.generate(redo, 4, [], tsample.SamplingParams(),
                                    gen)
    fresh = te.extend(te.new_session(), prompt + _prompt(5, 7))
    fresh_ids, fresh, _ = te.generate(fresh, 4, [],
                                      tsample.SamplingParams(), gen)
    assert snap.pos == len(prompt) and redo_ids == fresh_ids
    np.testing.assert_allclose(redo.last_logits.numpy(),
                               fresh.last_logits.numpy(), **SELF_TOL)


def test_verifier_score_slot_is_overwritten_on_accept():
    """The verifier writes the score token past the body of the session
    it hands back; accepting writes the delimiter over that slot."""
    _, te = _engines("MICRO")
    prompt, body = _prompt(8, 8), _prompt(6, 9)
    base = te.extend(te.new_session(), prompt)
    vr = Verifier(te).verify(base, body)
    assert vr.session_after_step.pos == len(prompt) + len(body)
    accepted = te.extend(vr.session_after_step, [tk.STEP])
    fresh = te.extend(te.new_session(), prompt + body + [tk.STEP])
    np.testing.assert_allclose(accepted.last_logits.numpy(),
                               fresh.last_logits.numpy(), **SELF_TOL)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

SAMPLING = [(0.0, 0, 1.0), (0.6, 0, 1.0), (1.0, 5, 1.0), (0.8, 0, 0.7),
            (1.3, 10, 0.9)]


@pytest.mark.parametrize("temperature,top_k,top_p", SAMPLING)
def test_adjust_probs_and_gumbel_sampling_match_jax(temperature, top_k,
                                                    top_p):
    rng = np.random.default_rng(int(temperature * 10) + top_k)
    logits = (rng.standard_normal((6, 64)) * 3).astype(np.float32)
    noise = rng.gumbel(size=(6, 64)).astype(np.float32)
    jp = jsample.SamplingParams(temperature, top_k, top_p)
    tp = tsample.SamplingParams(temperature, top_k, top_p)
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    ja, ta = jsample.adjust_logits(jl, jp), tsample.adjust_logits(tl, tp)
    np.testing.assert_array_equal(np.isinf(ta.numpy()),
                                  np.isinf(np.asarray(ja)))
    np.testing.assert_allclose(tsample.probs_from_logits(tl, tp).numpy(),
                               np.asarray(jsample.probs_from_logits(jl, jp)),
                               **TOL)
    if temperature > 0:
        # jax.random.categorical draws argmax(logits + Gumbel noise)
        exp = np.asarray(jnp.argmax(ja + jnp.asarray(noise), axis=-1))
        got = tsample.categorical(ta, torch.from_numpy(noise)).numpy()
    else:
        exp = np.asarray(jsample.sample(jl, jp, None))
        got = tsample.sample(tl, tp, torch.Generator()).numpy()
    np.testing.assert_array_equal(got, exp)


def test_sample_draws_its_noise_from_the_generator():
    logits = torch.from_numpy(
        np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32))
    sp = tsample.SamplingParams(temperature=0.7, top_k=20)
    got = tsample.sample(logits, sp, torch.Generator().manual_seed(9))
    noise = tsample.gumbel(logits.shape, torch.Generator().manual_seed(9),
                           "cpu")
    exp = tsample.categorical(tsample.adjust_logits(logits, sp), noise)
    assert torch.equal(got, exp)
    g = torch.Generator().manual_seed(9)
    state = g.get_state()
    tsample.sample(logits, tsample.SamplingParams(), g)   # greedy: no draw
    assert torch.equal(g.get_state(), state)
