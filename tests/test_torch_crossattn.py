"""The cross-attention families in the port, on the CPU, against the JAX
package: encdec (whisper-base: an encoder over stub frame embeddings,
every decoder layer cross-attending to it) and vlm (llama-3.2-vision-11b:
groups of dense layers, each followed by a gated cross-attention layer
over stub patch embeddings).

The JAX package's ``reduced()`` configs with the toy vocabulary, and a
vlm variant of 4 layers (two groups) so that the nested stacking runs
more than one group.  Parameters are drawn by the JAX package's
``Model.init`` and carried across by ``params_from_numpy``; the vlm
gates start at zero there (tanh(0) = 0 would hide every cross layer),
so every vlm case here first puts the same nonzero gates, drawn with
numpy, into the JAX parameters.  Stub sources are N(0, 1) x 0.1 from
numpy.  One torch thread.

Held to the JAX package: the spec's keys and shapes; ``encode`` and
``prep_cross``'s K/V; fp32 logits of ``forward``, of ``prefill`` and of
prefill(16) + decode(8) at two rows (atol = rtol = 5e-5, sums in other
orders on each side); greedy tokens of ``Engine.generate``, fused and
per-token, against the JAX ``Engine``'s fused loop; one greedy
SpecReason request (step trace, decisions, tokens, Meter counts;
utilities 1e-4).  Inside the port: decode equals its own forward
(tests/test_models.py's property), rollbacks and the fused loop leave
the cross K/V bit for bit, requests on one engine replay one loop key
over the pooled cross pair, and the batched engine and training refuse
the families.
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
from repro.models.layers import is_spec
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
from repro_torch.serving.batch_engine import BatchEngine
from repro_torch.serving.engine import Engine
from repro_torch.serving.loader import (arch_config, attach_cross_source,
                                        cross_src_len, stub_source)
from repro_torch.tokenizer import toy as tk
from repro_torch.training.loss import loss_fn

ENCDEC, VLM = "whisper-base", "llama-3.2-vision-11b"
CASES = [(ENCDEC, 2), (VLM, 2), (VLM, 4)]
IDS = ["whisper", "vlm", "vlm-2groups"]
TOL = dict(rtol=5e-5, atol=5e-5)
UTILITY_TOL = 1e-4
METER_KEYS = ("prefill_tokens", "prefill_calls", "decode_tokens")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, n_layers=2, seed=0):
    """(JAX model, JAX params, port model, port params): ``arch``'s
    reduced config with the toy vocabulary and ``n_layers``; a vlm
    model's gates drawn nonzero in both."""
    jcfg = dataclasses.replace(jregistry.reduced(arch), name=arch,
                               vocab_size=tk.VOCAB_SIZE, n_layers=n_layers)
    tcfg = dataclasses.replace(arch_config(arch, reduced=True),
                               n_layers=n_layers)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    if jcfg.family == "vlm":
        rng = np.random.default_rng(seed + 10)
        for gate in ("gate_attn", "gate_mlp"):
            shape = jp["cross_layers"][gate].shape
            jp["cross_layers"][gate] = jnp.asarray(
                rng.uniform(0.4, 1.2, shape).astype(np.float32))
    tp = tckpt.params_from_numpy(jckpt._flatten(jp), device="cpu")
    return jm, jp, Model(tcfg), tp


def _source(cfg, batch=1, seed=5):
    """A stub source (batch, S_src, d): N(0, 1) x 0.1 from numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, cross_src_len(cfg), cfg.d_model))
            * 0.1).astype(np.float32)


def _prompt(n=11, seed=0):
    return [int(t) for t in np.random.default_rng(seed).integers(10, 38, n)]


@pytest.fixture(scope="module", params=CASES[:2], ids=IDS[:2])
def engines(request):
    """(JAX engine, port engine, numpy source) over one family's reduced
    config with the same weights; the port's decodes fused by default,
    and neither has its source attached."""
    arch, n = request.param
    jm, jp, tm, tp = _pair(arch, n, seed=3)
    return (JEngine(jm, jp, max_len=64), Engine(tm, tp, max_len=64),
            _source(tm.cfg))


# ---------------------------------------------------------------------------
# the model against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [ENCDEC, VLM])
@pytest.mark.parametrize("size", ["reduced", "published"])
def test_spec_matches_jax(arch, size):
    """Keys, shapes and init rules of ``spec()`` equal the JAX
    package's ``Model.spec()``, at the reduced and published sizes."""
    get = registry.reduced if size == "reduced" else registry.get
    jget = jregistry.reduced if size == "reduced" else jregistry.get
    jspec = jax.tree_util.tree_flatten_with_path(JModel(jget(arch)).spec(),
                                                 is_leaf=is_spec)[0]
    want = {"/".join(p.key for p in path): (s.shape, s.init)
            for path, s in jspec}
    got = {k: (s.shape, s.init) for k, s in Model(get(arch)).spec().items()}
    assert got == want


@pytest.mark.parametrize("arch,n_layers", CASES, ids=IDS)
def test_encode_and_prep_cross_match_jax(arch, n_layers):
    """``encode`` (encdec) and the cached cross K/V of two rows."""
    jm, jp, tm, tp = _pair(arch, n_layers)
    src = _source(tm.cfg, batch=2)
    jsrc, tsrc = jnp.asarray(src), torch.from_numpy(src)
    if tm.cfg.family == "encdec":
        jsrc, tsrc = jm.encode(jp, jsrc), tm.encode(tp, tsrc)
        np.testing.assert_allclose(tsrc.numpy(), np.asarray(jsrc), **TOL)
    n = src.shape[1]
    js = jm.prep_cross(jp, jm.init_state(2, 32, n_cross_src=n), jsrc)
    ts = tm.prep_cross(tp, tm.init_state(2, 32, device="cpu",
                                         n_cross_src=n), tsrc)
    assert ts.cross_k.shape == js.cross_k.shape == (
        tm.cfg.n_cross_layers, 2, n, tm.cfg.n_kv_heads,
        tm.cfg.resolved_head_dim)
    assert ts.k.shape == js.k.shape
    for t, j in ((ts.cross_k, js.cross_k), (ts.cross_v, js.cross_v)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    assert ts.cross_len.tolist() == [n, n]


@pytest.mark.parametrize("arch,n_layers", CASES, ids=IDS)
def test_model_matches_jax(arch, n_layers):
    """Two rows: ``forward`` over 24 tokens; prefill 16, then 8 decodes:
    logits against the JAX package's, the K/V caches, and the port's
    decode against its own forward."""
    jm, jp, tm, tp = _pair(arch, n_layers)
    cfg = tm.cfg
    src = _source(cfg, batch=2)
    key = "encoder_embeds" if cfg.family == "encdec" else "image_embeds"
    toks = np.random.default_rng(1).integers(0, tk.VOCAB_SIZE, (2, 24))
    jl, _ = jax.jit(jm.forward)(jp, jnp.asarray(toks),
                                **{key: jnp.asarray(src)})
    tl = tm.forward(tp, torch.from_numpy(toks),
                    **{key: torch.from_numpy(src)}).detach()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    n = src.shape[1]
    jsrc, tsrc = jnp.asarray(src), torch.from_numpy(src)
    if cfg.family == "encdec":
        jsrc, tsrc = jm.encode(jp, jsrc), tm.encode(tp, tsrc)
    js = jm.prep_cross(jp, jm.init_state(2, 40, n_cross_src=n), jsrc)
    ts = tm.prep_cross(tp, tm.init_state(2, 40, device="cpu",
                                         n_cross_src=n), tsrc)
    a, js = jax.jit(jm.prefill)(jp, jnp.asarray(toks[:, :16]), js)
    b, ts = tm.prefill(tp, torch.from_numpy(toks[:, :16]), ts)
    want, got, own = [np.asarray(a)], [b.numpy()], [tl[:, :16].numpy()]
    decode = jax.jit(jm.decode_step)
    for t in range(16, 24):
        a, js = decode(jp, js, jnp.asarray(toks[:, t:t + 1]))
        b, ts = tm.decode_step(tp, ts, torch.from_numpy(toks[:, t:t + 1]))
        want.append(np.asarray(a)[:, None])
        got.append(b.numpy()[:, None])
        own.append(tl[:, t:t + 1].numpy())
    got = np.concatenate(got, axis=1)
    np.testing.assert_allclose(got, np.concatenate(want, axis=1), **TOL)
    np.testing.assert_allclose(got, np.concatenate(own, axis=1), **TOL)
    assert ts.pos == int(js.pos) == 24
    for t, j in ((ts.k, js.k), (ts.v, js.v)):
        np.testing.assert_allclose(t[:, :, :24].numpy(),
                                   np.asarray(j)[:, :, :24], **TOL)


def test_vlm_gates_start_closed():
    """The port's init keeps the JAX package's rule: the gates start at
    zero, so a fresh vlm model's cross layers add nothing (which is why
    every vlm check here and on the card draws them nonzero)."""
    model = Model(arch_config(VLM, reduced=True))
    params = model.init(0, device="cpu")
    for gate in ("gate_attn", "gate_mlp"):
        assert torch.equal(params["cross_layers"][gate],
                           torch.zeros(model.cfg.n_cross_layers, 1))
    toks = torch.arange(8)[None] % tk.VOCAB_SIZE
    src = stub_source(model.cfg)
    other = torch.randn(src.shape, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(model.forward(params, toks, image_embeds=src),
                               model.forward(params, toks,
                                             image_embeds=other),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the engine and the controller
# ---------------------------------------------------------------------------

def test_engine_greedy_matches_jax(engines):
    """Greedy tokens, position and last logits of ``generate``, fused and
    per-token, against the JAX Engine's fused loop, each from a session
    over the same source."""
    je, te, src = engines
    n = src.shape[1]
    for budget, stops in ((24, [tk.EOS]), (9, [tk.STEP])):
        js = je.extend(je.new_session(n_cross_src=n,
                                      cross_src=jnp.asarray(src)),
                       _prompt())
        jids, js, _ = je.generate_fused(js, budget, stops, JSampling(),
                                        jax.random.PRNGKey(0))
        for fused in (True, False):
            ts = te.extend(te.new_session(cross_src=torch.from_numpy(src)),
                           _prompt())
            tids, ts, _ = te.generate(ts, budget, stops, SamplingParams(),
                                      torch.Generator(), fused=fused)
            assert tids == [int(t) for t in jids]
            assert ts.pos == int(js.pos)
            np.testing.assert_allclose(ts.last_logits.numpy(),
                                       np.asarray(js.last_logits), **TOL)


def test_specreason_trace_matches_jax(engines):
    """A greedy SpecReason request with the family's base (its sessions
    attached to the source, as the JAX package's
    examples/multiarch_smoke.py attaches it) and the MICRO_SMALL
    drafter: the port, fused and per-token, and the JAX controller give
    one step trace, tokens and Meter counts."""
    je, te, src = engines
    n = src.shape[1]
    orig = je.new_session
    jbase = JEngine(je.model, je.params, max_len=64)
    jbase.new_session = lambda: orig(n_cross_src=n,
                                     cross_src=jnp.asarray(src))
    js_m = JModel(jtestbed.MICRO_SMALL)
    js_p = js_m.init(jax.random.PRNGKey(4))
    ts_p = tckpt.params_from_numpy(jckpt._flatten(js_p), device="cpu")
    jsmall = JEngine(js_m, js_p, max_len=64, fused=False)
    prompt = tasks.question_tokens(tasks.sample_task(random.Random(0)))
    jr = jcontroller.SpecReason(jbase, jsmall, jcontroller.SpecReasonConfig(
        policy=JThreshold(4.5), token_budget=16, max_steps=3,
        sampling=JSampling(0.0), fused_decode=False)).run(
        prompt, jax.random.PRNGKey(0))
    trace = [(s.source, s.accepted, s.tokens) for s in jr.steps]
    for fused in (True, False):
        tbase = attach_cross_source(
            Engine(te.model, te.params, max_len=64),
            src=torch.from_numpy(src))
        tsmall = Engine(Model(testbed.MICRO_SMALL), ts_p, max_len=64)
        tr = controller.SpecReason(tbase, tsmall, controller.SpecReasonConfig(
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


def test_rollback_and_fused_loop_leave_cross_kv(engines):
    """A snapshot rollback with replay, a truncate and the fused loop's
    decode calls (masked steps included) leave the cross K/V and their
    lengths bit for bit as ``prep_cross`` wrote them, and the rolled
    back context equals a fresh one."""
    _, te, src = engines
    s0 = te.extend(te.new_session(cross_src=torch.from_numpy(src)),
                   _prompt(7, 1))
    kept = [t.clone() for t in (s0.state.cross_k, s0.state.cross_v,
                                s0.state.cross_len)]
    shot = s0.snapshot()
    assert shot.state.cross_k is s0.state.cross_k
    bad = te.extend(s0, _prompt(9, 2))
    _, bad, _ = te.generate(bad, 5, [], SamplingParams(), torch.Generator())
    redo = te.rollback(bad, shot, _prompt(6, 3))
    fresh = te.extend(te.new_session(cross_src=torch.from_numpy(src)),
                      _prompt(7, 1) + _prompt(6, 3))
    torch.testing.assert_close(redo.last_logits, fresh.last_logits,
                               rtol=1e-5, atol=1e-5)
    _, s, _ = te.generate(redo, 3, [], SamplingParams(), torch.Generator())
    s = te.truncate(s, 9, redo.last_logits)
    _, s, _ = te.generate(s, 4, [], SamplingParams(), torch.Generator())
    for t in (redo.state, s.state):
        for got, want in zip((t.cross_k, t.cross_v, t.cross_len), kept):
            assert torch.equal(got, want)


def test_requests_reuse_one_loop_key(engines):
    """The cross pair is pooled with the KV pair, keyed by (batch,
    capacity, n_cross_src): a second request replays the first one's
    loop key, which ends with the pooled cross pair's and its lengths'
    addresses; a session over another source length takes another
    pair."""
    _, t, src = engines
    eng = attach_cross_source(Engine(t.model, t.params, max_len=64),
                              src=torch.from_numpy(src))
    for i in range(2):
        s = eng.extend(eng.new_session(), _prompt(9, i))
        ids, s, _ = eng.generate(s, 11, [tk.EOS], SamplingParams(),
                                 torch.Generator())
        if i == 0:
            keys = set(eng._loops)
            first = (s.state.cross_k.data_ptr(), s.state.cross_v.data_ptr(),
                     s.state.cross_len.data_ptr())
        del s
    assert set(eng._loops) == keys and len(keys) == 1
    key, = keys
    assert key[-3:] == first
    assert list(eng._kv_pool) == [(1, 64, src.shape[1])]
    assert eng.encodes == (2 if eng.model.cfg.family == "encdec" else 0)
    short = torch.from_numpy(src[:, :5])
    s = Engine.new_session(eng, cross_src=short)
    assert s.state.cross_k.shape[2] == 5 and (1, 64, 5) in eng._kv_pool


def test_cross_state_required_and_batched_path_refused(engines):
    """A cross-attention session without its source is refused at the
    first extend; ``BatchEngine`` and ``loss_fn`` refuse the family with
    the ROADMAP item that will bring it."""
    _, te, _ = engines
    with pytest.raises(ValueError, match="cross source"):
        te.extend(te.new_session(), _prompt())
    with pytest.raises(ValueError, match="item 11"):
        BatchEngine(te.model, te.params, batch=2, capacity=64)
    toks = torch.zeros((1, 8), dtype=torch.long)
    batch = {"tokens": toks, "targets": toks,
             "weights": torch.ones(1, 8)}
    with pytest.raises(NotImplementedError, match="item 10"):
        loss_fn(te.model, te.params, batch)
