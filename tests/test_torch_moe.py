"""The moe family (granite-moe) in the port, on the CPU, against the JAX
package.

The JAX package's ``reduced()`` granite (2 layers, 4 experts, top-2)
with the toy vocabulary; parameters drawn by the JAX package's
``Model.init`` and carried across by ``params_from_numpy``; inputs made
with numpy from fixed seeds; one torch thread.

Held to the JAX package: the router and the layer (``route``,
``apply_moe``) at the default capacity and at ``capacity_factor`` 0.25,
where choices are dropped, and on router probabilities with exact ties
(the dispatch and combine tensors rebuilt from the port's experts,
positions and keep mask: dispatch equal, combine and y at 2e-5); the
model's forward logits and aux terms, prefill 9, extend 7 and 12 decodes
(2e-5); the ``Engine``'s greedy tokens and a greedy SpecReason trace; the
``BatchEngine`` call for call (3 rows of 4, an uninvolved slot: extends
of unequal lengths, decodes, a verification extend, a truncate and a
feed; logits 2e-5), also at 0.25, where the rows are coupled through
capacity; the continuous scheduler with spec decode and the prefix cache
on (traces, ticks, tokens); the loss, its aux metrics and every gradient
(1e-5 of each tensor's largest).  Inside the port: fused == per-token,
greedy and at 0.8; continuous == sequential greedy where no choice is
dropped (asserted); the registry's configs.
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
from repro.data import pipeline as jpipeline
from repro.models import moe as jmoe
from repro.models.model import Model as JModel
from repro.sampling.sample import SamplingParams as JSampling
from repro.serving import kv_manager as jkv
from repro.serving.batch_engine import BatchEngine as JBatchEngine
from repro.serving.engine import Engine as JEngine
from repro.serving.scheduler import ContinuousScheduler as JScheduler
from repro.training import loss as jloss
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import registry, testbed
from repro_torch.core import controller
from repro_torch.core.policies import StaticThreshold
from repro_torch.data import tasks
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, flatten, unflatten
from repro_torch.sampling.sample import SamplingParams
from repro_torch.serving import kv_manager as tkv
from repro_torch.serving.batch_engine import BatchEngine
from repro_torch.serving.engine import Engine
from repro_torch.serving.loader import arch_config
from repro_torch.serving.scheduler import ContinuousScheduler
from repro_torch.tokenizer import toy as tk
from repro_torch.training import loss as tloss

ARCH = "granite-moe-1b-a400m"
FP32 = dict(rtol=2e-5, atol=2e-5)
LOOP_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = 1e-5
UTILITY_TOL = 1e-4
THRESHOLD = 4.5
METER_KEYS = ("prefill_tokens", "prefill_calls", "decode_tokens")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(**over):
    """The JAX package's and the port's reduced granite, toy vocabulary,
    with ``over`` on both."""
    jcfg = dataclasses.replace(jregistry.reduced(ARCH), name=ARCH,
                               vocab_size=tk.VOCAB_SIZE, **over)
    tcfg = dataclasses.replace(arch_config(ARCH, reduced=True), **over)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jcfg, tcfg


def _pair(seed=0, **over):
    """(JAX model, JAX params, port model, port params)."""
    jcfg, tcfg = _configs(**over)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, Model(tcfg), tckpt.params_from_numpy(jckpt._flatten(jp),
                                                        device="cpu")


class _Drops:
    """Records the largest ``dropped_frac`` of every port routing while
    installed (``monkeypatch`` on ``models.moe.route``)."""

    def __init__(self, monkeypatch):
        self.most, self.calls = 0.0, 0
        real = tmoe.route

        def route(logits, cfg, capacity):
            out = real(logits, cfg, capacity)
            self.most = max(self.most, float(out[-1]["dropped_frac"]))
            self.calls += 1
            return out
        monkeypatch.setattr(tmoe, "route", route)


def _prompt(n=11, seed=0):
    return [int(t) for t in np.random.default_rng(seed).integers(10, 38, n)]


# ---------------------------------------------------------------------------
# the router and the layer
# ---------------------------------------------------------------------------

def _moe_params(rng, cfg):
    """The layer's parameters at the init's scale, 1 / sqrt(fan-in)."""
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.d_ff
    shapes = {"router": ((d, e), d), "w_gate": ((e, d, ff), d),
              "w_up": ((e, d, ff), d), "w_down": ((e, ff, d), ff)}
    return {n: (rng.standard_normal(s) / np.sqrt(fan)).astype(np.float32)
            for n, (s, fan) in shapes.items()}


def _dispatch(cfg, experts, pos, keep, gates, capacity):
    """The reference's one-hot dispatch and gate-weighted combine
    (G, S, E, C), rebuilt from the port's routing."""
    oh_e = torch.nn.functional.one_hot(experts, cfg.n_experts).float()
    oh_c = torch.nn.functional.one_hot(pos.clamp(max=capacity - 1),
                                       capacity).float() * keep[..., None]
    return (torch.einsum("gske,gskc->gsec", oh_e, oh_c),
            torch.einsum("gske,gskc,gsk->gsec", oh_e, oh_c, gates))


@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_route_and_layer_match_jax(cf, ties):
    """``route`` (dispatch positions and keep masks as the reference's
    dispatch, gates as its combine) and ``apply_moe`` (y, aux) against
    the JAX package; at 0.25 choices are dropped.  With ``ties`` the
    router's columns repeat in pairs, so every token's probabilities tie
    exactly: the lower expert is chosen first, as ``jax.lax.top_k``
    does; the layer then runs with a zero router (every probability
    1/E: experts 0 and 1 for every token)."""
    jcfg, tcfg = _configs(capacity_factor=cf)
    rng = np.random.default_rng(int(cf * 100) + ties)
    p = _moe_params(rng, jcfg)
    x = rng.standard_normal((3, 20, jcfg.d_model)).astype(np.float32)
    g, s = 3, 20
    logits = x.reshape(g, s, -1) @ p["router"]
    if ties:
        logits[..., 1::2] = logits[..., 0::2]
        p["router"][:] = 0.0
    cap = jmoe.group_capacity(s, jcfg)
    assert tmoe.group_capacity(s, tcfg) == cap
    jd, jc, jaux = jmoe.route(jnp.asarray(logits), jcfg, cap)
    experts, pos, keep, gates, taux = tmoe.route(torch.from_numpy(logits),
                                                 tcfg, cap)
    td, tc = _dispatch(tcfg, experts, pos, keep, gates, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **FP32)
    if ties:        # the tied pair, the lower expert first
        assert torch.all(experts[..., 0] % 2 == 0)
        assert torch.all(experts[..., 1] == experts[..., 0] + 1)
    yj, auxj = jmoe.apply_moe(jnp.asarray(x),
                              {n: jnp.asarray(a) for n, a in p.items()}, jcfg)
    yt, auxt = tmoe.apply_moe(torch.from_numpy(x),
                              {n: torch.from_numpy(a) for n, a in p.items()},
                              tcfg)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **FP32)
    for k in ("load_balance", "router_z", "dropped_frac"):
        np.testing.assert_allclose(float(auxt[k]), float(auxj[k]), **FP32)
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), **FP32)
    if cf < 1:
        assert float(auxt["dropped_frac"]) > 0


def test_group_size_halves_until_it_divides():
    _, cfg = _configs()
    assert cfg.moe_group_size == 512
    assert [tmoe.group_size(t, cfg) for t in (1, 48, 512, 1024, 1536,
                                              600, 4 * 257)] == \
        [1, 48, 512, 512, 512, 8, 4]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_model_matches_jax():
    """forward over 28 tokens (logits and the layers' mean aux terms);
    prefill 9, extend 7, then 12 decodes: logits and K/V caches."""
    jm, jp, tm, tp = _pair(seed=1)
    assert tm.cfg.family == "moe" and set(tp["layers"]) == \
        {"ln1", "attn", "ln2", "moe"}
    toks = np.random.default_rng(1).integers(0, tk.VOCAB_SIZE, (2, 28))
    jl, jaux = jax.jit(jm.forward)(jp, jnp.asarray(toks))
    tl, taux = tm.forward_aux(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **FP32)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), **FP32)
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    js, ts = jm.init_state(1, 40), tm.init_state(1, 40, device="cpu")
    got, want = [], []
    for lo, hi in ((0, 9), (9, 16)):
        a, js = prefill(jp, jnp.asarray(toks[:1, lo:hi]), js)
        b, ts = tm.prefill(tp, torch.from_numpy(toks[:1, lo:hi]), ts)
        want.append(np.asarray(a)[0])
        got.append(b[0].numpy())
    for t in range(16, 28):
        a, js = decode(jp, js, jnp.asarray(toks[:1, t:t + 1]))
        b, ts = tm.decode_step(tp, ts, torch.from_numpy(toks[:1, t:t + 1]))
        want.append(np.asarray(a))
        got.append(b.numpy())
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want),
                               **FP32)
    for t, j in ((ts.k, js.k), (ts.v, js.v)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **FP32)


@pytest.fixture(scope="module")
def granite():
    """(JAX engine, port engine) over the reduced granite and the same
    weights; the port's decodes fused by default."""
    jm, jp, tm, tp = _pair(seed=3)
    return JEngine(jm, jp, max_len=64), Engine(tm, tp, max_len=64)


def test_engine_greedy_matches_jax(granite):
    """Bucket-padded extends (the pads take capacity, as in the JAX
    ``Engine``) and the fused loop's greedy tokens against the JAX
    ``Engine``'s."""
    je, te = granite
    for budget, stops in ((24, [tk.EOS]), (9, [tk.STEP])):
        js = je.extend(je.new_session(), _prompt())
        ts = te.extend(te.new_session(), _prompt())
        np.testing.assert_allclose(ts.last_logits.numpy(),
                                   np.asarray(js.last_logits), **FP32)
        jids, js, _ = je.generate_fused(js, budget, stops, JSampling(),
                                        jax.random.PRNGKey(0))
        tids, ts, _ = te.generate(ts, budget, stops, SamplingParams(),
                                  torch.Generator())
        assert tids == [int(t) for t in jids]
        assert ts.pos == js.pos
        np.testing.assert_allclose(ts.last_logits.numpy(),
                                   np.asarray(js.last_logits), **LOOP_TOL)


@pytest.mark.parametrize("sp", [SamplingParams(),
                                SamplingParams(temperature=0.8)],
                         ids=["greedy", "sampled"])
def test_fused_matches_eager(granite, sp):
    """The fused loop (the moe step in its body) against the per-token
    loop: tokens, position, logits, K/V, Meter counts and the
    generator's next draw."""
    _, eng = granite
    out = {}
    for fused in (False, True):
        gen = torch.Generator().manual_seed(3)
        s = eng.extend(eng.new_session(), _prompt())
        eng.meter.reset()
        ids = []
        for budget, stops in ((20, [tk.EOS]), (13, [tk.STEP]), (3, [])):
            got, s, _ = eng.generate(s, budget, stops, sp, gen, fused=fused)
            ids.append(got)
        out[fused] = (ids, s, eng.meter.as_dict(), torch.rand(4,
                                                              generator=gen))
    (ei, es, em, en), (fi, fs, fm, fn) = out[False], out[True]
    assert fi == ei and fs.pos == es.pos
    torch.testing.assert_close(fs.last_logits, es.last_logits, **LOOP_TOL)
    n = fs.pos
    torch.testing.assert_close(fs.state.k[:, :, :n], es.state.k[:, :, :n],
                               **LOOP_TOL)
    assert {k: fm[k] for k in METER_KEYS} == {k: em[k] for k in METER_KEYS}
    torch.testing.assert_close(fn, en, rtol=0, atol=0)


def test_specreason_trace_matches_jax(granite):
    """A greedy SpecReason request on the reduced granite base with the
    MICRO_SMALL drafter: the port, fused and per-token, and the JAX
    controller give one step trace."""
    je, te = granite
    js_m = JModel(jtestbed.MICRO_SMALL)
    js_p = js_m.init(jax.random.PRNGKey(4))
    ts_p = tckpt.params_from_numpy(jckpt._flatten(js_p), device="cpu")
    jsmall = JEngine(js_m, js_p, max_len=64, fused=False)
    tsmall = Engine(Model(testbed.MICRO_SMALL), ts_p, max_len=64)
    prompt = tasks.question_tokens(tasks.sample_task(random.Random(0)))
    jr = jcontroller.SpecReason(je, jsmall, jcontroller.SpecReasonConfig(
        policy=JThreshold(THRESHOLD), token_budget=16, max_steps=3,
        sampling=JSampling(0.0), fused_decode=False)).run(
        prompt, jax.random.PRNGKey(0))
    trace = [(s.source, s.accepted, s.tokens) for s in jr.steps]
    for fused in (True, False):
        tr = controller.SpecReason(te, tsmall, controller.SpecReasonConfig(
            policy=StaticThreshold(THRESHOLD), token_budget=16, max_steps=3,
            sampling=SamplingParams(0.0), fused_decode=fused)).run(
            prompt, torch.Generator().manual_seed(0))
        assert tr.thinking_ids == jr.thinking_ids
        assert tr.answer_ids == [int(t) for t in jr.answer_ids]
        assert [(s.source, s.accepted, s.tokens) for s in tr.steps] == trace
        np.testing.assert_allclose([s.utility for s in tr.steps],
                                   [s.utility for s in jr.steps],
                                   atol=UTILITY_TOL, rtol=0)


# ---------------------------------------------------------------------------
# the batched rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_batch_engine_matches_jax_call_for_call(cf, monkeypatch):
    """Three rows of a four-slot engine (slot 3 never allocated): extends
    of 11, 5 and 9 tokens, an extend of two rows, greedy decodes of 6
    and 9 tokens on two rows, a verification extend of gamma + 1 = 4
    tokens on every row, a truncate of two of them and a feed of one:
    logits and tokens against the JAX ``BatchEngine`` after every call.
    The moe engine carries every slot's tokens, as the JAX engine does,
    so its rows are coupled through capacity: at 0.25 choices are
    dropped."""
    drops = _Drops(monkeypatch)
    jm, jp, tm, tp = _pair(seed=2, capacity_factor=cf)
    je = JBatchEngine(jm, jp, batch=4, capacity=128)
    te = BatchEngine(tm, tp, batch=4, capacity=128)
    assert te.coupled
    rows = [je.alloc_row() for _ in range(3)]
    assert rows == [te.alloc_row() for _ in range(3)]

    def same_logits():
        np.testing.assert_allclose(te.last_logits[:3].numpy(),
                                   je.last_logits[:3], **FP32)
        assert list(te.pos[:3]) == list(je.pos[:3])

    for call_rows, toks in ((rows, [_prompt(11, 1), _prompt(5, 2),
                                    _prompt(9, 3)]),
                            (rows[:2], [[5, 6, 7], [8]])):
        jl = je.extend_rows(call_rows, toks, want_logits=True)
        tl = te.extend_rows(call_rows, toks, want_logits=True)
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **FP32)
        same_logits()
    jo = je.generate_rows([rows[0], rows[2]], [6, 9], [], JSampling(),
                          [jax.random.PRNGKey(i) for i in range(2)])
    to = te.generate_rows([rows[0], rows[2]], [6, 9], [], SamplingParams(),
                          [torch.Generator() for _ in range(2)])
    assert to == [[int(t) for t in o] for o in jo]
    same_logits()
    # a spec-decode round's base calls: verify, roll back, feed
    drafts = [_prompt(4, 10 + r) for r in rows]
    jl = je.extend_rows(rows, drafts, want_logits=True)
    tl = te.extend_rows(rows, drafts, want_logits=True)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FP32)
    for r in rows[:2]:
        je.truncate_row(r, int(je.pos[r]) - 2)
        te.truncate_row(r, int(te.pos[r]) - 2)
    je.feed_rows([rows[1]], [drafts[1][2]])
    te.feed_rows([rows[1]], [drafts[1][2]])
    np.testing.assert_allclose(te.last_logits[1].numpy(), je.last_logits[1],
                               **FP32)
    assert list(te.pos[:3]) == list(je.pos[:3])
    assert drops.calls > 0
    if cf < 1:
        assert drops.most > 0


def _sched_pairs(**over):
    """((JAX base, JAX small), (port base, port small)) engines: the
    reduced granite base and the MICRO_SMALL drafter, per-token loops."""
    jm, jp, tm, tp = _pair(seed=6, **over)
    sm = JModel(jtestbed.MICRO_SMALL)
    sp = sm.init(jax.random.PRNGKey(1))
    tsp = tckpt.params_from_numpy(jckpt._flatten(sp), device="cpu")
    return ((JEngine(jm, jp, max_len=256, fused=False),
             JEngine(sm, sp, max_len=256, fused=False)),
            (Engine(tm, tp, max_len=256, fused=False),
             Engine(Model(testbed.MICRO_SMALL), tsp, max_len=256,
                    fused=False)))


def _tasks():
    rng = random.Random(2)
    out = [tasks.sample_task(rng, min_steps=3) for _ in range(2)]
    return out + [out[0]]


def _trace(res):
    return (res.thinking_ids, [int(t) for t in res.answer_ids],
            [(s.source, s.accepted, list(s.tokens)) for s in res.steps],
            res.spec_stats.as_dict())


def _port_sched(base, small, spec, **kw):
    cfg = controller.SpecReasonConfig(
        policy=StaticThreshold(THRESHOLD), token_budget=32,
        sampling=SamplingParams(0.0), use_spec_decode=spec, spec_gamma=3)
    sr = controller.SpecReason(base, small, cfg)
    return sr, ContinuousScheduler(
        sr, tkv.KVManager(base.model.cfg, small.model.cfg,
                          tkv.KVBudget(1 << 20)), max_batch=3,
        max_prefill_tokens=16, **kw)


def test_continuous_scheduler_matches_jax():
    """The continuous scheduler over a moe base, with hierarchical spec
    decode and the prefix cache on (the third request repeats the
    first's prompt): traces, utilities, ticks, prefill chunks and cache
    statistics against the JAX scheduler's, greedy."""
    (jb, js), (tb, ts) = _sched_pairs()
    cfg = jcontroller.SpecReasonConfig(
        policy=JThreshold(THRESHOLD), token_budget=32,
        sampling=JSampling(0.0), use_spec_decode=True, spec_gamma=3)
    jsched = JScheduler(jcontroller.SpecReason(jb, js, cfg),
                        jkv.KVManager(jb.model.cfg, js.model.cfg,
                                      jkv.KVBudget(1 << 20)),
                        max_batch=3, max_prefill_tokens=16)
    jh = [jsched.submit(t, key=jax.random.PRNGKey(i))
          for i, t in enumerate(_tasks())]
    jsched.drain(jax.random.PRNGKey(0))
    _, tsched = _port_sched(tb, ts, True)
    th = [tsched.submit(t, generator=torch.Generator().manual_seed(i))
          for i, t in enumerate(_tasks())]
    tsched.drain()
    for a, b in zip(th, jh):
        assert _trace(a.result) == _trace(b.result)
        np.testing.assert_allclose([s.utility for s in a.result.steps],
                                   [s.utility for s in b.result.steps],
                                   atol=UTILITY_TOL, rtol=0)
    assert (tsched.ticks, tsched.prefill_chunks) == \
        (jsched.ticks, jsched.prefill_chunks)
    assert tsched.cache_stats() == jsched.cache_stats()
    assert tsched.cache_stats()["base"]["hit_tokens"] > 0
    assert th[0].result.spec_stats.as_dict()["proposed"] > 0


def test_continuous_equals_sequential_without_drops(monkeypatch):
    """With ``capacity_factor = n_experts / top_k`` every expert has a
    slot for every token of its group, so no choice is dropped (asserted
    over every routing) and a token's output is its own: the continuous
    scheduler's greedy traces equal the sequential controller's on the
    same engines, with spec decode on and off, and the prefix cache on
    equals off."""
    _, cfg = _configs()
    drops = _Drops(monkeypatch)
    _, (tb, ts) = _sched_pairs(capacity_factor=cfg.n_experts / cfg.top_k)
    for spec in (False, True):
        sr, sched = _port_sched(tb, ts, spec)
        handles = [sched.submit(t, generator=torch.Generator().manual_seed(i))
                   for i, t in enumerate(_tasks())]
        sched.drain()
        seq = [_trace(sr.run(tasks.question_tokens(t),
                             torch.Generator().manual_seed(i)))[:3]
               for i, t in enumerate(_tasks())]
        assert [_trace(h.result)[:3] for h in handles] == seq
        _, off = _port_sched(tb, ts, spec, prefix_cache=False)
        h_off = [off.submit(t, generator=torch.Generator().manual_seed(i))
                 for i, t in enumerate(_tasks())]
        off.drain()
        assert [_trace(h.result)[:3] for h in h_off] == seq
    assert drops.calls > 0 and drops.most == 0.0


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
def test_loss_aux_and_every_gradient_match_jax(remat):
    """``loss_fn`` with the router aux loss: the loss, ``ce_loss``, the
    four aux metrics and every gradient against the JAX package's, each
    within 1e-5 of its tensor's largest magnitude."""
    jm, jp, tm, tp = _pair(seed=7, remat=remat)
    inp, tgt, wgt = next(jpipeline.batch_iterator(jpipeline.BatchSpec(2, 32),
                                                  0, "mixed"))
    jb = {"tokens": jnp.asarray(inp), "targets": jnp.asarray(tgt),
          "weights": jnp.asarray(wgt)}
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jloss.loss_fn(jm, p, jb), has_aux=True)(jp)
    flat = {k: v.clone().requires_grad_() for k, v in flatten(tp).items()}
    params = unflatten(flat)
    tl, tmet = tloss.loss_fn(tm, params, {
        "tokens": torch.from_numpy(np.asarray(inp)),
        "targets": torch.from_numpy(np.asarray(tgt)),
        "weights": torch.from_numpy(np.asarray(wgt))})
    grads = torch.autograd.grad(tl, list(flat.values()))
    assert set(tmet) == set(jmet) == {
        "ce_loss", "aux_load_balance", "aux_router_z", "aux_dropped_frac",
        "aux_loss", "loss"}
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=GRAD_TOL)
    flat_j = jckpt._flatten(jg)
    assert set(flat) == set(flat_j)
    for k, g in zip(flat, grads):
        want = np.asarray(flat_j[k], np.float64)
        scale = float(np.abs(want).max())
        assert scale > 0, k
        np.testing.assert_allclose(g.numpy(), want, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * scale, err_msg=k)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_granite_and_qwen3():
    """granite-moe-1b-a400m is the JAX package's config field for field
    (its reduced one too: 4 experts, top-2); qwen3-moe-235b-a22b is
    refused, naming its size; the port's copy of its config matches."""
    from repro_torch.configs import qwen3_moe_235b
    assert dataclasses.asdict(registry.get(ARCH)) == \
        dataclasses.asdict(jregistry.get(ARCH))
    red = registry.reduced(ARCH)
    assert dataclasses.asdict(red) == \
        dataclasses.asdict(jregistry.reduced(ARCH))
    assert (red.n_experts, red.top_k, red.n_layers) == (4, 2, 2)
    assert ARCH in registry.ASSIGNED
    assert dataclasses.asdict(qwen3_moe_235b.CONFIG) == \
        dataclasses.asdict(jregistry.get("qwen3-moe-235b-a22b"))
    with pytest.raises(KeyError, match="235 B parameters.*80 GB"):
        registry.get("qwen3-moe-235b-a22b")
    assert isinstance(registry.get(ARCH), ModelConfig)
