"""The port's ssm family (mamba2) against the JAX package's, on the CPU:
the SSD scan's plain version and sequential oracle against the JAX
oracle, the JAX plain scan and the Pallas kernel in interpret mode; the
mixer, the model's logits, the Engine and the SpecReason controller on
an ssm base model; and the port's own rules for SSM state (new tensors
per call, snapshots, no truncation, no batched rows).

Every input is made with numpy from a fixed seed and both sides get the
same weights (JAX ``Model.init`` bridged through numpy).  Tolerances:
scan atol = rtol = 1e-4 (as tests/test_kernels.py's SSD cases); mixer
and logits 5e-5 (fp32 on both sides, summed in other orders: measured
max |diff| about 1e-6); within the port, rollback against a fresh run
1e-5.
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
from repro.core import controller as jcontroller
from repro.core.policies import StaticThreshold as JThreshold
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as jssd_scan
from repro.models import mamba2 as jmamba2
from repro.models.model import Model as JModel
from repro.sampling.sample import SamplingParams as JSampling
from repro.serving.engine import Engine as JEngine
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import registry, testbed
from repro_torch.core import controller
from repro_torch.core.policies import StaticThreshold
from repro_torch.data import tasks
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch import multiarch
from repro_torch.models import mamba2
from repro_torch.models.model import Model, flatten
from repro_torch.sampling.sample import SamplingParams
from repro_torch.serving.batch_engine import BatchEngine
from repro_torch.serving.engine import Engine
from repro_torch.serving.loader import arch_config, random_engine
from repro_torch.tokenizer import toy as tk

SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=5e-5, atol=5e-5)
SELF_TOL = dict(rtol=1e-5, atol=1e-5)
METER_KEYS = ("prefill_tokens", "prefill_calls", "decode_tokens",
              "decode_calls")
ARCH = "mamba2-1.3b"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_inputs(b, l, h, p, g, n, seed=0, init=True):
    """The reference tests' input distribution, made with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bb = (rng.standard_normal((b, l, g, n)) * 0.3).astype(np.float32)
    cc = (rng.standard_normal((b, l, g, n)) * 0.3).astype(np.float32)
    st = (rng.standard_normal((b, h, p, n)) * 0.5 if init
          else np.zeros((b, h, p, n))).astype(np.float32)
    return x, dt, a, bb, cc, st


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,l,h,p,g,n,chunk", [
    (1, 7, 2, 16, 1, 16, 7),        # one ragged chunk, as an extend
    (1, 128, 2, 16, 1, 16, 32),
    (2, 64, 4, 16, 2, 32, 32),      # G > 1
    (1, 96, 4, 32, 1, 64, 32),
])
def test_ssd_scan_matches_jax(b, l, h, p, g, n, chunk):
    args = _scan_inputs(b, l, h, p, g, n, seed=l + g)
    x, dt, a, bb, cc, st = args
    jy, jf = jref.ssd_reference(*_j(*args))
    py, pf = jssd_scan(*_j(x, dt, a, bb, cc), chunk, jnp.asarray(st),
                       interpret=True)
    cy, cf = jmamba2.ssd_chunked(*_j(x, dt, a, bb, cc), chunk,
                                 jnp.asarray(st))
    ty, tf = ref.ssd_reference(*_t(*args))
    uy, uf = mamba2.ssd_chunked(*_t(x, dt, a, bb, cc), chunk,
                                torch.from_numpy(st))
    for y, f in ((py, pf), (cy, cf), (ty, tf), (uy, uf)):
        np.testing.assert_allclose(np.asarray(y), np.asarray(jy), **SCAN_TOL)
        np.testing.assert_allclose(np.asarray(f), np.asarray(jf), **SCAN_TOL)
    np.testing.assert_allclose(uy.numpy(), np.asarray(cy), **SCAN_TOL)
    assert tf.dtype == uf.dtype == torch.float32


def test_ssd_state_resume_and_ops_cpu_route():
    """Two calls with the state carried equal one call (SpecReason's SSM
    snapshots rely on it); ``ops.ssd`` runs ``ssd_chunked`` on the CPU."""
    x, dt, a, bb, cc, _ = _t(*_scan_inputs(1, 128, 2, 16, 1, 32, seed=5,
                                           init=False))
    y, f = ops.ssd(x, dt, a, bb, cc, 32)
    y0, f0 = mamba2.ssd_chunked(x, dt, a, bb, cc, 32)
    assert torch.equal(y, y0) and torch.equal(f, f0)
    y1, f1 = ops.ssd(x[:, :64], dt[:, :64], a, bb[:, :64], cc[:, :64], 32)
    y2, f2 = ops.ssd(x[:, 64:], dt[:, 64:], a, bb[:, 64:], cc[:, 64:], 32,
                     f1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               **SCAN_TOL)
    np.testing.assert_allclose(f2.numpy(), f.numpy(), **SCAN_TOL)
    with pytest.raises(ValueError, match="multiple of chunk"):
        mamba2.ssd_chunked(x[:, :50], dt[:, :50], a, bb[:, :50],
                           cc[:, :50], 32)
    # the kernel's wrapper never computes on the CPU
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        ssd_scan(x, dt, a, bb, cc, 32)
    assert ssd_scan.launches == 0


# ---------------------------------------------------------------------------
# the mixer and the model
# ---------------------------------------------------------------------------

def _jcfg():
    return dataclasses.replace(jregistry.reduced(ARCH),
                               vocab_size=tk.VOCAB_SIZE, name=ARCH)


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX params, port model, port params): the reduced
    mamba2-1.3b with the toy vocabulary, the same weights on both."""
    jcfg, tcfg = _jcfg(), arch_config(ARCH, reduced=True)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    tp = tckpt.params_from_numpy(jckpt._flatten(jp), device="cpu")
    return jm, jp, Model(tcfg), tp


def test_param_bridge_and_init_kinds(models):
    jm, jp, tm, tp = models
    spec = tm.spec()
    flat = flatten(tp)
    assert set(spec) == set(flat) and \
        any(k.startswith("layers/mixer/") for k in spec)
    for k, s in spec.items():
        assert tuple(flat[k].shape) == s.shape, k
    own = flatten(tm.init(0, device="cpu"))
    h = tm.cfg.ssm_n_heads
    np.testing.assert_allclose(own["layers/mixer/A_log"][0].numpy(),
                               np.log(np.arange(1, h + 1)), rtol=1e-6)
    np.testing.assert_allclose(own["layers/mixer/A_log"].numpy(),
                               np.asarray(jp["layers"]["mixer"]["A_log"]),
                               rtol=1e-6)
    dt = torch.nn.functional.softplus(own["layers/mixer/dt_bias"])
    assert 1e-3 * (1 - 1e-5) <= float(dt.min()) <= float(dt.max()) \
        <= 0.1 * (1 + 1e-5)


def test_apply_mamba_and_decode_match_jax(models):
    jm, jp, tm, tp = models
    cfg = tm.cfg
    lp_j = jax.tree.map(lambda t: t[0], jp["layers"]["mixer"])
    lp_t = {k: v[0] for k, v in tp["layers"]["mixer"].items()}
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 45, cfg.d_model)).astype(np.float32)
    ch = cfg.ssm_d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state
    conv = (rng.standard_normal((2, cfg.ssm_conv_width - 1, ch)) * 0.5
            ).astype(np.float32)
    ssm = (rng.standard_normal((2, cfg.ssm_n_heads, cfg.ssm_head_dim,
                                cfg.ssm_state)) * 0.5).astype(np.float32)
    # 45 tokens: a chunk of 32, then one padded to 32
    jy, (jc, js) = jmamba2.apply_mamba(jnp.asarray(x), lp_j, cfg,
                                       (jnp.asarray(conv), jnp.asarray(ssm)),
                                       return_state=True)
    ty, (tc, ts) = mamba2.apply_mamba(torch.from_numpy(x), lp_t, cfg,
                                      (torch.from_numpy(conv),
                                       torch.from_numpy(ssm)),
                                      return_state=True)
    for a, b in ((ty, jy), (tc, jc), (ts, js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    jd, (jc, js) = jmamba2.apply_mamba_decode(jnp.asarray(x[:, :1]), lp_j,
                                              cfg, (jc, js))
    td, (tc, ts) = mamba2.apply_mamba_decode(torch.from_numpy(x[:, :1]),
                                             lp_t, cfg, (tc, ts))
    for a, b in ((td, jd), (tc, jc), (ts, js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert torch.equal(mamba2.apply_mamba(torch.from_numpy(x), lp_t, cfg),
                       mamba2.apply_mamba(torch.from_numpy(x), lp_t, cfg,
                                          None, False))


def test_model_logits_match_jax(models):
    jm, jp, tm, tp = models
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tk.VOCAB_SIZE, (1, 70))
    np.testing.assert_allclose(
        tm.forward(tp, torch.from_numpy(toks)).numpy(),
        np.asarray(jm.forward(jp, jnp.asarray(toks, jnp.int32))[0]), **TOL)
    # prefill 40 (a chunk + a padded one) -> extend 30 -> decode 3
    jst, tst = jm.init_state(1, 0), tm.init_state(1, 0, device="cpu")
    assert tst.capacity == 0 and tst.k is None
    for part in (toks[:, :40], toks[:, 40:]):
        jl, jst = jm.prefill(jp, jnp.asarray(part, jnp.int32), jst)
        tl, tst = tm.prefill(tp, torch.from_numpy(part), tst)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for t in (5, 17, 33):
        jl, jst = jm.decode_step(jp, jst, jnp.asarray([[t]], jnp.int32))
        tl, tst = tm.decode_step(tp, tst, torch.tensor([[t]]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tst.pos == int(jst.pos) == 73
    np.testing.assert_allclose(tst.ssm.numpy(), np.asarray(jst.ssm), **TOL)
    np.testing.assert_allclose(tst.conv.numpy(), np.asarray(jst.conv), **TOL)


# ---------------------------------------------------------------------------
# the Engine and SSM state rules
# ---------------------------------------------------------------------------

def _prompt(n=11, seed=0):
    return [int(t) for t in np.random.default_rng(seed).integers(10, 38, n)]


@pytest.fixture(scope="module")
def engines(models):
    """Both packages' per-token loops (tests/test_torch_fused_ssm.py
    holds the port's fused loop to its per-token one and to the JAX
    package's fused loop)."""
    jm, jp, tm, tp = models
    return (JEngine(jm, jp, max_len=256, fused=False),
            Engine(tm, tp, max_len=256, fused=False))


def test_engine_greedy_tokens_and_meters_match_jax(engines):
    je, te = engines
    je.meter.reset()
    te.meter.reset()
    assert je.exact_lengths and te.exact_lengths and not te.can_truncate
    js = je.extend(je.new_session(), _prompt())
    ts = te.extend(te.new_session(), _prompt())
    jids, js, _ = je.generate(js, 12, [tk.EOS], JSampling(0.0),
                              jax.random.PRNGKey(0))
    tids, ts, _ = te.generate(ts, 12, [tk.EOS], SamplingParams(0.0),
                              torch.Generator())
    assert tids == jids and ts.pos == js.pos
    js = je.extend(js, _prompt(5, 1))
    ts = te.extend(ts, _prompt(5, 1))
    np.testing.assert_allclose(ts.last_logits.numpy(),
                               np.asarray(js.last_logits), **TOL)
    jm_, tm_ = je.meter.as_dict(), te.meter.as_dict()
    assert {k: tm_[k] for k in METER_KEYS} == {k: jm_[k] for k in METER_KEYS}
    assert tm_["prefill_tokens"] == 11 + 5          # exact lengths


def test_padded_extend_equals_tokenwise_decode(engines):
    """One extend of 13 tokens (not a bucket) equals feeding them one at a
    time: no pad enters the recurrent state."""
    _, te = engines
    ids = [tk.BOS, tk.THINK] + tk.num_ids(37) + tk.num_ids(81) + [tk.STEP]
    ids = ids + _prompt(13 - len(ids), 4)
    s1 = te.extend(te.new_session(), ids)
    s2 = te.extend(te.new_session(), ids[:1])
    for t in ids[1:]:
        s2 = te.decode_one(s2, t)
    assert s1.pos == s2.pos == len(ids)
    np.testing.assert_allclose(s1.last_logits.numpy(),
                               s2.last_logits.numpy(), rtol=2e-4, atol=2e-4)


def test_reject_then_redraft_matches_fresh_run(engines):
    """Every call writes new conv/ssm tensors, so a snapshot taken before
    a rejected draft sees none of it: rollback + replay equals a fresh
    run, and the snapshot's own tensors are untouched."""
    _, te = engines
    prompt = _prompt(10, 5)
    s = te.extend(te.new_session(), prompt)
    snap = s.snapshot()
    before = (snap.state.conv.clone(), snap.state.ssm.clone())
    assert snap.state.ssm is s.state.ssm          # O(1): shared, not copied
    _, s_draft, _ = te.generate(s, 9, [], SamplingParams(1.0),
                                torch.Generator().manual_seed(11))
    s_draft = te.extend(s_draft, _prompt(7, 6))   # rejected, and more junk
    assert torch.equal(snap.state.conv, before[0]) and \
        torch.equal(snap.state.ssm, before[1])
    redo = te.rollback(s_draft, snap, _prompt(5, 7))
    fresh = te.extend(te.new_session(), prompt + _prompt(5, 7))
    assert redo.pos == fresh.pos
    np.testing.assert_allclose(redo.last_logits.numpy(),
                               fresh.last_logits.numpy(), **SELF_TOL)
    for got, want in ((redo.state.conv, fresh.state.conv),
                      (redo.state.ssm, fresh.state.ssm)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **SELF_TOL)


def test_truncate_refused_and_no_capacity(engines):
    _, te = engines
    s = te.extend(te.new_session(), [tk.BOS])
    with pytest.raises(ValueError, match="cannot be truncated"):
        te.truncate(s, 0, s.last_logits)
    with pytest.raises(ValueError, match="SSM state"):
        s.state.truncate(0)
    long = te.extend(te.new_session(capacity=8), _prompt(300, 9))
    assert long.pos == 300                        # no positional capacity


def test_batch_engine_refuses_ssm(models):
    _, _, tm, tp = models
    with pytest.raises(ValueError, match="attention-only"):
        BatchEngine(tm, tp, batch=2, capacity=64)


# ---------------------------------------------------------------------------
# SpecReason on an ssm base
# ---------------------------------------------------------------------------

THRESHOLD = 4.5
BUDGET = 32


@pytest.fixture(scope="module")
def pairs(engines):
    """(JAX pair, port pair): the reduced mamba2-1.3b base with the
    MICRO_SMALL testbed drafter (dense), as test_controller_on_ssm_base
    pairs an ssm base with a dense speculator."""
    from repro.configs import testbed as jtestbed
    je, te = engines
    js_m = JModel(jtestbed.MICRO_SMALL)
    js_p = js_m.init(jax.random.PRNGKey(4))
    ts_p = tckpt.params_from_numpy(jckpt._flatten(js_p), device="cpu")
    return ((je, JEngine(js_m, js_p, max_len=512, fused=False)),
            (te, Engine(Model(testbed.MICRO_SMALL), ts_p, max_len=512,
                        fused=False)))


def _run_both(pairs, i, **kw):
    (jb, js), (tb, ts) = pairs
    for e in (jb, js, tb, ts):
        e.meter.reset()
    prompt = tasks.question_tokens(tasks.sample_task(random.Random(i)))
    jcfg = jcontroller.SpecReasonConfig(
        policy=JThreshold(THRESHOLD), token_budget=BUDGET, max_steps=4,
        sampling=JSampling(0.0), fused_decode=False, **kw)
    tcfg = controller.SpecReasonConfig(
        policy=StaticThreshold(THRESHOLD), token_budget=BUDGET, max_steps=4,
        sampling=SamplingParams(0.0), **kw)
    jr = jcontroller.SpecReason(jb, js, jcfg).run(prompt,
                                                  jax.random.PRNGKey(i))
    tr = controller.SpecReason(tb, ts, tcfg).run(
        prompt, torch.Generator().manual_seed(i))
    return jr, tr


def _assert_same(jr, tr):
    assert tr.thinking_ids == jr.thinking_ids
    assert tr.answer_ids == [int(t) for t in jr.answer_ids]
    assert [(s.source, s.accepted, s.tokens) for s in tr.steps] == \
        [(s.source, s.accepted, s.tokens) for s in jr.steps]
    np.testing.assert_allclose([s.utility for s in tr.steps],
                               [s.utility for s in jr.steps],
                               atol=1e-4, rtol=0)
    for name in tr.meters:
        assert {k: tr.meters[name][k] for k in METER_KEYS} == \
            {k: jr.meters[name][k] for k in METER_KEYS}, name


@pytest.fixture(scope="module")
def greedy_runs(pairs):
    return [_run_both(pairs, i) for i in range(2)]


@pytest.mark.parametrize("i", range(2))
def test_specreason_on_ssm_base_matches_jax(greedy_runs, i):
    _assert_same(*greedy_runs[i])


def test_ssm_runs_see_both_decisions(greedy_runs):
    decisions = {s.accepted for _, tr in greedy_runs for s in tr.steps
                 if s.source == "small"}
    assert decisions == {True, False}


def test_hierarchical_on_ssm_base_replays(pairs):
    """SpecReason+Decode with an ssm base: every spec-decode round rolls
    the base back by snapshot and replay (it cannot truncate), the
    drafter by truncation; tokens, steps and meters equal the JAX
    package's."""
    jr, tr = _run_both(pairs, 0, use_spec_decode=True, spec_gamma=4)
    _assert_same(jr, tr)
    assert tr.spec_stats.rounds > 0 and \
        tr.spec_stats.proposed == jr.spec_stats.proposed


@pytest.fixture(scope="module")
def self_pairs(models, engines):
    """The reduced mamba2-1.3b as its own drafter, through a second
    engine over the same weights: greedy drafts are accepted, so spec
    decode replays several tokens after each snapshot, and the drafter,
    which cannot truncate either, reconciles by rollback too."""
    jm, jp, tm, tp = models
    je, te = engines
    return ((je, JEngine(jm, jp, max_len=256, fused=False)),
            (te, Engine(tm, tp, max_len=256, fused=False)))


def test_hierarchical_ssm_self_draft_accepts_and_replays(self_pairs):
    jr, tr = _run_both(self_pairs, 1, use_spec_decode=True, spec_gamma=4)
    _assert_same(jr, tr)
    ts, js = tr.spec_stats, jr.spec_stats
    assert (ts.rounds, ts.proposed, ts.accepted) == \
        (js.rounds, js.proposed, js.accepted)
    assert ts.accepted > ts.rounds > 0        # some round kept 2+ drafts


# ---------------------------------------------------------------------------
# registry, loader and the multiarch twin
# ---------------------------------------------------------------------------

def test_registry_refuses_unported_archs():
    assert set(registry.ASSIGNED) == {"minitron-4b", "mamba2-1.3b",
                                      "phi3-mini-3.8b", "hymba-1.5b",
                                      "starcoder2-7b",
                                      "granite-moe-1b-a400m"}
    assert dataclasses.asdict(registry.get(ARCH)) == \
        dataclasses.asdict(jregistry.get(ARCH))
    for arch in ("qwen3-moe-235b-a22b", "yi-34b"):
        with pytest.raises(KeyError, match="not ported"):
            registry.get(arch)
    with pytest.raises(NotImplementedError, match="encdec"):
        Model(dataclasses.replace(registry.reduced(ARCH), family="encdec",
                                  n_encoder_layers=1))


def test_random_engine_and_multiarch_on_cpu(capsys):
    eng = random_engine("testbed-small", device="cpu", seed=0)
    assert eng.model.cfg.vocab_size == tk.VOCAB_SIZE and \
        eng.name == "testbed-small" and not eng.exact_lengths
    want = flatten(Model(testbed.SMALL).init(0, device="cpu"))
    assert all(torch.equal(v, want[k])
               for k, v in flatten(eng.params).items())
    red = arch_config(ARCH, reduced=True)
    assert red.has_ssm and red.vocab_size == tk.VOCAB_SIZE and \
        red.n_layers <= 2
    multiarch.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert any(ln.startswith(ARCH) and "rollback=snapshot" in ln
               for ln in lines)
    assert any(ln.startswith("minitron-4b") and "kv-truncate" in ln
               for ln in lines)
    assert any(ln.startswith("hymba-1.5b") and "[hybrid" in ln and
               "rollback=snapshot" in ln and "hymba-1.5b fused" in ln
               for ln in lines)
