"""The port's training against the JAX package's, on the CPU: the data
pipeline's batches, cross-entropy, the schedule, one AdamW update with
and without clipping, ``loss_fn`` and every gradient on BASE (remat on
and off), ``make_train_step`` with two microbatches, five ``train``
steps, the plain attention backward against ``jax.grad`` of the JAX
attention oracle, and a port checkpoint read by the JAX package.

Both sides get the same parameters (the JAX package's ``Model.init``
carried over by ``checkpoint.params_from_numpy``) and the same batches
(numpy, from the pipeline).  Tolerances, each against the largest
magnitude of the compared quantity: cross-entropy, schedule and AdamW
1e-6 (float32 arithmetic in the same order); loss and gradients 1e-5
(a five-layer forward and backward sum in other orders on each side);
five training steps' losses 1e-4 (the same, compounded over steps) and
the parameters after AdamW steps 1e-4 absolutely (``_close_params``); the
attention backward 1e-5; logits from a port checkpoint 5e-5 (as
tests/test_torch_model.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import testbed as jtestbed
from repro.data import pipeline as jpipeline
from repro.kernels import ref as jref
from repro.models.model import Model as JModel
from repro.training import loss as jloss
from repro.training import optimizer as jopt
from repro.training import train_loop as jtrain
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import testbed
from repro_torch.data import pipeline
from repro_torch.kernels import flash_attention_bwd as bwd_mod
from repro_torch.kernels import ref
from repro_torch.models.model import Model, flatten
from repro_torch.training import loss as tloss
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as ttrain

ARITH_TOL = 1e-6
GRAD_TOL = 1e-5
STEPS_TOL = 1e-4
LOGIT_TOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, what=""):
    """|got - want| <= tol * (max |want| + |want|): relative to the
    compared quantity's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _close_params(tree_t, tree_j, what=""):
    """Parameters after AdamW steps, within STEPS_TOL absolutely: the step
    divides m by sqrt(v), so an element whose gradient is near zero
    carries its gradient's tiny absolute difference into a difference of
    a few percent of lr."""
    flat_j = jckpt._flatten(tree_j)
    for k, t in flatten(tree_t).items():
        np.testing.assert_allclose(t.detach().numpy(), flat_j[k],
                                   rtol=STEPS_TOL, atol=STEPS_TOL,
                                   err_msg=f"{what} {k}")


def _params(name, seed=3, remat=True):
    """(JAX model, JAX params, port model, port params): the same weights,
    bridged through numpy; ``remat`` set on both configs."""
    jm = JModel(dataclasses.replace(getattr(jtestbed, name), remat=remat))
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = Model(dataclasses.replace(getattr(testbed, name), remat=remat))
    tp = tckpt.params_from_numpy(jckpt._flatten(jp), device="cpu")
    return jm, jp, tm, tp


def _batch(kind="mixed", b=2, s=32, seed=0):
    return next(pipeline.batch_iterator(pipeline.BatchSpec(b, s), seed, kind))


def _requires_grad(tp):
    return {k: _requires_grad(v) if isinstance(v, dict)
            else v.clone().requires_grad_() for k, v in tp.items()}


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,mix", [("mixed", (0.85, 0.1)),
                                      ("cot", (0.0, 0.0))])
def test_pipeline_batches_identical(kind, mix):
    spec = (pipeline.BatchSpec(4, 112), jpipeline.BatchSpec(4, 112))
    ours = pipeline.batch_iterator(spec[0], 7, kind, mix, 0.3)
    theirs = jpipeline.batch_iterator(spec[1], 7, kind, mix, 0.3)
    for _ in range(3):
        for a, b in zip(next(ours), next(theirs)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# loss and optimizer arithmetic
# ---------------------------------------------------------------------------

def test_cross_entropy_matches():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 9, 64)) * 3).astype(np.float32)
    targets = rng.integers(0, 64, (3, 9)).astype(np.int32)
    weights = (rng.random((3, 9)) < 0.6).astype(np.float32)
    for w in (weights, np.zeros_like(weights)):
        want = jloss.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                   jnp.asarray(w))
        got = tloss.cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(targets),
                                  torch.from_numpy(w))
        _close(got.item(), float(want), ARITH_TOL)


def test_schedule_matches_over_all_steps():
    cfg = dict(lr=1.5e-3, warmup_steps=40, total_steps=120)
    jc, tc = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
    for step in range(0, 131):
        _close(topt.schedule(tc, step),
               float(jopt.schedule(jc, jnp.asarray(step))), ARITH_TOL,
               f"step {step}")


@pytest.mark.parametrize("grad_scale", [10.0, 1e-3])   # clipped, not
def test_adamw_update_matches(grad_scale):
    rng = np.random.default_rng(1)
    shapes = {"a": (5, 7), "b": {"c": (3,), "d": (2, 4, 3)}}

    def draw(tree, s):
        return {k: draw(v, s) if isinstance(v, dict)
                else (rng.standard_normal(v) * s).astype(np.float32)
                for k, v in tree.items()}
    params, grads = draw(shapes, 1.0), draw(shapes, grad_scale)
    jc = jopt.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=20)
    tc = topt.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=20)
    jp = jax.tree.map(jnp.asarray, params)
    jg = jax.tree.map(jnp.asarray, grads)
    tp = tckpt.params_from_numpy(jckpt._flatten(params), device="cpu")
    tg = tckpt.params_from_numpy(jckpt._flatten(grads), device="cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(2):          # from zero moments, then from non-zero ones
        jp, js, jm = jopt.update(jc, jg, js, jp)
        tp, ts, tm = topt.update(tc, tg, ts, tp)
    assert ts.step == int(js.step) == 2
    _close(tm["grad_norm"].item(), float(jm["grad_norm"]), ARITH_TOL)
    _close(float(jopt.global_norm(jg)), topt.global_norm(tg).item(),
           ARITH_TOL)
    assert (float(jm["grad_norm"]) > 1.0) == (grad_scale > 1)
    _close(tm["lr"], float(jm["lr"]), ARITH_TOL)
    for tree_t, tree_j in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        flat_j = jckpt._flatten(tree_j)
        for k, t in flatten(tree_t).items():
            _close(t.numpy(), flat_j[k], ARITH_TOL, k)


# ---------------------------------------------------------------------------
# loss and gradients of the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_every_gradient_match_on_base(remat):
    jm, jp, tm, tp = _params("BASE", remat=remat)
    inp, tgt, wgt = _batch("mixed", 2, 32)
    jb = {"tokens": jnp.asarray(inp), "targets": jnp.asarray(tgt),
          "weights": jnp.asarray(wgt)}
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jloss.loss_fn(jm, p, jb), has_aux=True)(jp)
    tp = _requires_grad(tp)
    tb = {"tokens": torch.from_numpy(inp), "targets": torch.from_numpy(tgt),
          "weights": torch.from_numpy(wgt)}
    tl, tmet = tloss.loss_fn(tm, tp, tb)
    flat = flatten(tp)
    grads = torch.autograd.grad(tl, list(flat.values()))
    _close(tl.item(), float(jl), GRAD_TOL)
    _close(tmet["ce_loss"].item(), float(jmet["ce_loss"]), GRAD_TOL)
    flat_j = jckpt._flatten(jg)
    assert set(flat) == set(flat_j)
    for k, g in zip(flat, grads):
        assert float(np.abs(flat_j[k]).max()) > 0, k
        _close(g.numpy(), flat_j[k], GRAD_TOL, k)


def test_train_step_with_two_microbatches_matches():
    jm, jp, tm, tp = _params("SMALL")
    inp, tgt, wgt = _batch("cot", 4, 24, seed=5)
    jc = jopt.AdamWConfig(lr=2e-3, warmup_steps=0, total_steps=10)
    tc = topt.AdamWConfig(lr=2e-3, warmup_steps=0, total_steps=10)
    jstep = jloss.make_train_step(jm, jc, n_microbatches=2)
    jp2, js, jmet = jstep(jp, jopt.init(jp),
                         {"tokens": jnp.asarray(inp),
                          "targets": jnp.asarray(tgt),
                          "weights": jnp.asarray(wgt)})
    tp = _requires_grad(tp)
    tstep = tloss.make_train_step(tm, tc, n_microbatches=2)
    tp2, ts, tmet = tstep(tp, topt.init(tp),
                          {"tokens": torch.from_numpy(inp),
                           "targets": torch.from_numpy(tgt),
                           "weights": torch.from_numpy(wgt)})
    assert ts.step == 1
    for key in ("loss", "ce_loss", "grad_norm"):
        _close(float(tmet[key]), float(jmet[key]), GRAD_TOL, key)
    # after one step m = (1 - b1) x the clipped mean of the microbatches'
    # gradients
    flat_j = jckpt._flatten(js.m)
    for k, t in flatten(ts.m).items():
        _close(t.numpy(), flat_j[k], GRAD_TOL, k)
    _close_params(tp2, jp2)


def test_five_train_steps_match(monkeypatch):
    jm, jp, tm, tp = _params("SMALL", seed=0)
    # the port's trainer starts from the JAX trainer's parameters
    monkeypatch.setattr(ttrain.Model, "init",
                        lambda self, seed, device: _requires_grad(tp))
    cfg = dict(steps=5, batch_size=4, seq_len=48, kind="cot",
               style_mix=(0.0, 0.0), seed=0, log_every=1)
    jt = jtrain.TrainConfig(**cfg, opt=jopt.AdamWConfig(lr=2e-3,
                                                        warmup_steps=2))
    tt = ttrain.TrainConfig(**cfg, opt=topt.AdamWConfig(lr=2e-3,
                                                        warmup_steps=2))
    jout = jtrain.train(jtestbed.SMALL, jt, log=lambda s: None)
    tout = ttrain.train(testbed.SMALL, tt, log=lambda s: None, device="cpu")
    assert [h["step"] for h in tout["history"]] == list(range(5))
    for a, b in zip(tout["history"], jout["history"]):
        _close(a["loss"], b["loss"], STEPS_TOL, f"step {a['step']}")
    assert tout["history"][-1]["loss"] < tout["history"][0]["loss"]
    assert not any(t.requires_grad
                   for t in flatten(tout["params"]).values())
    _close_params(tout["params"], jout["params"])


# ---------------------------------------------------------------------------
# attention backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,kh,hd,s", [(8, 4, 28, 20), (4, 2, 32, 33),
                                       (6, 6, 16, 9)])
def test_plain_attention_backward_matches_jax(h, kh, hd, s):
    rng = np.random.default_rng(h * 100 + s)
    q = rng.standard_normal((2, h, s, hd)).astype(np.float32)
    k = rng.standard_normal((2, kh, s, hd)).astype(np.float32)
    v = rng.standard_normal((2, kh, s, hd)).astype(np.float32)
    do = rng.standard_normal((2, h, s, hd)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jref.mha_reference(a, b, c, True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = ref.mha_backward_reference(*(torch.from_numpy(x)
                                       for x in (q, k, v, do)))
    # and torch autograd of the port's forward oracle agrees
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    auto = torch.autograd.grad(ref.mha_reference(*leaves),
                               leaves, torch.from_numpy(do))
    for name, g, a, w in zip(("dq", "dk", "dv"), got, auto, want):
        assert g.shape == w.shape
        _close(g.numpy(), np.asarray(w), GRAD_TOL, name)
        _close(a.numpy(), np.asarray(w), GRAD_TOL, name)


@pytest.mark.parametrize("kwargs", [dict(causal=False), dict(q_offset=3),
                                    dict(kv_len=5), dict(window=4)])
def test_backward_contract_refuses_other_cases(kwargs):
    q = torch.zeros(1, 4, 8, 16)
    kv = torch.zeros(1, 2, 8, 16)
    bwd_mod.check_contract(q, kv, kv)
    with pytest.raises(ValueError, match="training forward"):
        bwd_mod.check_contract(q, kv, kv, **kwargs)
    with pytest.raises(ValueError, match="float32"):
        bwd_mod.check_contract(q.double(), kv.double(), kv.double())
    with pytest.raises(ValueError, match="head_dim"):
        bwd_mod.check_contract(torch.zeros(1, 4, 8, 160),
                               torch.zeros(1, 2, 8, 160),
                               torch.zeros(1, 2, 8, 160))


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def test_port_trained_checkpoint_loads_in_jax(tmp_path):
    path = str(tmp_path / "small.npz")
    tcfg = ttrain.TrainConfig(steps=2, batch_size=2, seq_len=32, kind="cot",
                              log_every=1)
    out = ttrain.train(testbed.SMALL, tcfg, ckpt_path=path,
                       log=lambda s: None, device="cpu")
    jm = JModel(jtestbed.SMALL)
    jp = jckpt.load_checkpoint(path, jm.abstract(jnp.float32))
    assert jckpt.load_meta(path)["steps"] == 2
    toks = np.random.default_rng(4).integers(0, 64, (2, 24))
    lj, _ = jm.forward(jp, jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        lt = out["model"].forward(out["params"], torch.from_numpy(toks))
    _close(lt.numpy(), np.asarray(lj), LOGIT_TOL)

