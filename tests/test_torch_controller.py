"""The port's SpecReason controller and vanilla baseline against the JAX
package's, greedy, on the random-init MICRO pair (MICRO base, MICRO_SMALL
drafter, as the JAX serve CLI's ``--testbed micro`` builds it): thinking
and answer tokens, step sources, accept/reject decisions and per-engine
Meter counts are identical, utilities agree to 1e-4 (the score
distribution's expectation over ten digits, from logits that agree to
5e-5).  Also the serving CLI once on the CPU, against the JAX CLI on the
same checkpoints.

The JAX side runs its per-token decode loop (``fused_decode=False``),
whose metering the port follows.  The threshold 4.5 sits among this
pair's utilities (3.6 to 5.5), so the runs see both decisions.
"""

import random

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import testbed as jtestbed
from repro.core import baselines as jbaselines
from repro.core import controller as jcontroller
from repro.core.policies import StaticThreshold as JThreshold
from repro.data import tasks as jtasks
from repro.launch import serve as jserve
from repro.models.model import Model as JModel
from repro.sampling.sample import SamplingParams as JSampling
from repro.serving.engine import Engine as JEngine
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import testbed
from repro_torch.core import baselines, controller
from repro_torch.core.policies import StaticThreshold
from repro_torch.data import tasks
from repro_torch.launch import serve
from repro_torch.models.model import Model, flatten
from repro_torch.sampling.sample import SamplingParams
from repro_torch.serving.engine import Engine
from repro_torch.serving.kv_manager import KVBudget, KVManager
from repro_torch.serving.loader import load_testbed_engines, \
    save_random_testbed
from repro_torch.serving.scheduler import ContinuousScheduler

UTILITY_TOL = 1e-4
THRESHOLD = 4.5
BUDGET = 48
N_TASKS = 4
METER_KEYS = ("prefill_tokens", "prefill_calls", "decode_tokens",
              "decode_calls")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pairs():
    out = []
    for cfg_name, seed in (("MICRO", 0), ("MICRO_SMALL", 1)):
        jm = JModel(getattr(jtestbed, cfg_name))
        jp = jm.init(jax.random.PRNGKey(seed))
        tp = tckpt.params_from_numpy(jckpt._flatten(jp), device="cpu")
        out.append((JEngine(jm, jp, max_len=1024, fused=False),
                    Engine(Model(getattr(testbed, cfg_name)), tp,
                           max_len=1024, fused=False)))
    (jb, tb), (js, ts) = out
    return (jb, js), (tb, ts)


def _tasks():
    rng = random.Random(0)
    return [tasks.sample_task(rng) for _ in range(N_TASKS)]


def _run_both(pairs, i, **kw):
    (jb, js), (tb, ts) = pairs
    prompt = tasks.question_tokens(_tasks()[i])
    jcfg = jcontroller.SpecReasonConfig(
        policy=JThreshold(THRESHOLD), token_budget=BUDGET,
        sampling=JSampling(0.0), fused_decode=False, **kw)
    tcfg = controller.SpecReasonConfig(
        policy=StaticThreshold(THRESHOLD), token_budget=BUDGET,
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
                               atol=UTILITY_TOL, rtol=0)
    for name in tr.meters:
        assert {k: tr.meters[name][k] for k in METER_KEYS} == \
            {k: jr.meters[name][k] for k in METER_KEYS}, name


@pytest.fixture(scope="module")
def greedy_runs(pairs):
    return [_run_both(pairs, i) for i in range(N_TASKS)]


@pytest.mark.parametrize("i", range(N_TASKS))
def test_specreason_greedy_matches_jax(greedy_runs, i):
    _assert_same(*greedy_runs[i])


def test_runs_see_both_decisions(greedy_runs):
    decisions = {s.accepted for _, tr in greedy_runs for s in tr.steps
                 if s.source == "small"}
    assert decisions == {True, False}


@pytest.mark.parametrize("kw", [{"first_n_base": 1}, {"overlapped": True}])
def test_specreason_knobs_match_jax(pairs, kw):
    _assert_same(*_run_both(pairs, 2, **kw))


@pytest.mark.parametrize("which", [0, 1])
def test_vanilla_reason_matches_jax(pairs, which):
    (jpair, tpair) = pairs
    prompt = tasks.question_tokens(_tasks()[1])
    jr = jbaselines.vanilla_reason(jpair[which], prompt,
                                   jax.random.PRNGKey(0), BUDGET,
                                   JSampling(0.0), fused=False)
    tr = baselines.vanilla_reason(tpair[which], prompt, torch.Generator(),
                                  BUDGET, SamplingParams(0.0))
    assert tr.thinking_ids == jr.thinking_ids
    assert tr.answer_ids == [int(t) for t in jr.answer_ids]
    (tm,), (jm,) = tr.meters.values(), jr.meters.values()
    assert {k: tm[k] for k in METER_KEYS} == {k: jm[k] for k in METER_KEYS}


def test_spec_decode_raises(pairs):
    """SpecReason+Decode is ported (tests/test_torch_spec.py holds it to
    the JAX package): the sequential controller runs it, and so does its
    continuous form over the prefix cache, the continuous scheduler's
    default (it raised until the cache was ported), with the sequential
    run's tokens."""
    _, (tb, ts) = pairs
    cfg = controller.SpecReasonConfig(use_spec_decode=True, token_budget=8,
                                      sampling=SamplingParams(0.0))
    res = controller.SpecReason(tb, ts, cfg).run(
        tasks.question_tokens(_tasks()[0]), torch.Generator())
    assert res.spec_stats.rounds > 0
    kv = KVManager(tb.model.cfg, ts.model.cfg, KVBudget(1 << 20))
    sched = ContinuousScheduler(controller.SpecReason(tb, ts, cfg), kv,
                                spec_decode=True)
    assert sched.caches is not None
    h = sched.submit(_tasks()[0], generator=torch.Generator())
    sched.drain()
    assert h.result.thinking_ids == res.thinking_ids
    assert h.result.answer_ids == res.answer_ids
    assert sched.cache_stats()["base"]["lookups"] == 1


def test_serve_cli_on_cpu_matches_jax_cli(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    save_random_testbed(ckpt, seed=4)
    argv = ["--scheme", "specreason", "-n", "1", "--budget", "16",
            "--temperature", "0", "--ckpt-dir", ckpt]
    report = serve.main(argv + ["--device", "cpu", "--meters"])
    ours = capsys.readouterr().out
    (scheme, i, task, res), = report.runs
    assert scheme == "specreason" and res.steps
    assert res.meters["base"]["prefill_calls"] >= 1
    assert report.base.device.type == "cpu"
    jserve.main(argv + ["--decode-loop", "eager"])
    theirs = capsys.readouterr().out

    def line(out):
        (ln,) = [x for x in out.splitlines()
                 if x.startswith("[specreason] req0")]
        return ln.split("think=")[1].split()[0], ln.split("answer=")[1]
    assert line(ours) == line(theirs)


def test_missing_checkpoint_is_an_error(tmp_path, capsys):
    """A missing checkpoint is no longer an error: as the JAX loader does,
    the port's loader trains it (here 2 steps on the CPU), writes it and
    loads it."""
    base, small = load_testbed_engines(str(tmp_path), device="cpu",
                                       auto_train_steps=2)
    assert capsys.readouterr().out.count("missing: training") == 2
    for eng, cfg in ((base, testbed.BASE), (small, testbed.SMALL)):
        path = tmp_path / f"{cfg.name}.npz"
        assert eng.model.cfg.name == cfg.name and path.exists()
        assert tckpt.load_meta(str(path))["steps"] == 2
        written = tckpt.load_checkpoint(str(path), "cpu")
        for k, t in flatten(eng.params).items():
            assert not t.requires_grad
            assert torch.equal(t, flatten(written)[k])
