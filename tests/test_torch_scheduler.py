"""The port's continuous-batching scheduler over paged KV against the JAX
package's ``ContinuousScheduler`` (``prefix_cache=False``) on the
random-init MICRO pair: greedy thinking and answer tokens, step traces,
accept decisions and spec-decode statistics per request, tick and chunk
counts, with chunked prefill on and off and spec decode on and off.
``tests/test_torch_continuous.py`` holds the port's own identities and
the serve CLI.

Tolerances: utilities 1e-4 (tests/test_torch_controller.py).
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
from repro.serving import kv_manager as jkv
from repro.serving.engine import Engine as JEngine
from repro.serving.scheduler import ContinuousScheduler as JScheduler
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import testbed
from repro_torch.core import controller
from repro_torch.core.policies import StaticThreshold
from repro_torch.data import tasks
from repro_torch.models.model import Model
from repro_torch.sampling.sample import SamplingParams
from repro_torch.serving import kv_manager as tkv
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import ContinuousScheduler

UTILITY_TOL = 1e-4
THRESHOLD = 4.5
BUDGET = 40
N_REQ = 4
KV_BYTES = 1 << 20


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pairs():
    out = []
    for name, seed in (("MICRO", 0), ("MICRO_SMALL", 1)):
        jm = JModel(getattr(jtestbed, name))
        jp = jm.init(jax.random.PRNGKey(seed))
        tp = tckpt.params_from_numpy(jckpt._flatten(jp), device="cpu")
        out.append((JEngine(jm, jp, max_len=1024, fused=False),
                    Engine(Model(getattr(testbed, name)), tp, max_len=1024)))
    (jb, tb), (js, ts) = out
    return (jb, js), (tb, ts)


def _tasks():
    rng = random.Random(1)
    return [tasks.sample_task(rng) for _ in range(N_REQ)]


def _port_sched(pairs, temperature=0.0, spec=False, kv_bytes=KV_BYTES,
                **kw):
    _, (tb, ts) = pairs
    cfg = controller.SpecReasonConfig(
        policy=StaticThreshold(THRESHOLD), token_budget=BUDGET,
        sampling=SamplingParams(temperature), use_spec_decode=spec,
        spec_gamma=3)
    ctrl = controller.SpecReason(tb, ts, cfg)
    kv = tkv.KVManager(tb.model.cfg, ts.model.cfg, tkv.KVBudget(kv_bytes))
    kw.setdefault("prefix_cache", False)
    return ContinuousScheduler(ctrl, kv, max_batch=3, **kw)


def _port_run(pairs, **kw):
    sched = _port_sched(pairs, **kw)
    handles = [sched.submit(t, generator=torch.Generator().manual_seed(i))
               for i, t in enumerate(_tasks())]
    sched.drain()
    return sched, [h.result for h in handles]


def _trace(res):
    return (res.thinking_ids, [int(t) for t in res.answer_ids],
            [(s.source, s.accepted, list(s.tokens)) for s in res.steps],
            res.spec_stats.as_dict())


@pytest.mark.parametrize("chunked,spec", [(True, False), (False, True)])
def test_continuous_scheduler_matches_jax(pairs, chunked, spec):
    (jb, js), _ = pairs
    jcfg = jcontroller.SpecReasonConfig(
        policy=JThreshold(THRESHOLD), token_budget=BUDGET,
        sampling=JSampling(0.0), use_spec_decode=spec, spec_gamma=3)
    jctrl = jcontroller.SpecReason(jb, js, jcfg)
    jsched = JScheduler(jctrl, jkv.KVManager(jb.model.cfg, js.model.cfg,
                                             jkv.KVBudget(KV_BYTES)),
                        max_batch=3, prefix_cache=False,
                        chunked_prefill=chunked, max_prefill_tokens=16)
    jh = [jsched.submit(t, key=jax.random.PRNGKey(i))
          for i, t in enumerate(_tasks())]
    jsched.drain(jax.random.PRNGKey(0))
    tsched, tres = _port_run(pairs, spec=spec, chunked_prefill=chunked,
                             max_prefill_tokens=16)
    for h, r in zip(jh, tres):
        assert _trace(r) == _trace(h.result)
        np.testing.assert_allclose([s.utility for s in r.steps],
                                   [s.utility for s in h.result.steps],
                                   atol=UTILITY_TOL, rtol=0)
    assert (tsched.ticks, tsched.prefill_chunks, tsched.preemptions) == \
        (jsched.ticks, jsched.prefill_chunks, jsched.preemptions)
    decisions = {s.accepted for r in tres for s in r.steps
                 if s.source == "small"}
    assert decisions == {True, False}
    assert all(p.num_used == 0 for p in tsched.pools.values())
