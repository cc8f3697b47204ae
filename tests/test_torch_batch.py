"""The port's batched engine over paged KV against the JAX package's
BatchEngine (dense rows), and against the port's own sequential Engine.

Both packages get the same weights (JAX ``Model.init`` bridged through
numpy).  Tolerances: logits atol = rtol = 5e-5 against JAX (as
tests/test_torch_model.py: fp32 sums in another order over a few
layers); inside the port, batched paged rows against the sequential
dense engine atol = rtol = 1e-5 (the same arithmetic with the attention
summed over pages instead of a dense cache, and GEMMs over more rows).
Greedy tokens and Meter counts are identical.
"""

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import testbed as jtestbed
from repro.models.model import Model as JModel
from repro.sampling.sample import SamplingParams as JSampling
from repro.serving.batch_engine import BatchEngine as JBatchEngine
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import testbed
from repro_torch.models.model import Model
from repro_torch.sampling.sample import SamplingParams
from repro_torch.serving.batch_engine import BatchEngine
from repro_torch.serving.engine import Engine
from repro_torch.serving.paged_kv import PagedKVPool, PagedSeq
from repro_torch.tokenizer import toy as tk

TOL = dict(rtol=5e-5, atol=5e-5)
SELF_TOL = dict(rtol=1e-5, atol=1e-5)
METER_KEYS = ("prefill_tokens", "prefill_calls", "decode_tokens",
              "decode_calls")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(name, seed=0):
    jm = JModel(getattr(jtestbed, name))
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, tckpt.params_from_numpy(jckpt._flatten(jp), device="cpu")


def _prompt(n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(10, 38, n)]


def _assert_logits(tl, jl, **tol):
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32), **tol)


@pytest.mark.parametrize("name", ["MICRO", "SMALL"])
def test_batch_engine_matches_jax(name):
    jm, jp, tp = _params(name)
    je = JBatchEngine(jm, jp, batch=3, capacity=256)
    te = BatchEngine(Model(getattr(testbed, name)), tp, batch=3,
                     capacity=256)
    jrows = [je.alloc_row() for _ in range(3)]
    trows = [te.alloc_row() for _ in range(3)]
    assert jrows == trows
    rows = trows
    prompts = [_prompt(11, 1), _prompt(5, 2), _prompt(17, 3)]
    jl = je.extend_rows(rows, prompts, want_logits=True)
    tl = te.extend_rows(rows, prompts, want_logits=True)
    for a, b in zip(tl, jl):
        _assert_logits(a, b, **TOL)

    jsp, tsp = JSampling(), SamplingParams()
    keys = [jax.random.PRNGKey(i) for i in range(3)]
    gens = [torch.Generator() for _ in range(3)]
    stops = [[tk.STEP, tk.THINK_END], [tk.EOS], []]
    jout = je.generate_rows([rows[0], rows[2]], [6, 9], [], jsp,
                            [keys[0], keys[2]],
                            stop_ids_rows=[stops[0], stops[2]])
    tout = te.generate_rows([rows[0], rows[2]], [6, 9], [], tsp,
                            [gens[0], gens[2]],
                            stop_ids_rows=[stops[0], stops[2]])
    assert tout == jout and any(tout)
    _assert_logits(te.last_logits, je.last_logits, **TOL)

    # ragged continuation at per-row offsets, then all rows together
    jl = je.extend_rows([rows[1]], [_prompt(4, 4)], want_logits=True)
    tl = te.extend_rows([rows[1]], [_prompt(4, 4)], want_logits=True)
    _assert_logits(tl[0], jl[0], **TOL)
    jout = je.generate_rows(rows, [5, 3, 7], [tk.EOS], jsp, keys)
    tout = te.generate_rows(rows, [5, 3, 7], [tk.EOS], tsp, gens)
    assert tout == jout
    # spec-decode style rollback: truncate, then feed and extend
    for be in (je, te):
        be.truncate_row(rows[0], int(be.pos[rows[0]]) - 2)
        be.feed_rows([rows[0], rows[2]], [12, 13])
        be.extend_rows([rows[1], rows[2]], [[14, 15, 16], [17]])
    np.testing.assert_array_equal(te.pos, je.pos)
    _assert_logits(te.last_logits, je.last_logits, **TOL)
    jm_, tm_ = je.meter.as_dict(), te.meter.as_dict()
    assert {k: tm_[k] for k in METER_KEYS} == {k: jm_[k] for k in METER_KEYS}
    assert tm_["decode_steps"] == 9 + 7 + 1    # forwards: 9, 7, one feed


def _engines(name="SMALL", seed=1):
    m = Model(getattr(testbed, name))
    p = m.init(seed, device="cpu")
    return Engine(m, p, max_len=256), BatchEngine(m, p, batch=3,
                                                  capacity=256)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_batched_rows_match_sequential_engine(temperature):
    """Inside the port: each batched paged row takes the sequential dense
    engine's tokens from the same generator, greedy and sampled."""
    seq, be = _engines()
    sp = SamplingParams(temperature=temperature)
    prompts = [_prompt(9, 5), _prompt(20, 6), _prompt(3, 7)]
    budgets = [12, 7, 15]
    expect, last = [], []
    for i, (pr, n) in enumerate(zip(prompts, budgets)):
        s = seq.extend(seq.new_session(), pr)
        ids, s, _ = seq.generate(s, n, [tk.EOS], sp,
                                 torch.Generator().manual_seed(i))
        expect.append(ids)
        last.append(s.last_logits[0])
    rows = [be.alloc_row() for _ in prompts]
    be.extend_rows(rows, prompts)
    got = be.generate_rows(rows, budgets, [tk.EOS], sp,
                           [torch.Generator().manual_seed(i)
                            for i in range(3)])
    assert got == expect
    torch.testing.assert_close(be.last_logits[rows], torch.stack(last),
                               **SELF_TOL)


def test_generate_rows_collects_probs_and_clamps_to_capacity():
    _, be = _engines("MICRO", 0)
    r = be.alloc_row()
    be.extend_rows([r], [_prompt(250, 8)])
    ids, probs = be.generate_rows([r], 20, [], SamplingParams(temperature=1.0),
                                  [torch.Generator()], collect_probs=True)
    assert len(ids[0]) == 6 and probs[0].shape == (6, be.last_logits.shape[1])
    torch.testing.assert_close(probs[0].sum(-1), torch.ones(6))
    assert be.generate_rows([r], 5, [], SamplingParams(),
                            [torch.Generator()]) == [[]]
    with pytest.raises(ValueError, match="context overflow"):
        be.extend_rows([r], [[1]])


def test_engine_over_a_callers_pool_needs_reserved_pages():
    m = Model(testbed.MICRO)
    pool = PagedKVPool(8, 16)
    be = BatchEngine(m, m.init(0, device="cpu"), batch=2, capacity=64,
                     pool=pool)
    with pytest.raises(ValueError, match="PagedSeq"):
        be.alloc_row()
    seq = PagedSeq(pool)
    r = be.alloc_row(seq)
    with pytest.raises(RuntimeError, match="not reserved"):
        be.extend_rows([r], [_prompt(5, 9)])
    be.append_seq(seq, 5)
    be.extend_rows([r], [_prompt(5, 9)])
    assert be.pos[r] == 5 and pool.num_used == 1
    be.free_row(r)
    assert pool.num_used == 1          # the caller's to free
