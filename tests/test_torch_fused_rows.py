"""The batched engine's fused decode loop (``BatchEngine.
generate_rows_fused``) on the CPU, where its body of masked one-token
steps over every row slot runs eagerly (on the card the same body is
replayed as a CUDA graph: tests/test_torch_cuda.py).

Held to the port's per-token loop (``generate_rows_eager``), exactly:
both run the forward over every row slot at the same shapes, so tokens,
probabilities, positions, last logits, the Meter's tokens and calls and
each row's generator agree bit for bit, greedy and sampled, with
per-row budgets and stop sets.  Rows outside a call, free slots and
every page byte outside the call's (row, position) slots stay as they
were; rows that join and leave between calls replay one loop per key;
budgets clamp at the capacity per row.  Held to the JAX package's
``BatchEngine.generate_rows`` from the same parameters, greedy: tokens,
positions, and logits at atol = rtol = 5e-5 (tests/test_torch_batch.py).
The continuous scheduler under either loop is held to the sequential
controller in tests/test_torch_continuous.py.
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
from repro_torch.serving import graph_loop
from repro_torch.serving.batch_engine import BatchEngine
from repro_torch.tokenizer import toy as tk

TOL = dict(rtol=5e-5, atol=5e-5)
SAMPLED = SamplingParams(temperature=0.8, top_k=20, top_p=0.95)
STOPS = [[tk.STEP, tk.THINK_END], [tk.EOS], []]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    m = Model(testbed.SMALL)
    return m, m.init(1, device="cpu")


def _prompt(n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(10, 38, n)]


def _engine(small, batch=4, capacity=128):
    m, p = small
    return BatchEngine(m, p, batch=batch, capacity=capacity)


def _pool_pages(be):
    """Both page arrays without the scratch page."""
    p = be.store.scratch_page
    return be.store.k[:, :p].clone(), be.store.v[:, :p].clone()


def _loop(be, fused):
    """The engine's generate_rows (None), its fused loop or its per-token
    loop."""
    if fused is None:
        return be.generate_rows
    return be.generate_rows_fused if fused else be.generate_rows_eager


def _drive(be, fused, sp, seed=0):
    """Three rows with ragged prompts, then two calls with per-row budgets
    and stop sets (the second on a subset); returns every observable."""
    generate = _loop(be, fused)
    rows = [be.alloc_row() for _ in range(3)]
    be.extend_rows(rows, [_prompt(9, 1), _prompt(20, 2), _prompt(3, 3)])
    gens = [torch.Generator().manual_seed(seed + i) for i in range(3)]
    be.meter.reset()
    a = generate(rows, [12, 30, 9], [], sp, gens, stop_ids_rows=STOPS,
                 collect_probs=True)
    b = generate([rows[2], rows[0]], [7, 5], [tk.EOS], sp,
                 [gens[2], gens[0]], collect_probs=True)
    return dict(calls=[a, b], pos=be.pos.copy(),
                logits=be.last_logits.clone(), meter=be.meter.as_dict(),
                next=[torch.rand(3, generator=g) for g in gens],
                pages=_pool_pages(be))


@pytest.mark.parametrize("sp", [SamplingParams(), SAMPLED],
                         ids=["greedy", "sampled"])
def test_fused_rows_match_eager(small, sp):
    e = _drive(_engine(small), False, sp)
    be = _engine(small)
    assert be.fused                    # the default of a dense engine
    f = _drive(be, None, sp)
    for (fi, fp), (ei, ep) in zip(f["calls"], e["calls"]):
        assert fi == ei
        assert [p.shape for p in fp] == [p.shape for p in ep]
        assert all(torch.equal(a, b) for a, b in zip(fp, ep))
    assert sum(map(len, e["calls"][0][0])) > 10
    np.testing.assert_array_equal(f["pos"], e["pos"])
    assert torch.equal(f["logits"], e["logits"])
    assert all(torch.equal(a, b) for a, b in zip(f["next"], e["next"]))
    assert all(torch.equal(a, b) for a, b in zip(f["pages"], e["pages"]))
    fm, em = f["meter"], e["meter"]
    for key in ("decode_tokens", "decode_calls"):
        assert fm[key] == em[key]
    assert em["decode_steps"] == max(map(len, e["calls"][0][0])) \
        + max(map(len, e["calls"][1][0]))
    # whole chunks of k = 8 steps a call
    assert fm["decode_steps"] % graph_loop.FUSED_CHUNK == 0
    assert fm["decode_syncs"] == 0 and be.captures == 0


@pytest.mark.parametrize("sp", [SamplingParams(), SAMPLED],
                         ids=["greedy", "sampled"])
def test_rows_outside_the_call_and_free_slots_unchanged(small, sp):
    """A call on rows 0 and 2 of four slots (row 1 live, slot 3 free):
    row 1 and slot 3 keep their positions and logits, and no page byte
    changes outside the slots the call's tokens take."""
    be = _engine(small)
    rows = [be.alloc_row() for _ in range(3)]
    be.extend_rows(rows, [_prompt(9, 1), _prompt(20, 2), _prompt(3, 3)])
    pos0, logits0 = be.pos.copy(), be.last_logits.clone()
    k0, v0 = _pool_pages(be)
    out = be.generate_rows([rows[0], rows[2]], [10, 14], [], sp,
                           [torch.Generator().manual_seed(i) for i in (0, 2)])
    assert [len(o) for o in out] == [10, 14]
    for r in (rows[1], 3):
        assert be.pos[r] == pos0[r]
        assert torch.equal(be.last_logits[r], logits0[r])
    written = torch.zeros(k0.shape[1], k0.shape[3], dtype=torch.bool)
    bs = be.pool.block_size
    for r, o in zip((rows[0], rows[2]), out):
        for t in range(int(pos0[r]), int(pos0[r]) + len(o)):
            written[be.seqs[r].blocks[t // bs], t % bs] = True
    k1, v1 = _pool_pages(be)
    keep = ~written[None, :, None, :, None].expand_as(k0)
    assert torch.equal(k1[keep], k0[keep]) and torch.equal(v1[keep], v0[keep])
    assert not torch.equal(k1, k0)


def test_rows_join_and_leave_replay_one_loop(small):
    """Rows freed and allocated between calls take the same key: one
    loop serves every call, and each call gives the per-token loop's
    tokens on a twin engine driven the same way."""
    got, want = [], []
    for fused, out in ((True, got), (False, want)):
        be = _engine(small, batch=3)
        generate = _loop(be, fused)
        r0, r1 = be.alloc_row(), be.alloc_row()
        be.extend_rows([r0, r1], [_prompt(5, 4), _prompt(11, 5)])
        out.append(generate([r0, r1], [6, 8], [], SAMPLED,
                            [torch.Generator().manual_seed(1),
                             torch.Generator().manual_seed(2)]))
        be.free_row(r0)
        r2 = be.alloc_row()
        r3 = be.alloc_row()
        be.extend_rows([r2, r3], [_prompt(7, 6), _prompt(2, 7)])
        out.append(generate([r3, r1, r2], [8, 3, 5], [tk.EOS], SAMPLED,
                            [torch.Generator().manual_seed(i)
                             for i in (3, 4, 5)]))
        be.free_row(r1)
        out.append(generate([r2], 7, [], SAMPLED,
                            [torch.Generator().manual_seed(6)]))
        if fused:
            assert len(be._loops) == 1 and be.meter.decode_calls == 3
    assert got == want


def test_fused_rows_clamp_each_budget_at_capacity(small):
    """Each row's budget is clamped to its own free slots; a row at the
    capacity decodes nothing and a call of such rows meters nothing."""
    be = _engine(small, batch=3, capacity=64)
    rows = [be.alloc_row() for _ in range(3)]
    be.extend_rows(rows, [_prompt(61, 8), _prompt(50, 9), _prompt(10, 10)])
    out = be.generate_rows(rows, [10, 10, 4], [], SAMPLED,
                           [torch.Generator().manual_seed(i)
                            for i in range(3)])
    assert [len(o) for o in out] == [3, 10, 4]
    assert be.pos.tolist() == [64, 60, 14]
    calls = be.meter.decode_calls
    assert be.generate_rows([rows[0]], 5, [], SamplingParams(),
                            [torch.Generator()]) == [[]]
    ids, probs = be.generate_rows([rows[0]], 5, [], SamplingParams(),
                                  [torch.Generator()], collect_probs=True)
    assert ids == [[]] and probs[0].shape == (0, be.last_logits.shape[1])
    assert be.meter.decode_calls == calls


def test_fused_rows_match_jax_greedy():
    """The fused loop's greedy tokens, positions and logits against the
    JAX package's fused multi-row decode from the same parameters."""
    jm = JModel(jtestbed.MICRO)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = tckpt.params_from_numpy(jckpt._flatten(jp), device="cpu")
    je = JBatchEngine(jm, jp, batch=4, capacity=128)
    te = BatchEngine(Model(testbed.MICRO), tp, batch=4, capacity=128)
    rows = [je.alloc_row() for _ in range(3)]
    assert [te.alloc_row() for _ in range(3)] == rows
    prompts = [_prompt(11, 11), _prompt(4, 12), _prompt(17, 13)]
    je.extend_rows(rows, prompts)
    te.extend_rows(rows, prompts)
    jout = je.generate_rows(rows, [9, 13, 6], [], JSampling(),
                            [jax.random.PRNGKey(i) for i in range(3)],
                            stop_ids_rows=STOPS)
    tout = te.generate_rows_fused(rows, [9, 13, 6], [], SamplingParams(),
                                  [torch.Generator() for _ in range(3)],
                                  stop_ids_rows=STOPS)
    assert tout == jout and sum(map(len, tout)) > 10
    np.testing.assert_array_equal(te.pos, je.pos)
    np.testing.assert_allclose(te.last_logits[rows].numpy(),
                               np.asarray(je.last_logits, np.float32)[rows],
                               **TOL)
