"""A sliding window over paged rows in the port, on the CPU: the plain
versions of paged flash-decode (#3) and paged span attention (#4) with a
window (``ref.paged_decode_reference`` / ``ref.paged_append_reference``
with ``window``, which ``ops`` runs for a CPU tensor) held to the
windowed dense reference on the gathered pages and, as the rows' layers
(``extend_rows_attention`` / ``decode_rows_attention``), to the JAX
package's masked attention (``prefill_self_attention`` /
``decode_self_attention`` with the window); then a reduced starcoder2
with window 8 on the batched path: the port's ``BatchEngine`` against
the JAX ``BatchEngine`` call for call over prompts longer than the
window, the continuous scheduler's greedy tokens against the port's
sequential ``Engine`` (chunked prefill on and off), and the prefix cache
on against off.

Inputs are made with numpy from fixed seeds; one torch thread.  fp32:
the plain versions against each other and the layers against JAX
atol = rtol = 1e-5; engine logits against JAX 2e-5 (a few layers of
fp32 sums in other orders).
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
from repro.models import attention as jattn
from repro.models.config import ModelConfig as JConfig
from repro.models.model import Model as JModel
from repro.sampling.sample import SamplingParams as JSampling
from repro.serving.batch_engine import BatchEngine as JBatchEngine
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import testbed
from repro_torch.core import controller
from repro_torch.core.policies import StaticThreshold
from repro_torch.data import tasks
from repro_torch.kernels import ref
from repro_torch.models import attention as tattn
from repro_torch.models.config import ModelConfig
from repro_torch.models.kvcache import paged_rows
from repro_torch.models.model import Model
from repro_torch.sampling.sample import SamplingParams
from repro_torch.serving import kv_manager as tkv
from repro_torch.serving.batch_engine import BatchEngine
from repro_torch.serving.engine import Engine
from repro_torch.serving.loader import arch_config
from repro_torch.serving.scheduler import ContinuousScheduler
from repro_torch.tokenizer import toy as tk

WINDOW = 8
FP32 = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=2e-5, atol=2e-5)
KV_HEADS, HEAD_DIM, BS = 2, 16, 4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _pages(rng, lens, kh=KV_HEADS, hd=HEAD_DIM, bs=BS):
    """A shuffled page pool and each row's table covering ``lens``."""
    nb = max(-(-n // bs) for n in lens)
    n_pages = len(lens) * nb + 3
    kp, vp = _f(rng, n_pages, kh, bs, hd), _f(rng, n_pages, kh, bs, hd)
    perm = rng.permutation(n_pages)[:len(lens) * nb]
    return kp, vp, torch.from_numpy(perm.reshape(len(lens), nb).astype(
        np.int32))


@pytest.mark.parametrize("window", [1, 5, 8, 40])
def test_paged_decode_reference_window(window):
    """Each row sees the last ``window`` of its ``lengths`` keys: the
    windowed dense reference on the gathered pages, and a per-row call
    over the window's keys alone."""
    rng = np.random.default_rng(window)
    lens = [1, 7, 23, 30]
    kp, vp, tab = _pages(rng, lens)
    q = _f(rng, len(lens), 6, HEAD_DIM)
    lengths = torch.tensor(lens, dtype=torch.int32)
    got = ref.paged_decode_reference(q, kp, vp, tab, lengths, window)
    kc, vc = ref._gather_pages(kp, tab), ref._gather_pages(vp, tab)
    torch.testing.assert_close(
        got, ref.decode_reference(q, kc, vc, lengths, window), **FP32)
    for b, n in enumerate(lens):
        lo = max(0, n - window)
        want = ref.decode_reference(
            q[b:b + 1], kc[b:b + 1, :, lo:n], vc[b:b + 1, :, lo:n],
            torch.tensor([n - lo], dtype=torch.int32))
        torch.testing.assert_close(got[b:b + 1], want, **FP32)


@pytest.mark.parametrize("window", [1, 3, 8, 40])
def test_paged_append_reference_window(window):
    """Query i of row b at ctx_b + i sees the keys in (ctx_b + i - window,
    ctx_b + i], committed and span alike: ``mha_reference`` with the
    window over the gathered context plus the span, row by row; a span
    longer than the window drops its early keys from its late
    queries."""
    rng = np.random.default_rng(10 + window)
    t, ctx, span = 12, [0, 3, 17, 9], [12, 7, 12, 1]
    kp, vp, tab = _pages(rng, [c + t for c in ctx])
    q, kn, vn = _f(rng, 4, t, 6, HEAD_DIM), _f(rng, 4, t, KV_HEADS,
                                                 HEAD_DIM), \
        _f(rng, 4, t, KV_HEADS, HEAD_DIM)
    cl = torch.tensor(ctx, dtype=torch.int32)
    sl = torch.tensor(span, dtype=torch.int32)
    got = ref.paged_append_reference(q, kn, vn, kp, vp, tab, cl, sl, window)
    for b, (c, n) in enumerate(zip(ctx, span)):
        kc = ref._gather_pages(kp, tab[b:b + 1])[:, :, :c]
        vc = ref._gather_pages(vp, tab[b:b + 1])[:, :, :c]
        k = torch.cat([kc, kn[b:b + 1, :n].transpose(1, 2)], 2)
        v = torch.cat([vc, vn[b:b + 1, :n].transpose(1, 2)], 2)
        want = ref.mha_reference(q[b:b + 1, :n].transpose(1, 2), k, v,
                                 True, c, None, window).transpose(1, 2)
        torch.testing.assert_close(got[b:b + 1, :n], want, **FP32)
        assert torch.all(got[b, n:] == 0)


def _cfg(cls, window):
    return cls(name="pw", n_layers=1, d_model=48, n_heads=6,
               n_kv_heads=KV_HEADS, head_dim=HEAD_DIM, d_ff=64,
               vocab_size=64, sliding_window=window).validate()


def _attn_params(rng, d=48, h=6):
    shapes = {"wq": (d, h, HEAD_DIM), "wk": (d, KV_HEADS, HEAD_DIM),
              "wv": (d, KV_HEADS, HEAD_DIM), "wo": (h, HEAD_DIM, d)}
    return {n: rng.standard_normal(s).astype(np.float32) * 0.3
            for n, s in shapes.items()}


def _store(rng, ctx, cap):
    """Dense (B, cap, K, hd) caches holding each row's context, and the
    same context in a (1, P, K, BS, hd) page store through shuffled
    tables of ``cap // BS`` blocks."""
    b, nb = len(ctx), cap // BS
    kc = rng.standard_normal((b, cap, KV_HEADS, HEAD_DIM)).astype(
        np.float32)
    vc = rng.standard_normal(kc.shape).astype(np.float32)
    perm = rng.permutation(b * nb + 1)[:b * nb].reshape(b, nb)
    kp = torch.zeros(1, b * nb + 1, KV_HEADS, BS, HEAD_DIM)
    vp = torch.zeros_like(kp)
    for r in range(b):
        for j in range(nb):
            kp[0, perm[r, j]] = torch.from_numpy(
                kc[r, j * BS:(j + 1) * BS]).transpose(0, 1)
            vp[0, perm[r, j]] = torch.from_numpy(
                vc[r, j * BS:(j + 1) * BS]).transpose(0, 1)
    return kc, vc, kp, vp, [list(t) for t in perm]


@pytest.mark.parametrize("window", [3, 8])
def test_rows_layers_match_jax_masked_attention(window):
    """The port's windowed rows layers over a paged store (an extend of
    T = 6 with ragged spans, then a one-token decode) against the JAX
    package's per-row ``prefill_self_attention`` /
    ``decode_self_attention`` with the window over dense caches holding
    the same context: outputs at the real positions, and the keys the
    port writes into the pages."""
    rng = np.random.default_rng(20 + window)
    jcfg, tcfg = _cfg(JConfig, window), _cfg(ModelConfig, window)
    p = _attn_params(rng)
    ctx, span, t, cap = [5, 0, 13], [6, 4, 2], 6, 24
    kc, vc, kp, vp, tables = _store(rng, ctx, cap)
    x = rng.standard_normal((3, t, 48)).astype(np.float32)
    oj, kj, vj = jattn.prefill_self_attention(
        jnp.asarray(x), {n: jnp.asarray(a) for n, a in p.items()}, jcfg,
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(ctx, jnp.int32),
        window)
    rows = paged_rows(kp, vp, tables, ctx, span, t)
    ot = tattn.extend_rows_attention(
        torch.from_numpy(x), {n: torch.from_numpy(a) for n, a in p.items()},
        tcfg, 0, rows)
    for b, n in enumerate(span):
        np.testing.assert_allclose(ot[b, :n].numpy(), np.asarray(oj)[b, :n],
                                   **FP32)
        for i in range(n):
            pos = ctx[b] + i
            page = tables[b][pos // BS]
            np.testing.assert_allclose(kp[0, page, :, pos % BS].numpy(),
                                       np.asarray(kj)[b, pos], **FP32)
    # one decode token a row at ctx + span, over what the extend wrote
    pos = [c + n for c, n in zip(ctx, span)]
    kd, vd = np.asarray(kj).copy(), np.asarray(vj).copy()
    xd = rng.standard_normal((3, 1, 48)).astype(np.float32)
    od, _, _ = jattn.decode_self_attention(
        jnp.asarray(xd), {n: jnp.asarray(a) for n, a in p.items()}, jcfg,
        jnp.asarray(kd), jnp.asarray(vd), jnp.asarray(pos, jnp.int32))
    rows = paged_rows(kp, vp, tables, pos, [1, 1, 1], 1)
    otd = tattn.decode_rows_attention(
        torch.from_numpy(xd), {n: torch.from_numpy(a) for n, a in p.items()},
        tcfg, 0, rows, rows.ctx_lens + 1)
    np.testing.assert_allclose(otd.numpy(), np.asarray(od), **FP32)


# ---------------------------------------------------------------------------
# a reduced starcoder2 with window 8 on the batched path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def star():
    """(JAX model, JAX params, port model, port params): the reduced
    starcoder2 with the toy vocabulary and window 8."""
    jcfg = dataclasses.replace(jregistry.reduced("starcoder2-7b"),
                               name="starcoder2-7b",
                               vocab_size=tk.VOCAB_SIZE,
                               sliding_window=WINDOW)
    tcfg = dataclasses.replace(arch_config("starcoder2-7b", reduced=True),
                               sliding_window=WINDOW)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(5))
    return jm, jp, Model(tcfg), tckpt.params_from_numpy(jckpt._flatten(jp),
                                                        device="cpu")


def _prompt(n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(10, 38, n)]


def test_batch_engine_matches_jax_over_the_window(star):
    """Three rows of four, prompts of 19, 11 and 23 tokens (past the
    window), a second extend of two rows, greedy decodes of 9 and 14
    tokens, a feed: logits and tokens against the JAX ``BatchEngine``."""
    jm, jp, tm, tp = star
    je = JBatchEngine(jm, jp, batch=4, capacity=128)
    te = BatchEngine(tm, tp, batch=4, capacity=128)
    rows = [je.alloc_row() for _ in range(3)]
    assert rows == [te.alloc_row() for _ in range(3)]
    prompts = [_prompt(19, 1), _prompt(11, 2), _prompt(23, 3)]
    for call_rows, toks in ((rows, prompts),
                            (rows[1:], [_prompt(13, 4), _prompt(5, 5)])):
        jl = je.extend_rows(call_rows, toks, want_logits=True)
        tl = te.extend_rows(call_rows, toks, want_logits=True)
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    jo = je.generate_rows([rows[0], rows[2]], [9, 14], [], JSampling(),
                          [jax.random.PRNGKey(i) for i in range(2)])
    to = te.generate_rows([rows[0], rows[2]], [9, 14], [], SamplingParams(),
                          [torch.Generator() for _ in range(2)])
    assert to == [[int(t) for t in o] for o in jo]
    je.feed_rows([rows[1]], [7])
    te.feed_rows([rows[1]], [7])
    assert list(te.pos[:3]) == list(je.pos[:3])
    assert min(te.pos[:3]) > WINDOW
    np.testing.assert_allclose(te.last_logits[:3].numpy(),
                               je.last_logits[:3], **TOL)


def _sched(star, small, chunked, prefix_cache, spec=False):
    _, _, tm, tp = star
    base = Engine(tm, tp, max_len=256, fused=False)
    cfg = controller.SpecReasonConfig(
        policy=StaticThreshold(4.5), token_budget=40,
        sampling=SamplingParams(0.0), use_spec_decode=spec, spec_gamma=3)
    sr = controller.SpecReason(base, small, cfg)
    kv = tkv.KVManager(base.model.cfg, small.model.cfg,
                       tkv.KVBudget(1 << 20))
    return sr, ContinuousScheduler(sr, kv, max_batch=3,
                                   chunked_prefill=chunked,
                                   prefix_cache=prefix_cache,
                                   max_prefill_tokens=16)


def _trace(res):
    return (res.thinking_ids, [int(t) for t in res.answer_ids],
            [(s.source, s.accepted, list(s.tokens)) for s in res.steps])


@pytest.fixture(scope="module")
def star_small():
    m = Model(testbed.MICRO_SMALL)
    return Engine(m, m.init(1, device="cpu"), max_len=256, fused=False)


@pytest.mark.parametrize("chunked", [True, False])
def test_continuous_equals_sequential_with_the_window(star, star_small,
                                                      chunked):
    """The continuous scheduler's greedy requests (windowed base rows over
    paged KV, the prefix cache on) give the sequential controller's
    traces on the same engines; the prompts and contexts pass the
    window.  Prefix cache on == off."""
    rng = random.Random(4)
    task_list = [tasks.sample_task(rng, min_steps=3) for _ in range(3)]
    task_list.append(task_list[0])
    sr, sched = _sched(star, star_small, chunked, True)
    handles = [sched.submit(t, generator=torch.Generator().manual_seed(i))
               for i, t in enumerate(task_list)]
    sched.drain()
    seq = [_trace(sr.run(tasks.question_tokens(t),
                         torch.Generator().manual_seed(i)))
           for i, t in enumerate(task_list)]
    assert [_trace(h.result) for h in handles] == seq
    assert all(len(tasks.question_tokens(t)) > WINDOW for t in task_list)
    assert sched.cache_stats()["base"]["hit_tokens"] > 0
    _, off = _sched(star, star_small, chunked, False)
    h_off = [off.submit(t, generator=torch.Generator().manual_seed(i))
             for i, t in enumerate(task_list)]
    off.drain()
    assert [_trace(h.result) for h in h_off] == seq
