"""The port's paged KV against the JAX package's: the plain versions of
the two paged kernels against ``repro.kernels.ref`` and the Pallas
kernels in interpret mode, the block-pool accounting driven through the
same random sequence of operations in both packages, and the page store.

Tolerances: fp32 atol = rtol = 1e-5 and bf16 2e-2 (as
tests/test_kernels.py: sums in another order; one bf16 ulp).  Rows past
a row's span_len are sliced off (the Pallas kernel leaves them
unspecified); an empty row is compared only where both sides define it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_append_attention import \
    paged_append_attention as pallas_append
from repro.kernels.paged_decode_attention import \
    paged_decode_attention as pallas_decode
from repro.serving import paged_kv as jpaged
from repro_torch.kernels import ops, ref
from repro_torch.serving import paged_kv as tpaged

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(a: np.ndarray, dtype: str):
    """The same numpy array as a JAX array and a torch tensor."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(a).astype(jd)
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _tables(rng, lens, bs, n_pages, alias):
    nb = max(1, max(-(-n // bs) for n in lens))
    perm = rng.permutation(n_pages)[:len(lens) * nb]
    t = perm.reshape(len(lens), nb).astype(np.int32)
    if alias and len(lens) > 1:
        t[1, 0] = t[0, 0]               # two rows share one page
    return t


DECODE_CASES = [
    # h, kh, hd, bs, lens
    (8, 4, 28, 16, [1, 17, 33, 0]),     # BASE heads; an empty row
    (4, 2, 32, 16, [48, 5]),            # SMALL heads
    (4, 4, 16, 8, [9, 16, 1]),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kh,hd,bs,lens", DECODE_CASES)
def test_paged_decode_plain_matches_jax(dtype, h, kh, hd, bs, lens):
    rng = np.random.default_rng(hd + bs + len(lens))
    n_pages = 3 * sum(-(-n // bs) + 1 for n in lens)
    jk, tk_ = _both(rng.standard_normal((n_pages, kh, bs, hd)), dtype)
    jv, tv = _both(rng.standard_normal((n_pages, kh, bs, hd)), dtype)
    jq, tq = _both(rng.standard_normal((len(lens), h, hd)), dtype)
    tbl = _tables(rng, lens, bs, n_pages, alias=True)
    lengths = np.asarray(lens, np.int32)
    got = ops.paged_decode_attention(tq, tk_, tv, torch.from_numpy(tbl),
                                     torch.from_numpy(lengths))
    exp = jref.paged_decode_reference(jq, jk, jv, jnp.asarray(tbl),
                                      jnp.asarray(lengths))
    np.testing.assert_allclose(_np(got), _np(exp), atol=TOL[dtype],
                               rtol=TOL[dtype])
    live = lengths > 0          # the Pallas kernel gives 0 on an empty row
    pallas = pallas_decode(jq, jk, jv, jnp.asarray(tbl),
                           jnp.asarray(lengths), interpret=True)
    np.testing.assert_allclose(_np(got)[live], _np(pallas)[live],
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert np.all(_np(pallas)[~live] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kh,hd,bs,lens", [
    (18, 2, 96, 16, [40, 3]),           # G = 9 (starcoder2-7b's), hd 96
    (9, 1, 128, 8, [33, 17]),           # G = 9, hd 128
    (16, 1, 96, 16, [48, 0]),           # G = 16 (qwen3-moe's), hd 96
    (32, 2, 128, 16, [40, 25]),         # G = 16, hd 128
])
def test_paged_decode_plain_matches_jax_wide_groups(dtype, h, kh, hd, bs,
                                                    lens):
    """The plain paged flash-decode against the jnp oracle at the query
    group sizes past the Pallas tests' (G = 9 and 16) and hd 96 and 128:
    the shapes the CUDA kernel takes since its block holds any G."""
    rng = np.random.default_rng(h + hd + bs)
    n_pages = 3 * sum(-(-n // bs) + 1 for n in lens)
    jk, tk_ = _both(rng.standard_normal((n_pages, kh, bs, hd)), dtype)
    jv, tv = _both(rng.standard_normal((n_pages, kh, bs, hd)), dtype)
    jq, tq = _both(rng.standard_normal((len(lens), h, hd)), dtype)
    tbl = _tables(rng, lens, bs, n_pages, alias=True)
    lengths = np.asarray(lens, np.int32)
    got = ref.paged_decode_reference(tq, tk_, tv, torch.from_numpy(tbl),
                                     torch.from_numpy(lengths))
    exp = jref.paged_decode_reference(jq, jk, jv, jnp.asarray(tbl),
                                      jnp.asarray(lengths))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(exp), atol=TOL[dtype],
                               rtol=TOL[dtype])


APPEND_CASES = [
    # h, kh, hd, bs, t, ctx, span
    (8, 4, 28, 16, 5, [0, 17, 40], [5, 3, 1]),     # verification, gamma+1
    (4, 2, 32, 16, 16, [33, 1, 64], [16, 0, 9]),   # an empty span
    (4, 2, 32, 8, 8, [24, 24], [8, 7]),            # aliased first page
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kh,hd,bs,t,ctx,span", APPEND_CASES)
def test_paged_append_plain_matches_jax(dtype, h, kh, hd, bs, t, ctx, span):
    rng = np.random.default_rng(hd + t + bs)
    b = len(ctx)
    lens = [c + t for c in ctx]
    n_pages = 3 * sum(-(-n // bs) + 1 for n in lens)
    jk, tk_ = _both(rng.standard_normal((n_pages, kh, bs, hd)), dtype)
    jv, tv = _both(rng.standard_normal((n_pages, kh, bs, hd)), dtype)
    jq, tq = _both(rng.standard_normal((b, t, h, hd)), dtype)
    jkn, tkn = _both(rng.standard_normal((b, t, kh, hd)), dtype)
    jvn, tvn = _both(rng.standard_normal((b, t, kh, hd)), dtype)
    tbl = _tables(rng, lens, bs, n_pages, alias=True)
    cl, sl = np.asarray(ctx, np.int32), np.asarray(span, np.int32)
    got = _np(ops.paged_append_attention(
        tq, tkn, tvn, tk_, tv, torch.from_numpy(tbl), torch.from_numpy(cl),
        torch.from_numpy(sl)))
    args = (jq, jkn, jvn, jk, jv, jnp.asarray(tbl), jnp.asarray(cl),
            jnp.asarray(sl))
    exp = _np(jref.paged_append_reference(*args))
    pallas = _np(pallas_append(*args, interpret=True))
    for i, n in enumerate(span):        # rows past span_len are sliced off
        np.testing.assert_allclose(got[i, :n], exp[i, :n], atol=TOL[dtype],
                                   rtol=TOL[dtype])
        np.testing.assert_allclose(got[i, :n], pallas[i, :n],
                                   atol=TOL[dtype], rtol=TOL[dtype])
        assert np.all(got[i, n:] == 0)  # the plain version zeroes them


def test_paged_plain_versions_match_dense_over_gathered_pages():
    """Through the store: tokens scattered into pages, then the paged
    plain versions equal the dense ones over the gathered cache."""
    rng = np.random.default_rng(3)
    pool = tpaged.PagedKVPool(12, 4)
    store = tpaged.PagedKVStore(pool, 1, 2, 8, "cpu")
    seq = tpaged.PagedSeq(pool)
    seq.append(10)
    kv = torch.from_numpy(rng.standard_normal((2, 1, 10, 2, 8))).float()
    store.scatter(seq, kv[0], kv[1], 0)
    k, v = store.gather(seq, 0)
    q = torch.from_numpy(rng.standard_normal((1, 4, 8))).float()
    tbl = torch.tensor([seq.blocks], dtype=torch.int32)
    lens = torch.tensor([10], dtype=torch.int32)
    got = ops.paged_decode_attention(q, store.k[0], store.v[0], tbl, lens)
    dense = ref.decode_reference(q, k[None].transpose(1, 2),
                                 v[None].transpose(1, 2), lens)
    torch.testing.assert_close(got, dense, atol=1e-6, rtol=1e-6)
    # the last 3 tokens as a span over the first 7 as context
    qs = torch.from_numpy(rng.standard_normal((1, 3, 4, 8))).float()
    span = ops.paged_append_attention(
        qs, k[None, 7:], v[None, 7:], store.k[0], store.v[0], tbl,
        torch.tensor([7], dtype=torch.int32),
        torch.tensor([3], dtype=torch.int32))
    full = ref.mha_reference(qs.transpose(1, 2), k[None].transpose(1, 2),
                             v[None].transpose(1, 2), q_offset=7)
    torch.testing.assert_close(span, full.transpose(1, 2), atol=1e-6,
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# accounting: the same random operations on both packages' pools
# ---------------------------------------------------------------------------

def _drive(mod, seed, n_ops=400):
    """A seeded random sequence of append / snapshot / truncate / restore
    / discard / free over a few sequences; returns the trace of every
    observable result."""
    rng = np.random.default_rng(seed)
    pool = mod.PagedKVPool(24, 4)
    seqs = [mod.PagedSeq(pool) for _ in range(3)]
    snaps = [[] for _ in seqs]
    trace = []
    for _ in range(n_ops):
        i = int(rng.integers(len(seqs)))
        s = seqs[i]
        op = int(rng.integers(6))
        try:
            if op == 0:
                trace.append(("append", i, s.append(int(rng.integers(0, 9)))))
            elif op == 1:
                snaps[i].append(s.snapshot())
                trace.append(("snapshot", i, snaps[i][-1]))
            elif op == 2:
                n = int(rng.integers(0, s.length + 1))
                trace.append(("truncate", i, s.truncate(n)))
            elif op == 3 and snaps[i]:
                snap = snaps[i].pop()
                if snap.length <= s.length:
                    trace.append(("restore", i, s.restore(snap)))
                else:
                    s.discard_snapshot(snap)
            elif op == 4 and snaps[i]:
                s.discard_snapshot(snaps[i].pop(0))
            elif op == 5 and rng.random() < 0.2:
                for snap in snaps[i]:
                    s.discard_snapshot(snap)
                snaps[i] = []
                s.free()
        except (jpaged.PoolExhausted, tpaged.PoolExhausted) as e:
            trace.append(("exhausted", i, type(e).__name__))
        trace.append(("state", [list(x.blocks) for x in seqs],
                      [x.length for x in seqs], pool.refcounts().tolist(),
                      pool.num_free))
    return trace


@pytest.mark.parametrize("seed", range(4))
def test_pool_accounting_matches_jax_under_random_ops(seed):
    jt, tt = _drive(jpaged, seed), _drive(tpaged, seed)
    norm = [tuple(x if not isinstance(x, jpaged.BlockTableSnapshot)
                  else ("snap", x.blocks, x.length) for x in e) for e in jt]
    got = [tuple(x if not isinstance(x, tpaged.BlockTableSnapshot)
                 else ("snap", x.blocks, x.length) for x in e) for e in tt]
    assert got == norm
    # the sequence exercised CoW copies on append and on truncate
    assert any(e[0] == "append" and e[2][1] for e in tt)
    assert any(e[0] == "truncate" and e[2][1] for e in tt)


def test_pad_block_tables_matches_jax():
    pools = [m.PagedKVPool(16, 4) for m in (jpaged, tpaged)]
    out = []
    for m, pool in zip((jpaged, tpaged), pools):
        seqs = [m.PagedSeq(pool) for _ in range(3)]
        for s, n in zip(seqs, (5, 0, 13)):
            s.append(n)
        out.append(m.pad_block_tables(seqs, max_blocks=2))
    np.testing.assert_array_equal(out[1], out[0])


# ---------------------------------------------------------------------------
# the page store
# ---------------------------------------------------------------------------

def test_store_scatter_gather_copies_match_jax():
    rng = np.random.default_rng(7)
    pools = {m: m.PagedKVPool(10, 4) for m in (jpaged, tpaged)}
    jstore = jpaged.PagedKVStore(pools[jpaged], 2, 2, 8)
    tstore = tpaged.PagedKVStore(pools[tpaged], 2, 2, 8, "cpu")
    seqs = {m: m.PagedSeq(pools[m]) for m in pools}
    stores = {jpaged: jstore, tpaged: tstore}

    def step(n):
        kv = rng.standard_normal((2, 2, n, 2, 8)).astype(np.float32)
        for m, seq in seqs.items():
            start = seq.length
            _, copies = seq.append(n)
            stores[m].apply_copies(copies)
            if m is jpaged:
                stores[m].scatter(seq, jnp.asarray(kv[0]), jnp.asarray(kv[1]),
                                  start)
            else:
                stores[m].scatter(seq, torch.from_numpy(kv[0]),
                                  torch.from_numpy(kv[1]), start)

    step(6)
    snaps = {m: s.snapshot() for m, s in seqs.items()}   # shares the tail
    step(5)                                                # CoW on append
    for m, seq in seqs.items():
        seq.restore(snaps[m])
    step(3)
    for layer in range(2):
        jk, jv = jstore.gather(seqs[jpaged], layer)
        tk_, tv = tstore.gather(seqs[tpaged], layer)
        np.testing.assert_array_equal(tk_.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tstore.k.numpy(),
                                  np.asarray(jstore.k_pages))
    assert tstore.nbytes == 2 * 2 * 10 * 2 * 4 * 8 * 4
