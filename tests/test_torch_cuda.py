"""The port's CUDA kernels on the card: each against its plain version,
the wrappers' refusals, and the model and engine on CUDA against the CPU
(the sequential engine, the batched paged path, and an ssm model whose
extends go through the SSD scan kernel); the fused decode loops' CUDA
graphs (the sequential engine's and the batched rows') against the
per-token loops on the card.

Needs an NVIDIA GPU and nvcc (the kernels build on first use); every test
skips where CUDA is absent.  Imports no JAX, so it runs on a machine
without it:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: attention kernels fp32 atol = rtol = 2e-5, bf16 2e-2, the
SSD scan fp32 1e-4, bf16 y 3e-2 and its final state 1e-4 (as
tests/test_kernels.py); model logits card vs CPU atol = rtol = 1e-4
(fp32 GEMMs on both sides with TF32 off, summed in different orders).
"""

import dataclasses

import pytest
import torch

from repro_torch.checkpoint.checkpoint import params_from_numpy, \
    params_to_numpy
from repro_torch.configs import testbed
from repro_torch.kernels import decode_attention as dense_mod
from repro_torch.kernels import paged_decode_attention as paged_mod
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_append_attention import \
    paged_append_attention
from repro_torch.kernels.paged_decode_attention import \
    paged_decode_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import mamba2
from repro_torch.models.model import Model
from repro_torch.sampling.sample import SamplingParams
from repro_torch.serving.batch_engine import BatchEngine
from repro_torch.serving.engine import Engine
from repro_torch.serving.loader import arch_config

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LOGIT_TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA (an NVIDIA GPU)")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = flags


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kh,cap,hd,lens", [
    (1, 8, 4, 1024, 28, [300]),
    (4, 4, 2, 1024, 32, [1, 256, 257, 1024]),
    (2, 2, 2, 100, 16, [0, 100]),          # empty row gives 0
    (2, 24, 8, 600, 128, [600, 513]),
    (2, 4, 4, 700, 64, [700, 1]),          # G = 1
    (2, 6, 2, 900, 64, [900, 300]),        # G = 3
    (3, 16, 2, 1100, 64, [1100, 1, 555]),  # G = 8
    (2, 18, 2, 1000, 32, [999, 64]),       # G = 9
    (2, 32, 2, 2000, 128, [2000, 777]),    # G = 16
    (1, 40, 2, 600, 64, [600]),            # G = 20: two head groups
    (2, 12, 4, 800, 96, [800, 13]),        # hd 96
    (40, 8, 8, 512, 32, [512, 1, 300, 0] * 10),  # 320 blocks: no split
    (8, 24, 8, 4096, 128, [4096, 4000, 1, 0, 4095, 2048, 33, 3000]),
])
def test_decode_kernel_matches_plain(dev, dtype, b, h, kh, cap, hd, lens):
    gen = torch.Generator(device=dev).manual_seed(cap + hd)
    kc = _randn(gen, b, cap, kh, hd, dtype=dtype).permute(0, 2, 1, 3)
    vc = _randn(gen, b, cap, kh, hd, dtype=dtype).permute(0, 2, 1, 3)
    q = _randn(gen, b, h, hd, dtype=dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = decode_attention.launches
    out = decode_attention(q, kc, vc, lengths)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    exp = ref.decode_reference(q, kc, vc, lengths)
    live = lengths > 0          # the plain version averages an empty row
    torch.testing.assert_close(out[live].float(), exp[live].float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.all(out[~live] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kh,hd,s,cap,off,kv_len,causal,window", [
    (8, 4, 28, 16, 1024, 37, 1024, True, 0),
    (4, 2, 32, 256, 1024, 768, 1024, True, 0),
    (8, 4, 28, 5, 1024, 0, 1024, True, 0),
    (4, 2, 32, 100, 300, 50, 300, True, 40),
    (4, 2, 16, 64, 96, 20, 70, True, 0),
    (2, 2, 32, 128, 128, 0, 128, False, 0),
    (24, 8, 128, 300, 300, 0, 300, True, 0),
    (8, 4, 28, 16, 1024, 700, 1024, True, 0),    # BASE bucket, split keys
    (8, 4, 28, 16, 1024, 700, 1024, True, 600),  # split over keys 96..715
    (4, 4, 64, 37, 200, 13, 150, True, 0),       # G = 1, kv_len < cap
    (16, 2, 64, 45, 400, 300, 400, True, 0),     # G = 8, S % 8 != 0
    (18, 2, 32, 23, 500, 400, 500, True, 37),    # G = 9, window
    (32, 2, 64, 19, 600, 500, 600, True, 0),     # G = 16
    (12, 4, 96, 77, 300, 100, 300, True, 0),     # hd 96
    (6, 2, 64, 200, 600, 300, 600, True, 37),    # blocks straddle the window
    (16, 2, 64, 40, 128, 0, 100, False, 0),      # not causal, kv_len < cap
    (6, 2, 64, 50, 1000, 900, 1000, False, 0),   # not causal, split keys
    (24, 8, 128, 256, 2048, 1792, 2048, True, 0),  # minitron-4b chunk
    (24, 8, 128, 2048, 2048, 0, 2048, True, 0),    # minitron-4b prompt
])
def test_flash_kernel_matches_plain(dev, dtype, h, kh, hd, s, cap, off,
                                    kv_len, causal, window):
    gen = torch.Generator(device=dev).manual_seed(s + off)
    q = _randn(gen, 1, s, h, hd, dtype=dtype).permute(0, 2, 1, 3)
    kc = _randn(gen, 1, cap, kh, hd, dtype=dtype).permute(0, 2, 1, 3)
    vc = _randn(gen, 1, cap, kh, hd, dtype=dtype).permute(0, 2, 1, 3)
    args = (causal, off, kv_len, window)
    before = flash_attention.launches
    out = flash_attention(q, kc, vc, *args)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.stride() == q.stride()
    torch.testing.assert_close(out.float(),
                               ref.mha_reference(q, kc, vc, *args).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_rows_are_independent(dev, dtype):
    """Row b computed alone equals row b inside a batch of 4: a 256-query
    chunk at offset 1792 of minitron-4b's heads splits its keys over 5
    blocks alone and not at all in the batch, whose blocks fill the card
    (within the tolerance: the split changes the order of the sums)."""
    gen = torch.Generator(device=dev).manual_seed(17)
    h, kh, hd, s, cap, off = 24, 8, 128, 256, 2048, 1792
    q = _randn(gen, 4, s, h, hd, dtype=dtype).permute(0, 2, 1, 3)
    kc = _randn(gen, 4, cap, kh, hd, dtype=dtype).permute(0, 2, 1, 3)
    vc = _randn(gen, 4, cap, kh, hd, dtype=dtype).permute(0, 2, 1, 3)
    batch = flash_attention(q, kc, vc, True, off)
    for i in range(4):
        one = flash_attention(q[i:i + 1], kc[i:i + 1], vc[i:i + 1], True, off)
        torch.testing.assert_close(one[0].float(), batch[i].float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(
        batch.float(), ref.mha_reference(q, kc, vc, True, off).float(),
        atol=TOL[dtype], rtol=TOL[dtype])


def _pool(gen, n_pages, kh, bs, hd, dtype, layers=2):
    """A (L, P, K, bs, hd) store's layer 1, as the model passes it."""
    return _randn(gen, layers, n_pages, kh, bs, hd, dtype=dtype)[1]


def _tables(gen, lens, bs, n_pages, alias=False):
    """Shuffled page ids per row (distinct across rows unless ``alias``:
    then rows 0 and 1 share their first page)."""
    nb = max(1, max(-(-n // bs) for n in lens))
    perm = torch.randperm(n_pages, generator=gen, device="cuda")
    t = perm[:len(lens) * nb].reshape(len(lens), nb).to(torch.int32)
    if alias and len(lens) > 1:
        t[1, 0] = t[0, 0]
    return t.contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kh,hd,bs,lens", [
    (8, 4, 28, 16, [1, 17, 300, 0]),       # BASE heads, an empty row
    (4, 2, 32, 16, [129, 5, 1000]),        # SMALL heads, split-K
    (24, 8, 128, 16, [4096, 333]),         # minitron-4b heads
    (4, 4, 16, 8, [40, 40]),               # aliased first page
    (4, 4, 64, 16, [700, 3]),              # G = 1
    (6, 2, 64, 16, [1000, 257]),           # G = 3
    (16, 2, 64, 16, [513, 40]),            # G = 8
    (18, 2, 32, 16, [1000, 17]),           # G = 9
    (32, 2, 128, 16, [2000, 600]),         # G = 16
    (40, 2, 64, 16, [300]),                # G = 20: two head groups
    (12, 4, 96, 16, [900, 31]),            # hd 96
    (24, 8, 128, 24, [1000, 77, 49]),      # page runs cross the stages
    (8, 4, 28, 48, [1000, 500]),           # pages longer than a stage
    (8, 4, 28, 5, [333, 1, 40]),           # odd pages
])
def test_paged_decode_kernel_matches_plain(dev, dtype, h, kh, hd, bs, lens):
    gen = torch.Generator(device=dev).manual_seed(hd + bs)
    n_pages = 4 * sum(-(-n // bs) + 1 for n in lens)
    kp = _pool(gen, n_pages, kh, bs, hd, dtype)
    vp = _pool(gen, n_pages, kh, bs, hd, dtype)
    tables = _tables(gen, lens, bs, n_pages, alias=True)
    q = _randn(gen, len(lens), h, hd, dtype=dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = paged_decode_attention.launches
    out = paged_decode_attention(q, kp, vp, tables, lengths)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    exp = ref.paged_decode_reference(q, kp, vp, tables, lengths)
    live = lengths > 0          # the plain version averages an empty row
    torch.testing.assert_close(out[live].float(), exp[live].float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.all(out[~live] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernels_rows_are_independent(dev, dtype):
    """Row b computed alone equals row b inside a batch of 8, for the dense
    and the paged flash-decode at minitron-4b's heads: alone a row splits
    its 4096 keys over more blocks than in the batch (within the
    tolerance: the split changes the order of the sums)."""
    gen = torch.Generator(device=dev).manual_seed(18)
    h, kh, hd, bs, cap = 24, 8, 128, 16, 4096
    lens = [4096, 17, 1000, 0, 2047, 333, 4000, 64]
    q = _randn(gen, 8, h, hd, dtype=dtype)
    kc = _randn(gen, 8, cap, kh, hd, dtype=dtype).permute(0, 2, 1, 3)
    vc = _randn(gen, 8, cap, kh, hd, dtype=dtype).permute(0, 2, 1, 3)
    n_pages = 8 * cap // bs + 7
    kp = _pool(gen, n_pages, kh, bs, hd, dtype)
    vp = _pool(gen, n_pages, kh, bs, hd, dtype)
    tables = _tables(gen, lens, bs, n_pages, alias=True)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    assert dense_mod.plan(q[:1], kc[:1], vc[:1])["n_split"] > \
        dense_mod.plan(q, kc, vc)["n_split"]
    dense = decode_attention(q, kc, vc, lengths)
    paged = paged_decode_attention(q, kp, vp, tables, lengths)
    for i in range(8):
        one = decode_attention(q[i:i + 1], kc[i:i + 1], vc[i:i + 1],
                               lengths[i:i + 1])
        torch.testing.assert_close(one[0].float(), dense[i].float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
        one = paged_decode_attention(q[i:i + 1], kp, vp, tables[i:i + 1],
                                     lengths[i:i + 1])
        torch.testing.assert_close(one[0].float(), paged[i].float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.float32, 28, 16),     # 112-byte rows
    (torch.bfloat16, 28, 4),     # 56-byte rows: the narrow path
    (torch.float32, 30, 4),      # 120-byte rows
    (torch.bfloat16, 30, 4),
    (torch.float32, 15, 4),
    (torch.bfloat16, 15, 2),     # element by element
    (torch.bfloat16, 128, 16),
])
def test_decode_kernels_copy_width(dev, dtype, hd, want):
    """The C entry's copy width equals the Python mirror's and ``want`` for
    K/V rows of hd elements, and both kernels agree with their plain
    versions on that path, over a split (1000 keys) and a page run that
    crosses the stages."""
    gen = torch.Generator(device=dev).manual_seed(hd)
    b, h, kh, cap, bs = 2, 8, 4, 1000, 24
    lens = [1000, 77]
    q = _randn(gen, b, h, hd, dtype=dtype)
    kc = _randn(gen, b, cap, kh, hd, dtype=dtype).permute(0, 2, 1, 3)
    vc = _randn(gen, b, cap, kh, hd, dtype=dtype).permute(0, 2, 1, 3)
    n_pages = 2 * -(-cap // bs) + 3
    kp = _pool(gen, n_pages, kh, bs, hd, dtype)
    vp = _pool(gen, n_pages, kh, bs, hd, dtype)
    tables = _tables(gen, lens, bs, n_pages)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    for plan in (dense_mod.plan(q, kc, vc),
                 paged_mod.plan(q, kp, vp, tables)):
        assert plan["vector_bytes"] == plan["vector_bytes_mirror"] == want
        assert plan["n_split"] > 1
    torch.testing.assert_close(
        decode_attention(q, kc, vc, lengths).float(),
        ref.decode_reference(q, kc, vc, lengths).float(),
        atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(
        paged_decode_attention(q, kp, vp, tables, lengths).float(),
        ref.paged_decode_reference(q, kp, vp, tables, lengths).float(),
        atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kh,hd,bs,t,ctx,span", [
    (8, 4, 28, 16, 5, [0, 17, 300], [5, 3, 1]),
    (4, 2, 32, 16, 16, [100, 1, 64, 33], [16, 0, 9, 16]),
    (8, 4, 28, 16, 64, [700, 2], [64, 40]),
    (4, 2, 32, 16, 256, [0, 500], [200, 256]),
    (24, 8, 128, 16, 5, [4096], [5]),        # verification, split-K
    (24, 8, 128, 16, 64, [4096, 1000], [64, 30]),
    (4, 4, 16, 8, 8, [24, 24], [8, 7]),      # aliased first page
    (4, 4, 64, 16, 7, [50, 0, 333], [7, 4, 0]),   # G = 1
    (6, 2, 64, 16, 5, [129, 2048], [5, 2]),  # G = 3, T = 5: one fragment
    (6, 2, 64, 16, 7, [300, 33], [7, 6]),    # G = 3, T = 7: 21 rows
    (16, 2, 64, 16, 16, [200, 31], [16, 10]),     # G = 8
    (18, 2, 32, 16, 9, [70, 1000], [9, 5]),  # G = 9
    (32, 2, 64, 16, 12, [513, 40], [12, 3]),      # G = 16
    (24, 8, 128, 16, 256, [100, 0, 300, 17, 64, 1],
     [256, 200, 1, 256, 128, 77]),           # T = 256, 576 blocks: no split
])
def test_paged_append_kernel_matches_plain(dev, dtype, h, kh, hd, bs, t, ctx,
                                           span):
    gen = torch.Generator(device=dev).manual_seed(hd + t)
    b = len(ctx)
    lens = [c + t for c in ctx]
    n_pages = 4 * sum(-(-n // bs) + 1 for n in lens)
    kp = _pool(gen, n_pages, kh, bs, hd, dtype)
    vp = _pool(gen, n_pages, kh, bs, hd, dtype)
    tables = _tables(gen, lens, bs, n_pages, alias=True)
    q = _randn(gen, b, t, h, hd, dtype=dtype)
    kn = _randn(gen, b, t, kh, hd, dtype=dtype)
    vn = _randn(gen, b, t, kh, hd, dtype=dtype)
    cl = torch.tensor(ctx, dtype=torch.int32, device=dev)
    sl = torch.tensor(span, dtype=torch.int32, device=dev)
    before = paged_append_attention.launches
    out = paged_append_attention(q, kn, vn, kp, vp, tables, cl, sl)
    torch.cuda.synchronize()
    assert paged_append_attention.launches == before + 1
    exp = ref.paged_append_reference(q, kn, vn, kp, vp, tables, cl, sl)
    for i, n in enumerate(span):        # rows past span_len are unspecified
        if ctx[i] + n == 0:
            continue
        torch.testing.assert_close(out[i, :n].float(), exp[i, :n].float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_append_kernel_rows_are_independent(dev, dtype):
    """Row b computed alone equals row b inside a batch of 8 (within the
    tolerance: the split over the context depends on the batch), the
    row-independence that continuous == sequential rests on."""
    gen = torch.Generator(device=dev).manual_seed(16)
    h, kh, hd, bs, t = 24, 8, 128, 16, 5
    ctx = [4096, 17, 1000, 0, 2047, 333, 4000, 64]
    span = [5, 3, 5, 1, 4, 5, 2, 5]
    lens = [c + t for c in ctx]
    n_pages = len(lens) * -(-max(lens) // bs) + 7
    kp = _pool(gen, n_pages, kh, bs, hd, dtype)
    vp = _pool(gen, n_pages, kh, bs, hd, dtype)
    tables = _tables(gen, lens, bs, n_pages, alias=True)
    q = _randn(gen, 8, t, h, hd, dtype=dtype)
    kn = _randn(gen, 8, t, kh, hd, dtype=dtype)
    vn = _randn(gen, 8, t, kh, hd, dtype=dtype)
    cl = torch.tensor(ctx, dtype=torch.int32, device=dev)
    sl = torch.tensor(span, dtype=torch.int32, device=dev)
    batch = paged_append_attention(q, kn, vn, kp, vp, tables, cl, sl)
    for i in range(8):
        one = paged_append_attention(q[i:i + 1], kn[i:i + 1], vn[i:i + 1],
                                     kp, vp, tables[i:i + 1], cl[i:i + 1],
                                     sl[i:i + 1])
        torch.testing.assert_close(one[0, :span[i]].float(),
                                   batch[i, :span[i]].float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])


def test_paged_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros(2, 4, 32, device=dev)
    pages = torch.zeros(8, 2, 16, 32, device=dev)
    tables = torch.zeros(2, 3, dtype=torch.int32, device=dev)
    lens = torch.ones(2, dtype=torch.int32, device=dev)
    before = (paged_decode_attention.launches,
              paged_append_attention.launches)
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attention(q, pages, pages, tables.long(), lens)
    with pytest.raises(ValueError, match="lengths"):
        paged_decode_attention(q, pages, pages, tables, lens[:1])
    with pytest.raises(ValueError, match="H % K"):
        paged_decode_attention(torch.zeros(2, 5, 32, device=dev), pages,
                               pages, tables, lens)
    qs = torch.zeros(2, 5, 4, 32, device=dev)
    kn = torch.zeros(2, 5, 2, 32, device=dev)
    with pytest.raises(ValueError, match="k_new"):
        paged_append_attention(qs, kn[:, :4], kn[:, :4], pages, pages,
                               tables, lens, lens)
    with pytest.raises(ValueError, match="span_lens"):
        paged_append_attention(qs, kn, kn, pages, pages, tables, lens,
                               lens.long())
    assert (paged_decode_attention.launches,
            paged_append_attention.launches) == before
    # 18 query heads over 2 kv heads (G = 9) are taken
    out = paged_decode_attention(torch.zeros(2, 18, 32, device=dev), pages,
                                 pages, tables, lens)
    assert out.shape == (2, 18, 32) and torch.all(out == 0)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 4, 32, device=dev)
    k = torch.zeros(1, 2, 64, 32, device=dev)
    lens = torch.ones(1, dtype=torch.int32, device=dev)
    before = (decode_attention.launches, flash_attention.launches)
    with pytest.raises(ValueError, match="unit stride"):
        decode_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                         k, lens)
    with pytest.raises(ValueError, match="int32"):
        decode_attention(q, k, k, lens.long())
    with pytest.raises(ValueError, match="dtypes"):
        decode_attention(q.half(), k.half(), k.half(), lens)
    with pytest.raises(ValueError, match="H % K"):
        decode_attention(torch.zeros(1, 5, 32, device=dev),
                         k, k, lens)
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention(q[:, :, None], k, k, kv_len=65)
    assert (decode_attention.launches, flash_attention.launches) == before
    # 18 query heads over 2 kv heads (G = 9) are taken
    out = decode_attention(torch.zeros(1, 18, 32, device=dev), k, k, lens)
    assert out.shape == (1, 18, 32) and torch.all(out == 0)


@pytest.mark.parametrize("name", ["MICRO", "BASE"])
def test_model_logits_on_card_match_cpu(dev, name):
    m = Model(getattr(testbed, name))
    params = m.init(3, device="cpu")
    on_card = params_from_numpy(params_to_numpy(params), dev)
    toks = torch.randint(0, 64, (1, 21), generator=torch.Generator()
                         .manual_seed(0))
    outs = {}
    for d, p in (("cpu", params), ("cuda", on_card)):
        st = m.init_state(1, 128, device=d)
        a, st = m.prefill(p, toks[:, :16].to(d), st)
        seq = [a[0]]
        for t in range(16, 21):
            a, st = m.decode_step(p, st, toks[:, t:t + 1].to(d))
            seq.append(a)
        seq.append(m.forward(p, toks.to(d))[0])
        outs[d] = torch.cat(seq).cpu()
    torch.testing.assert_close(outs["cuda"], outs["cpu"], atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_engine_on_card_launches_per_metered_call(dev):
    m = Model(testbed.SMALL)
    params = m.init(1, device="cpu")
    prompt = list(range(10, 30))
    greedy = SamplingParams()
    tokens = {}
    for d in ("cpu", "cuda"):
        p = params_from_numpy(params_to_numpy(params), d)
        e = Engine(m, p, max_len=256)
        decode_attention.launches = flash_attention.launches = 0
        s = e.extend(e.new_session(), prompt)
        ids, s, _ = e.generate(s, 12, [], greedy, torch.Generator(device=d))
        s = e.extend(s, ids[:3])
        tokens[d] = ids
        if d == "cuda":
            n = m.cfg.n_layers
            assert decode_attention.launches == n * e.meter.decode_steps
            assert flash_attention.launches == n * e.meter.prefill_calls
        else:
            assert decode_attention.launches == flash_attention.launches == 0
    assert tokens["cuda"] == tokens["cpu"]


@pytest.mark.parametrize("name", ["SMALL", "BASE"])
def test_batch_engine_on_card_matches_cpu_and_counts_launches(dev, name):
    """The batched paged path on the card: logits against the CPU's plain
    versions, greedy tokens, and paged launches == n_layers x the metered
    decode steps and extends (the dense kernels stay at 0)."""
    m = Model(getattr(testbed, name))
    params = m.init(1, device="cpu")
    prompts = [list(range(10, 15)), list(range(20, 59)), [7]]
    out = {}
    for d in ("cpu", "cuda"):
        p = params_from_numpy(params_to_numpy(params), d)
        be = BatchEngine(m, p, batch=4, capacity=256, fused=False)
        for k in (decode_attention, flash_attention, paged_decode_attention,
                  paged_append_attention):
            k.launches = 0
        rows = [be.alloc_row() for _ in prompts]
        logits = be.extend_rows(rows, prompts, want_logits=True)
        ids = be.generate_rows(rows, [9, 4, 12], [], SamplingParams(),
                               [torch.Generator(device=d) for _ in rows])
        be.feed_rows(rows[:2], [3, 4])
        out[d] = (torch.cat(logits + [be.last_logits[rows]]).cpu(), ids)
        n = m.cfg.n_layers
        if d == "cuda":
            assert paged_decode_attention.launches == \
                n * be.meter.decode_steps == n * (12 + 1)
            assert paged_append_attention.launches == \
                n * be.meter.prefill_calls
        assert decode_attention.launches == flash_attention.launches == 0
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0],
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert out["cuda"][1] == out["cpu"][1]


def test_sliding_window_decode_on_card_raises(dev):
    cfg = dataclasses.replace(testbed.MICRO, sliding_window=8)
    m = Model(cfg)
    p = m.init(0, device=dev)
    st = m.init_state(1, 16, device=dev)
    with pytest.raises(NotImplementedError, match="CUDA kernel"):
        m.decode_step(p, st, torch.zeros(1, 1, dtype=torch.long,
                                         device=dev))


SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _ssd_inputs(gen, dtype, b, l, h, p, g, n, real=None, layout="dense"):
    """x, dt, a, B, C of a scan; positions from ``real`` on are the
    caller's pads (x, dt, B, C = 0).  layout "xbc": x, B and C are views
    of one (b, l, h*p + 2*g*n) tensor, as ``apply_mamba`` slices the conv
    output (B's and C's stride over L is the channel count)."""
    di, gn = h * p, g * n
    xbc = _randn(gen, b, l, di + 2 * gn)
    xbc[..., di:] *= 0.3
    dt = torch.nn.functional.softplus(_randn(gen, b, l, h))
    a = -torch.exp(_randn(gen, h) * 0.5)
    if real is not None:
        xbc[:, real:] = 0
        dt[:, real:] = 0
    xbc = xbc.to(dtype)
    x, bb, cc = (xbc[..., :di].reshape(b, l, h, p),
                 xbc[..., di:di + gn].reshape(b, l, g, n),
                 xbc[..., di + gn:].reshape(b, l, g, n))
    if layout == "dense":
        x, bb, cc = x.contiguous(), bb.contiguous(), cc.contiguous()
    return x, dt, a, bb, cc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,h,p,g,n,chunk,real,layout,init", [
    (1, 37, 64, 64, 1, 128, 37, 37, "dense", True),   # mamba2-1.3b heads,
    #                                                   one ragged chunk
    (2, 256, 4, 16, 2, 32, 64, 256, "dense", True),   # G > 1, 4 chunks
    (1, 2048, 64, 64, 1, 128, 128, 2048, "xbc", True),  # mamba2 prompt
    (1, 384, 64, 64, 1, 128, 128, 300, "xbc", True),  # padded tail
    (2, 9, 4, 5, 1, 7, 1, 9, "dense", True),          # Q = 1; element
    #       copies, element y stores, states pitched to 36 floats (P N = 35)
    (1, 256, 2, 48, 1, 16, 64, 256, "dense", False),  # P 48, N 16, no state
    (1, 200, 2, 80, 1, 256, 40, 200, "dense", True),  # N 256, two P tiles
    (3, 96, 8, 32, 2, 64, 32, 96, "xbc", True),       # B = 3, G 2, H/G 4
    (1, 100, 4, 36, 2, 18, 50, 90, "xbc", False),     # ragged everything,
    #                                                   element copies
], ids=["37", "g2", "2048", "384-pad", "q1", "p48-n16-none", "n256-p80",
        "b3-g2", "ragged"])
def test_ssd_kernel_matches_plain(dev, dtype, b, l, h, p, g, n, chunk, real,
                                  layout, init):
    gen = torch.Generator(device=dev).manual_seed(l + g + n)
    x, dt, a, bb, cc = _ssd_inputs(gen, dtype, b, l, h, p, g, n, real, layout)
    init = _randn(gen, b, h, p, n) * 0.5 if init else None
    before = ssd_scan.launches
    y, fin = ssd_scan(x, dt, a, bb, cc, chunk, init)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert y.dtype == dtype and fin.dtype == torch.float32
    zero = torch.zeros(b, h, p, n, device=dev)
    ye, fe = ref.ssd_reference(x, dt, a, bb, cc, zero if init is None
                               else init)
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y[:, :real].float(), ye[:, :real].float(),
                               atol=tol, rtol=tol)
    torch.testing.assert_close(fin, fe, atol=1e-4, rtol=1e-4)
    if dtype == torch.float32:
        yp, fp = mamba2.ssd_chunked(x, dt, a, bb, cc, chunk, init)
        torch.testing.assert_close(y[:, :real], yp[:, :real], atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(fin, fp, atol=tol, rtol=tol)
    if chunk > 1:
        with pytest.raises(ValueError, match="divide L"):
            ssd_scan(x[:, :l - 1], dt[:, :l - 1], a, bb[:, :l - 1],
                     cc[:, :l - 1], chunk, init)
    assert ssd_scan.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_carries_the_state_across_calls(dev, dtype):
    """Two calls carrying the state (384 then 256 positions, three and
    two chunks of 128) equal one call over 640: the boundary between the
    calls falls between chunks of the multi-chunk route."""
    gen = torch.Generator(device=dev).manual_seed(7)
    x, dt, a, bb, cc = _ssd_inputs(gen, dtype, 1, 640, 64, 64, 1, 128,
                                   layout="xbc")
    init = _randn(gen, 1, 64, 64, 128) * 0.5
    y, fin = ssd_scan(x, dt, a, bb, cc, 128, init)
    y1, f1 = ssd_scan(x[:, :384], dt[:, :384], a, bb[:, :384], cc[:, :384],
                      128, init)
    y2, f2 = ssd_scan(x[:, 384:], dt[:, 384:], a, bb[:, 384:], cc[:, 384:],
                      128, f1)
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(torch.cat([y1, y2], 1).float(), y.float(),
                               atol=tol, rtol=tol)
    torch.testing.assert_close(f2, fin, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("l,chunk", [(8, 8), (16, 4)])
def test_ssd_kernel_takes_an_unaligned_state(dev, l, chunk):
    """An initial state 4 bytes off a 16-byte boundary (a contiguous view
    into a larger buffer), on the one-chunk and the multi-chunk route, P x
    N = 35: the result equals the same state's aligned copy's."""
    gen = torch.Generator(device=dev).manual_seed(l)
    x, dt, a, bb, cc = _ssd_inputs(gen, torch.float32, 1, l, 2, 5, 1, 7)
    init = _randn(gen, 2 * 5 * 7 + 1)[1:].view(1, 2, 5, 7)
    assert init.data_ptr() % 16 != 0
    y, fin = ssd_scan(x, dt, a, bb, cc, chunk, init)
    ya, fa = ssd_scan(x, dt, a, bb, cc, chunk, init.clone())
    torch.testing.assert_close(y, ya, atol=0, rtol=0)
    torch.testing.assert_close(fin, fa, atol=0, rtol=0)
    ye, fe = ref.ssd_reference(x, dt, a, bb, cc, init)
    torch.testing.assert_close(y, ye, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(fin, fe, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,h,p,g,n,chunk,layout,route,copies", [
    (1, 37, 64, 64, 1, 128, 37, "xbc", "one chunk", "16-byte"),
    (1, 2048, 64, 64, 1, 128, 128, "xbc", "chunks", "16-byte"),
    (3, 96, 8, 80, 2, 256, 32, "dense", "chunks", "16-byte"),
    (1, 100, 4, 36, 2, 18, 50, "xbc", "chunks", "element"),
])
def test_ssd_plan_matches_its_mirror(dev, dtype, b, l, h, p, g, n, chunk,
                                     layout, route, copies):
    """The C entry's plan of a call: its grids, threads and dynamic shared
    memory equal ``tile_plan.ssd_plan``'s, every launch fits on an SM, and
    the copy variant is the one the call's bases and strides allow."""
    from repro_torch.kernels import ssd_scan as ssd_mod
    gen = torch.Generator(device=dev).manual_seed(3)
    x, dt, a, bb, cc = _ssd_inputs(gen, dtype, b, l, h, p, g, n,
                                   layout=layout)
    before = ssd_scan.launches
    pl = ssd_mod.plan(x, dt, a, bb, cc, chunk)
    assert ssd_scan.launches == before
    assert pl["route"] == route and pl["copies"] == copies
    for got, want in zip(pl["launches"], pl["mirror"]["launches"]):
        for key in ("blocks", "threads", "smem_bytes"):
            assert got[key] == want[key], (got, want)
        assert got["registers"] > 0 and got["blocks_per_sm"] >= 1


def test_ssm_model_on_card_matches_cpu_and_counts_launches(dev):
    """The reduced mamba2-1.3b on the card against the CPU: a padded
    prefill, a resumed extend and decode steps; the scan kernel launches
    once per layer and extend."""
    m = Model(arch_config("mamba2-1.3b", reduced=True))
    params = m.init(2, device="cpu")
    toks = torch.randint(0, 64, (1, 80), generator=torch.Generator()
                         .manual_seed(0))
    outs = {}
    for d in ("cpu", "cuda"):
        p = params_from_numpy(params_to_numpy(params), d)
        ssd_scan.launches = 0
        st = m.init_state(1, 0, device=d)
        a, st = m.prefill(p, toks[:, :70].to(d), st)
        seq = [a[0]]
        a, st = m.prefill(p, toks[:, 70:77].to(d), st)
        seq.append(a[0])
        for t in range(77, 80):
            a, st = m.decode_step(p, st, toks[:, t:t + 1].to(d))
            seq.append(a)
        outs[d] = torch.cat(seq).cpu()
        assert ssd_scan.launches == (2 * m.cfg.n_layers if d == "cuda"
                                     else 0)
    torch.testing.assert_close(outs["cuda"], outs["cpu"], atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


# ---------------------------------------------------------------------------
# the fused decode loop: CUDA graphs with flash-decode inside
# ---------------------------------------------------------------------------

def _base_engine(dev, max_len=256, seed=1):
    m = Model(testbed.BASE)
    return Engine(m, m.init(seed, device=dev), max_len=max_len)


def _two_calls(eng, fused, temperature, seed=7):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sp = SamplingParams(temperature=temperature)
    s = eng.extend(eng.new_session(), list(range(10, 31)))
    out = []
    for budget, stops in ((37, [2]), (11, [])):
        ids, s, probs = eng.generate(s, budget, stops, sp, gen,
                                     collect_probs=True, fused=fused)
        out.append((ids, probs))
    return out, s, torch.rand(3, generator=gen, device="cuda")


@pytest.mark.parametrize("temperature", [0.0, 0.6])
def test_fused_graphs_match_eager_on_card(dev, temperature):
    """Two consecutive calls on one generator: the replayed graphs give
    the per-token loop's tokens, probabilities, logits and position, and
    leave the generator where it does; decode launches == n_layers x the
    decode steps, masked and warm-up steps included."""
    eng = _base_engine(dev)
    eo, es, enext = _two_calls(eng, False, temperature)
    eng.meter.reset()
    decode_attention.launches = 0
    fo, fs, fnext = _two_calls(eng, True, temperature)
    assert [i for i, _ in fo] == [i for i, _ in eo]
    for (_, fp), (_, ep) in zip(fo, eo):
        for a, b in zip(fp, ep):
            torch.testing.assert_close(torch.from_numpy(a),
                                       torch.from_numpy(b), rtol=2e-4,
                                       atol=2e-5)
    assert fs.pos == es.pos
    torch.testing.assert_close(fs.last_logits, es.last_logits, rtol=2e-4,
                               atol=2e-4)
    torch.testing.assert_close(fnext, enext, rtol=0, atol=0)
    m = eng.meter
    assert m.decode_calls == 2 and eng.captures == 2
    assert decode_attention.launches == \
        eng.model.cfg.n_layers * m.decode_steps > 0
    # at most ceil(budget / k) + 1 waits a call
    assert m.decode_syncs <= (-(-37 // 8) + 1) + (-(-11 // 8) + 1)


def test_fused_sessions_interleaved_on_card(dev):
    """Two live sessions of one engine hold two KV pairs, so their graphs
    differ; interleaved calls each give their own per-token run."""
    eng = _base_engine(dev)
    sp = SamplingParams()
    prompts = [list(range(10, 25)), list(range(30, 38))]
    want = []
    for p in prompts:
        s = eng.extend(eng.new_session(), p)
        ids = []
        for budget in (9, 6, 13):
            got, s, _ = eng.generate_eager(s, budget, [], sp,
                                           torch.Generator(device="cuda"))
            ids.append(got)
        want.append(ids)
    sess = [eng.extend(eng.new_session(), p) for p in prompts]
    assert sess[0].state.k.data_ptr() != sess[1].state.k.data_ptr()
    got = [[], []]
    for budget in (9, 6, 13):
        for r in (0, 1):
            ids, sess[r], _ = eng.generate_fused(
                sess[r], budget, [], sp, torch.Generator(device="cuda"))
            got[r].append(ids)
    assert got == want


def test_fused_captures_once_per_key_on_card(dev):
    """Three sequential SpecReason requests: new sessions take the freed
    KV pairs again, so each engine captures once per key, not once per
    request."""
    from repro_torch.core.controller import SpecReason, SpecReasonConfig
    from repro_torch.core.policies import StaticThreshold
    base = _base_engine(dev, max_len=512)
    sm = Model(testbed.SMALL)
    small = Engine(sm, sm.init(2, device=dev), max_len=512)
    cfg = SpecReasonConfig(policy=StaticThreshold(4.5), token_budget=64,
                           sampling=SamplingParams())
    captures, calls = [], 0
    for i in range(3):
        res = SpecReason(base, small, cfg).run(
            list(range(10 + i, 30)), torch.Generator(device="cuda"))
        calls += sum(m["decode_calls"] for m in res.meters.values())
        captures.append(base.captures + small.captures)
    assert captures[-1] == len(base._loops) + len(small._loops) < calls
    # every request's graphs run over one KV pair an engine
    for eng in (base, small):
        assert len({key[:2] for key in eng._loops}) == 1


_CAPTURE_FAILS = """
import sys, torch
from repro_torch.configs import testbed
from repro_torch.models.model import Model
from repro_torch.sampling.sample import SamplingParams
from repro_torch.serving import engine as engine_mod

real = engine_mod.sample
def syncing(logits, params, gen):
    int(logits.argmax())            # a host read inside the body
    return real(logits, params, gen)
engine_mod.sample = syncing
m = Model(testbed.MICRO)
eng = engine_mod.Engine(m, m.init(0, device="cuda"), max_len=64)
s = eng.extend(eng.new_session(), [5, 6, 7])
try:
    eng.generate(s, 8, [], SamplingParams(), torch.Generator(device="cuda"))
except RuntimeError as e:
    print("raised", eng.meter.decode_calls, eng.captures, type(e).__name__)
    sys.exit(0)
print("returned")
sys.exit(1)
"""


def test_fused_capture_failure_raises_on_card(dev):
    """A host sync inside the captured body makes the capture raise, and
    nothing runs the per-token loop instead (in a child process: a failed
    capture may leave the CUDA context unusable)."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    out = subprocess.run([sys.executable, "-c", _CAPTURE_FAILS],
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": src})
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.split()[:3] == ["raised", "0", "0"], out.stdout


# ---------------------------------------------------------------------------
# the batched rows' fused decode loop: CUDA graphs with paged flash-decode
# ---------------------------------------------------------------------------

def _rows_engine(dev, params=None, batch=4):
    m = Model(testbed.BASE)
    return BatchEngine(m, params or m.init(1, device=dev), batch=batch,
                       capacity=256)


def _rows_calls(be, fused, temperature):
    """Three rows, then two calls with per-row budgets and stop sets, the
    second on a subset; returns every observable."""
    sp = SamplingParams(temperature=temperature)
    generate = be.generate_rows_fused if fused else be.generate_rows_eager
    rows = [be.alloc_row() for _ in range(3)]
    be.extend_rows(rows, [list(range(10, 31)), list(range(5, 12)), [9, 8]])
    gens = [torch.Generator(device="cuda").manual_seed(7 + i)
            for i in range(3)]
    out = [generate(rows, [37, 20, 9], [], sp, gens,
                    stop_ids_rows=[[2], [], [5]], collect_probs=True),
           generate([rows[2], rows[0]], [11, 6], [], sp, [gens[2], gens[0]],
                    collect_probs=True)]
    return (out, be.pos.copy(), be.last_logits.clone(),
            [torch.rand(3, generator=g, device="cuda") for g in gens])


@pytest.mark.parametrize("temperature", [0.0, 0.6])
def test_fused_rows_graphs_match_eager_on_card(dev, temperature):
    """The replayed graphs give the per-token loop's tokens, positions and
    logits bit for bit (both launch every row slot at the same shapes),
    its probabilities, and leave each row's generator where it does;
    paged-decode launches follow the replays: n_layers x the decode
    steps, masked and warm-up steps included."""
    eager = _rows_engine(dev)
    eo, epos, elog, enext = _rows_calls(eager, False, temperature)
    be = _rows_engine(dev, eager.params)
    paged_decode_attention.launches = 0
    fo, fpos, flog, fnext = _rows_calls(be, True, temperature)
    torch.cuda.synchronize()
    for (fi, fp), (ei, ep) in zip(fo, eo):
        assert fi == ei
        for a, b in zip(fp, ep):
            torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
    assert sum(len(i) for i in eo[0][0]) > 20
    assert (fpos == epos).all() and torch.equal(flog, elog)
    for a, b in zip(fnext, enext):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    m = be.meter
    assert m.decode_calls == 2 and be.captures == 2
    assert paged_decode_attention.launches == \
        be.model.cfg.n_layers * m.decode_steps > 0
    assert m.decode_syncs <= (-(-37 // 8) + 1) + (-(-11 // 8) + 1)


def test_fused_rows_capture_once_per_key_on_card(dev):
    """Calls on different row subsets, rows freed and allocated between
    them, replay one graph a key."""
    be = _rows_engine(dev)
    sp = SamplingParams()
    rows = [be.alloc_row() for _ in range(4)]
    be.extend_rows(rows, [list(range(10, 10 + n)) for n in (3, 9, 17, 30)])
    for subset in ([0, 1, 2, 3], [3], [1, 2], [2, 0]):
        be.generate_rows([rows[i] for i in subset], 6, [], sp,
                         [torch.Generator(device="cuda") for _ in subset])
    be.free_row(rows[1])
    r = be.alloc_row()
    be.extend_rows([r], [[4, 5, 6]])
    be.generate_rows([r, rows[3]], [5, 7], [], sp,
                     [torch.Generator(device="cuda") for _ in range(2)])
    assert be.captures == len(be._loops) == 1
    assert be.meter.decode_calls == 5


_ROWS_CAPTURE_FAILS = """
import sys, torch
from repro_torch.configs import testbed
from repro_torch.models.model import Model
from repro_torch.sampling.sample import SamplingParams
from repro_torch.serving import batch_engine as be_mod

real = be_mod.sample_rows
def syncing(logits, params, gens):
    int(logits.argmax())            # a host read inside the body
    return real(logits, params, gens)
be_mod.sample_rows = syncing
m = Model(testbed.MICRO)
be = be_mod.BatchEngine(m, m.init(0, device="cuda"), batch=2, capacity=64)
r = be.alloc_row()
be.extend_rows([r], [[5, 6, 7]])
try:
    be.generate_rows([r], 8, [], SamplingParams(),
                     [torch.Generator(device="cuda")])
except RuntimeError as e:
    print("raised", be.meter.decode_calls, be.captures, type(e).__name__)
    sys.exit(0)
print("returned")
sys.exit(1)
"""


def test_fused_rows_capture_failure_raises_on_card(dev):
    """A host sync inside the rows loop's captured body makes the capture
    raise, and nothing runs the per-token loop instead (in a child
    process: a failed capture may leave the CUDA context unusable)."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    out = subprocess.run([sys.executable, "-c", _ROWS_CAPTURE_FAILS],
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": src})
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.split()[:3] == ["raised", "0", "0"], out.stdout
