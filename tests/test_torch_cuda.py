"""The port's CUDA kernels on the card: each against its plain version
(#3 and #4 also with a sliding window), the wrappers' refusals, and the
model and engine on CUDA against the CPU (the sequential engine, the
batched paged path, an ssm model whose extends go through the SSD scan
kernel, the moe family: its layer, its fused loop, its coupled
rows, and the encdec and vlm families over their cached cross K/V);
the fused decode loops' CUDA
graphs (the sequential engine's, dense and ssm, and the batched rows')
against the per-token loops on the card; the attention backward kernel
against its plain version, and training gradients on the card against
the CPU.

Needs an NVIDIA GPU and nvcc (the kernels build on first use); every test
skips where CUDA is absent.  Imports no JAX, so it runs on a machine
without it:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: attention kernels fp32 atol = rtol = 2e-5, bf16 2e-2, the
SSD scan fp32 1e-4, bf16 y 3e-2 and its final state 1e-4 (as
tests/test_kernels.py); model logits card vs CPU atol = rtol = 1e-4
(fp32 GEMMs on both sides with TF32 off, summed in different orders);
the attention backward atol = rtol = 2e-5 up to S = 128 and 1e-4 beyond,
training gradients rtol 1e-4, the atol of both that tolerance times the
largest magnitude of the compared gradient.
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
from repro_torch.data import pipeline
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
from repro_torch.kernels.paged_append_attention import \
    paged_append_attention
from repro_torch.kernels.paged_decode_attention import \
    paged_decode_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import mamba2
from repro_torch.models.model import Model, flatten, unflatten
from repro_torch.sampling.sample import SamplingParams
from repro_torch.serving.batch_engine import BatchEngine
from repro_torch.serving.engine import Engine
from repro_torch.serving.loader import arch_config, \
    attach_cross_source, stub_source
from repro_torch.training import loss as tloss
from repro_torch.training.train_loop import TrainConfig, train

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
    (1, 8, 8, 1500, 64, [1500]),           # whisper-base's cross K/V
    (1, 32, 8, 1601, 128, [1601]),         # llama-3.2-vision's cross K/V
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
    (8, 8, 64, 1500, 1500, 0, 1500, False, 0),     # whisper-base encoder
    (8, 8, 64, 64, 1500, 0, 1500, False, 0),       # its cross prefill
    (32, 8, 128, 64, 1601, 0, 1601, False, 0),     # llama-3.2-vision's
    (32, 8, 128, 1500, 1601, 0, 1601, False, 0),   # tails on both axes
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
    """A ring-buffered (sliding-window) cache has no kernel: decoding it on
    the card raises.  A linear windowed cache runs #1 with its window
    (``test_windowed_decode_kernel_matches_plain``)."""
    cfg = dataclasses.replace(testbed.MICRO, sliding_window=8)
    m = Model(cfg)
    p = m.init(0, device=dev)
    st = m.init_state(1, 8, device=dev, ring=True)
    with pytest.raises(NotImplementedError, match="ring"):
        m.decode_step(p, st, torch.zeros(1, 1, dtype=torch.long,
                                         device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kh,cap,hd,window,lens", [
    (8, 25, 5, 4096, 64, 2048, [4096] * 8),        # hymba-1.5b's heads
    (2, 36, 4, 8192, 128, 4096, [8192, 5000]),     # starcoder2-7b's
    (6, 25, 5, 4096, 64, 2048, [0, 1, 700, 2048, 2049, 4096]),
    (3, 4, 4, 300, 32, 8, [300, 9, 3]),            # G = 1
    (2, 18, 2, 1000, 96, 100, [999, 64]),          # G = 9, hd 96
    (40, 8, 8, 512, 32, 37, [512, 1, 300, 0] * 10),  # no split
])
def test_windowed_decode_kernel_matches_plain(dev, dtype, b, h, kh, cap, hd,
                                              window, lens):
    """#1 with a window against ``ref.decode_reference(..., window)``:
    rows below, at and above the window, split and unsplit plans; the
    unwindowed launch of the same cache is unchanged."""
    gen = torch.Generator(device=dev).manual_seed(cap + hd + window)
    kc = _randn(gen, b, cap, kh, hd, dtype=dtype).permute(0, 2, 1, 3)
    vc = _randn(gen, b, cap, kh, hd, dtype=dtype).permute(0, 2, 1, 3)
    q = _randn(gen, b, h, hd, dtype=dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = decode_attention.launches
    out = decode_attention(q, kc, vc, lengths, window)
    full = decode_attention(q, kc, vc, lengths)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2
    live = lengths > 0
    for got, w in ((out, window), (full, 0)):
        exp = ref.decode_reference(q, kc, vc, lengths, w)
        torch.testing.assert_close(got[live].float(), exp[live].float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.all(out[~live] == 0)
    with pytest.raises(ValueError, match="window"):
        decode_attention(q, kc, vc, lengths, -1)



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kh,hd,bs,window,lens", [
    (36, 4, 128, 16, 4096, [8192, 5000, 4097, 4096]),   # starcoder2-7b
    (16, 8, 64, 16, 4096, [4096, 4500, 1]),             # granite's heads
    (8, 4, 28, 16, 8, [1, 9, 300, 0]),      # BASE heads, window 8
    (4, 4, 16, 5, 7, [333, 6, 40]),         # odd pages, G = 1
    (18, 2, 32, 16, 100, [1000, 17]),       # G = 9
])
def test_windowed_paged_decode_kernel_matches_plain(dev, dtype, h, kh, hd,
                                                    bs, window, lens):
    """#3 with a window against ``ref.paged_decode_reference(...,
    window)`` over shuffled, aliased pages: rows below, at and above the
    window; the same call without a window beside it."""
    gen = torch.Generator(device=dev).manual_seed(hd + bs + window)
    n_pages = 4 * sum(-(-n // bs) + 1 for n in lens)
    kp = _pool(gen, n_pages, kh, bs, hd, dtype)
    vp = _pool(gen, n_pages, kh, bs, hd, dtype)
    tables = _tables(gen, lens, bs, n_pages, alias=True)
    q = _randn(gen, len(lens), h, hd, dtype=dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = paged_decode_attention.launches
    out = paged_decode_attention(q, kp, vp, tables, lengths, window)
    full = paged_decode_attention(q, kp, vp, tables, lengths)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 2
    live = lengths > 0
    for got, w in ((out, window), (full, 0)):
        exp = ref.paged_decode_reference(q, kp, vp, tables, lengths, w)
        torch.testing.assert_close(got[live].float(), exp[live].float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.all(out[~live] == 0)
    with pytest.raises(ValueError, match="window"):
        paged_decode_attention(q, kp, vp, tables, lengths, -1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kh,hd,bs,t,window,ctx,span", [
    (36, 4, 128, 16, 64, 4096, [8192, 4000], [64, 30]),   # starcoder2-7b
    (36, 4, 128, 16, 5, 4096, [8192, 100], [5, 5]),       # verification
    (16, 8, 64, 16, 64, 4096, [4096, 5000], [64, 64]),    # granite's heads
    (16, 8, 64, 16, 5, 4096, [4096, 4093], [5, 2]),
    (8, 4, 28, 16, 16, 8, [0, 3, 40, 300], [16, 16, 5, 16]),  # window < T
    (4, 2, 32, 16, 64, 8, [100, 7], [64, 33]),        # several span tiles
    (4, 4, 16, 5, 8, 7, [24, 6], [8, 7]),             # odd pages, G = 1
    (18, 2, 32, 16, 9, 100, [70, 1000], [9, 5]),      # G = 9
])
def test_windowed_paged_append_kernel_matches_plain(dev, dtype, h, kh, hd,
                                                    bs, t, window, ctx,
                                                    span):
    """#4 with a window against ``ref.paged_append_reference(...,
    window)``: committed keys below the window skipped, tiles crossing a
    window start masked per element, windows shorter than the span (the
    span's early keys leave its late queries' window); the same call
    without a window beside it.  Every query of the span is compared
    (``span_lens = T``, as a moe extend's pads attend)."""
    gen = torch.Generator(device=dev).manual_seed(hd + t + window)
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
    for sp in (span, [t] * b):
        sl = torch.tensor(sp, dtype=torch.int32, device=dev)
        before = paged_append_attention.launches
        out = paged_append_attention(q, kn, vn, kp, vp, tables, cl, sl,
                                     window)
        full = paged_append_attention(q, kn, vn, kp, vp, tables, cl, sl)
        torch.cuda.synchronize()
        assert paged_append_attention.launches == before + 2
        for got, w in ((out, window), (full, 0)):
            exp = ref.paged_append_reference(q, kn, vn, kp, vp, tables, cl,
                                             sl, w)
            for i, n in enumerate(sp):
                torch.testing.assert_close(
                    got[i, :n].float(), exp[i, :n].float(),
                    atol=TOL[dtype], rtol=TOL[dtype])
    with pytest.raises(ValueError, match="window"):
        paged_append_attention(q, kn, vn, kp, vp, tables, cl, sl, -1)

def _hybrid_engine(dev, seed=2, window=8):
    cfg = dataclasses.replace(arch_config("hymba-1.5b", reduced=True),
                              sliding_window=window)
    m = Model(cfg)
    return Engine(m, m.init(seed, device=dev), max_len=96)


def test_hybrid_model_on_card_matches_cpu(dev):
    """The reduced hymba with window 8: a 21-token prefill, a 7-token
    extend and 12 decodes past the window, card logits and conv/ssm
    against the CPU's; #2 and #5 launch once a layer an extend, #1 once a
    layer a decode."""
    eng = _hybrid_engine(dev)
    m, n = eng.model, eng.model.cfg.n_layers
    toks = torch.randint(0, 64, (1, 40), generator=torch.Generator()
                         .manual_seed(1))
    out = {}
    for d in ("cuda", "cpu"):
        p = eng.params if d == "cuda" else \
            unflatten({k: t.cpu() for k, t in flatten(eng.params).items()})
        counts = (flash_attention.launches, ssd_scan.launches,
                  decode_attention.launches)
        st = m.init_state(1, 64, device=d)
        a, st = m.prefill(p, toks[:, :21].to(d), st)
        b, st = m.prefill(p, toks[:, 21:28].to(d), st)
        rows = [a[0], b[0]]
        for t in range(28, 40):
            c, st = m.decode_step(p, st, toks[:, t:t + 1].to(d))
            rows.append(c)
        out[d] = (torch.cat(rows).cpu(), st.conv.cpu(), st.ssm.cpu())
        if d == "cuda":
            torch.cuda.synchronize()
            assert (flash_attention.launches - counts[0],
                    ssd_scan.launches - counts[1],
                    decode_attention.launches - counts[2]) == \
                (2 * n, 2 * n, 12 * n)
    torch.testing.assert_close(out["cuda"], out["cpu"], atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


@pytest.mark.parametrize("temperature", [0.0, 0.6])
def test_hybrid_fused_graphs_match_eager_on_card(dev, temperature):
    """The reduced hymba with window 8: the replayed graphs give the
    per-token loop's tokens, logits, K/V and conv/ssm; a second request
    captures nothing (its K/V pair comes from the pool, its conv/ssm go
    through the static pair)."""
    eng = _hybrid_engine(dev)
    assert eng.fused
    eo, es, enext = _two_calls(eng, False, temperature)
    want = (es.pos, es.last_logits, es.state.conv, es.state.ssm)
    del es          # frees its pooled K/V pair for the fused calls
    fo, fs, fnext = _two_calls(eng, True, temperature)
    assert [i for i, _ in fo] == [i for i, _ in eo]
    assert fs.pos == want[0] > 21 + 8
    torch.testing.assert_close((fs.last_logits, fs.state.conv, fs.state.ssm),
                               want[1:], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(fnext, enext, rtol=0, atol=0)
    caps = eng.captures
    assert caps == len(eng._loops) == 2
    del fs
    _two_calls(eng, True, temperature)
    assert eng.captures == caps and len(eng._kv_pool[(1, 96, 0)]) == 1


def _cross_engine(dev, arch):
    """An engine over ``arch``'s reduced config (vocabulary 64), the vlm
    gates drawn nonzero (they start at zero), its sessions attached to
    the stub source."""
    model = Model(arch_config(arch, reduced=True))
    params = model.init(5, device="cpu")
    if model.cfg.family == "vlm":
        gen = torch.Generator().manual_seed(6)
        for gate in ("gate_attn", "gate_mlp"):
            params["cross_layers"][gate] = torch.rand(
                params["cross_layers"][gate].shape, generator=gen) + 0.4
    params = unflatten({k: t.to(dev) for k, t in flatten(params).items()})
    return attach_cross_source(Engine(model, params, max_len=96))


CROSS_ARCHS = ["whisper-base", "llama-3.2-vision-11b"]


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_cross_model_on_card_matches_cpu(dev, arch):
    """The reduced encdec and vlm models: a 21-token prefill, a 7-token
    extend and 12 decodes over the cached cross K/V, card logits against
    the CPU's; #2 launches once an encoder layer an encode and once a
    self and a cross layer an extend, #1 once a self and a cross layer a
    decode."""
    eng = _cross_engine(dev, arch)
    m, cfg = eng.model, eng.model.cfg
    n_self, n_cross = cfg.n_self_layers, cfg.n_cross_layers
    src = stub_source(cfg)
    toks = torch.randint(0, 64, (1, 40), generator=torch.Generator()
                         .manual_seed(1))
    out = {}
    for d in ("cuda", "cpu"):
        p = eng.params if d == "cuda" else \
            unflatten({k: t.cpu() for k, t in flatten(eng.params).items()})
        counts = (flash_attention.launches, decode_attention.launches)
        st = m.init_state(1, 64, device=d, n_cross_src=src.shape[1])
        x = src.to(d)
        if cfg.family == "encdec":
            x = m.encode(p, x)
        st = m.prep_cross(p, st, x)
        a, st = m.prefill(p, toks[:, :21].to(d), st)
        b, st = m.prefill(p, toks[:, 21:28].to(d), st)
        rows = [a[0], b[0]]
        for t in range(28, 40):
            c, st = m.decode_step(p, st, toks[:, t:t + 1].to(d))
            rows.append(c)
        out[d] = (torch.cat(rows).cpu(), st.cross_k.cpu())
        if d == "cuda":
            torch.cuda.synchronize()
            assert (flash_attention.launches - counts[0],
                    decode_attention.launches - counts[1]) == \
                (cfg.n_encoder_layers + 2 * (n_self + n_cross),
                 12 * (n_self + n_cross))
    torch.testing.assert_close(out["cuda"], out["cpu"], atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


@pytest.mark.parametrize("arch", CROSS_ARCHS)
@pytest.mark.parametrize("temperature", [0.0, 0.6])
def test_cross_fused_graphs_match_eager_on_card(dev, arch, temperature):
    """The reduced encdec and vlm engines: the replayed graphs give the
    per-token loop's tokens and logits, leave the cross K/V as they
    were, and a second request captures nothing (its KV and cross pair
    come from the pool)."""
    eng = _cross_engine(dev, arch)
    assert eng.fused
    eo, es, enext = _two_calls(eng, False, temperature)
    want = (es.pos, es.last_logits, es.state.cross_k.clone())
    del es          # frees its pooled pairs for the fused calls
    fo, fs, fnext = _two_calls(eng, True, temperature)
    assert [i for i, _ in fo] == [i for i, _ in eo]
    assert fs.pos == want[0]
    torch.testing.assert_close(fs.last_logits, want[1], rtol=2e-4,
                               atol=2e-4)
    assert torch.equal(fs.state.cross_k, want[2])
    torch.testing.assert_close(fnext, enext, rtol=0, atol=0)
    caps = eng.captures
    assert caps == len(eng._loops) == 2
    del fs
    _two_calls(eng, True, temperature)
    key = (1, 96, eng.model.cfg.encoder_seq_len
           if eng.model.cfg.family == "encdec"
           else eng.model.cfg.n_image_tokens)
    assert eng.captures == caps and len(eng._kv_pool[key]) == 1


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
# the moe family: the layer, the sequential engine and the coupled rows
# ---------------------------------------------------------------------------

def _moe_pair(dev, seed=5):
    """The reduced granite (2 layers, 4 experts, top-2, vocabulary 64):
    (model, CPU params, the same params on the card)."""
    m = Model(arch_config("granite-moe-1b-a400m", reduced=True))
    params = m.init(seed, device="cpu")
    return m, params, params_from_numpy(params_to_numpy(params), dev)


def test_moe_layer_on_card_matches_cpu(dev):
    """``apply_moe`` on the card against the CPU: the same routing (the
    experts and keep mask the reference's rules give), y and the aux
    terms within LOGIT_TOL, at the default capacity and at 0.25."""
    from repro_torch.models import moe
    m, params, card = _moe_pair(dev)
    x = torch.randn(3, 40, m.cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    for cf in (1.25, 0.25):
        cfg = dataclasses.replace(m.cfg, capacity_factor=cf)
        lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
        lc = {k: v[0] for k, v in card["layers"]["moe"].items()}
        y, aux = moe.apply_moe(x, lp, cfg)
        yc, auxc = moe.apply_moe(x.to(dev), lc, cfg)
        logits = x.reshape(1, 120, -1) @ lp["router"]
        cap = moe.group_capacity(120, cfg)
        want = moe.route(logits, cfg, cap)
        got = moe.route(logits.to(dev), cfg, cap)
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a.cpu(), b)
        torch.testing.assert_close(yc.cpu(), y, atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
        for k in aux:
            torch.testing.assert_close(auxc[k].cpu(), aux[k],
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL)
        if cf < 1:
            assert aux["dropped_frac"] > 0


@pytest.mark.parametrize("temperature", [0.0, 0.6])
def test_moe_engine_fused_matches_eager_on_card(dev, temperature):
    """The reduced granite's sequential engine on the card: the moe step
    inside the fused loop's CUDA graphs gives the per-token loop's
    tokens; #1 and #2 launch n_layers x the metered steps and extends;
    greedy tokens equal the CPU engine's."""
    m, params, card = _moe_pair(dev)
    eng = Engine(m, card, max_len=128)
    out = {}
    for fused in (False, True):
        decode_attention.launches = flash_attention.launches = 0
        eng.meter.reset()
        s = eng.extend(eng.new_session(), list(range(10, 31)))
        ids, s, _ = eng.generate(s, 24, [], SamplingParams(temperature),
                                 torch.Generator(device=dev).manual_seed(3),
                                 fused=fused)
        n = m.cfg.n_layers
        assert decode_attention.launches == n * eng.meter.decode_steps
        assert flash_attention.launches == n * eng.meter.prefill_calls
        out[fused] = ids
    assert out[True] == out[False] and len(out[True]) == 24
    if temperature == 0.0:
        cpu = Engine(m, params, max_len=128)
        s = cpu.extend(cpu.new_session(), list(range(10, 31)))
        ids, _, _ = cpu.generate(s, 24, [], SamplingParams(),
                                 torch.Generator())
        assert ids == out[True]


def test_moe_rows_on_card_match_cpu_and_fused_matches_eager(dev):
    """The coupled moe rows on the card (every slot a call, masked slots
    reading their own context through the shadow pages): 3 rows of 4
    extend, decode fused and per-token from the same start (equal tokens
    and last logits), then a feed; greedy tokens and logits against the
    CPU engine's (LOGIT_TOL); #3 and #4 launch
    n_layers x the metered steps and extends."""
    m, params, card = _moe_pair(dev)
    prompts = [list(range(10, 21)), list(range(30, 35)),
               list(range(40, 49))]
    res = {}
    for d, p in (("cpu", params), ("cuda", card)):
        for fused in ((False,) if d == "cpu" else (False, True)):
            be = BatchEngine(m, p, batch=4, capacity=128, fused=fused)
            rows = [be.alloc_row() for _ in prompts]
            paged_decode_attention.launches = 0
            paged_append_attention.launches = 0
            be.extend_rows(rows, prompts)
            first = be.last_logits[:3].cpu().clone()
            ids = be.generate_rows(rows[::2], [9, 6], [], SamplingParams(),
                                   [torch.Generator(device=d)
                                    for _ in range(2)])
            be.feed_rows([rows[1]], [7])
            if d == "cuda":
                n = m.cfg.n_layers
                assert paged_decode_attention.launches == \
                    n * be.meter.decode_steps
                assert paged_append_attention.launches == \
                    n * be.meter.prefill_calls
            res[d, fused] = (ids, first, be.last_logits[:3].cpu().clone())
    assert res["cuda", True][0] == res["cuda", False][0] == \
        res["cpu", False][0]
    torch.testing.assert_close(res["cuda", True][2], res["cuda", False][2],
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for i in (1, 2):
        torch.testing.assert_close(res["cuda", False][i],
                                   res["cpu", False][i], atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)


# ---------------------------------------------------------------------------
# the fused decode loop on an ssm model: CUDA graphs over the engine's
# static conv/ssm pair
# ---------------------------------------------------------------------------

def _ssm_engine(dev, seed=2):
    m = Model(arch_config("mamba2-1.3b", reduced=True))
    return Engine(m, m.init(seed, device=dev), max_len=256)


@pytest.mark.parametrize("temperature", [0.0, 0.6])
def test_ssm_fused_graphs_match_eager_on_card(dev, temperature):
    """The reduced mamba2: the replayed graphs give the per-token loop's
    tokens, probabilities, logits, conv/ssm state and position, and leave
    the generator where it does; the SSD scan launches only in extends."""
    eng = _ssm_engine(dev)
    assert eng.fused
    eo, es, enext = _two_calls(eng, False, temperature)
    eng.meter.reset()
    ssd_scan.launches = 0
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
    torch.testing.assert_close((fs.state.conv, fs.state.ssm),
                               (es.state.conv, es.state.ssm), rtol=2e-4,
                               atol=2e-4)
    torch.testing.assert_close(fnext, enext, rtol=0, atol=0)
    m = eng.meter
    assert m.decode_calls == 2 and eng.captures == 2
    assert ssd_scan.launches == eng.model.cfg.n_layers * m.prefill_calls
    assert m.decode_syncs <= (-(-37 // 8) + 1) + (-(-11 // 8) + 1)


def test_ssm_fused_second_request_does_not_capture_on_card(dev):
    """Each ssm request allocates new state, but the graphs run over the
    engine's static pair: a second request replays the first's graphs."""
    eng = _ssm_engine(dev)
    sp = SamplingParams()
    got = []
    for _ in range(2):
        s = eng.extend(eng.new_session(), list(range(10, 31)))
        ids, s, _ = eng.generate(s, 19, [], sp,
                                 torch.Generator(device="cuda"))
        got.append((ids, eng.captures, len(eng._loops)))
    assert got[0] == got[1] and got[0][1] == got[0][2] == 1


def test_ssm_masked_step_leaves_state_bitwise_on_card(dev):
    """A masked step (``decode_step`` with ``active`` false) keeps every
    bit of the conv and ssm state on the card; and a fused call of 3
    tokens, one chunk of 4 steps whose last is masked, ends on the
    per-token loop's state bit for bit."""
    eng = _ssm_engine(dev)
    m, p = eng.model, eng.params
    s = eng.extend(eng.new_session(), list(range(10, 31)))
    st = dataclasses.replace(s.state, conv=s.state.conv.clone(),
                             ssm=s.state.ssm.clone(),
                             pos=torch.tensor(s.pos, device="cuda"))
    _, got = m.decode_step(p, st, torch.tensor([[17]], device="cuda"),
                           active=torch.tensor(False, device="cuda"))
    assert torch.equal(got.conv, s.state.conv) and \
        torch.equal(got.ssm, s.state.ssm) and int(got.pos) == s.pos
    sp = SamplingParams()
    eng.meter.reset()
    fids, fs, _ = eng.generate(s, 3, [], sp, torch.Generator(device="cuda"),
                               fused=True)
    assert eng.meter.decode_steps == 4 + eng.captures     # + the warm-up
    eids, es, _ = eng.generate(s, 3, [], sp, torch.Generator(device="cuda"),
                               fused=False)
    assert fids == eids
    assert torch.equal(fs.state.conv, es.state.conv) and \
        torch.equal(fs.state.ssm, es.state.ssm)


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


def test_rows_finite_and_annotated_replays_on_card(dev):
    """The health scan's ``rows_finite`` on the card's logits after fused
    rows calls: a row poisoned in place (as the ``nan_logits`` fault
    writes it, into the tensor the graphs read) reads False, the others
    True; an annotating tracer wraps each
    call in ``record_function("<engine>.<op>")``, which a profiler trace
    shows around the graph replays, one range a call, and the launch
    counts equal an untraced engine's."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.telemetry import Tracer
    plain = _rows_engine(dev)
    traced = _rows_engine(dev, plain.params)
    traced.tracer = Tracer(annotate=True)
    traced.name = "probe"
    counts = []
    for be, prof in ((plain, False), (traced, True)):
        paged_decode_attention.launches = 0
        paged_append_attention.launches = 0
        rows = [be.alloc_row() for _ in range(3)]
        be.extend_rows(rows, [list(range(10, 31)), [5, 6, 7], [9, 8]])
        sp = SamplingParams(0.0)
        be.generate_rows(rows, [20, 9, 14], [], sp,
                         [torch.Generator(device="cuda") for _ in rows])
        if prof:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as p:
                out = be.generate_rows(
                    rows, [16, 16, 16], [], sp,
                    [torch.Generator(device="cuda") for _ in rows])
                torch.cuda.synchronize()
        else:
            out = be.generate_rows(
                rows, [16, 16, 16], [], sp,
                [torch.Generator(device="cuda") for _ in rows])
        torch.cuda.synchronize()
        counts.append((paged_decode_attention.launches,
                       paged_append_attention.launches, out,
                       be.meter.decode_steps, be.captures))
        assert be.rows_finite(rows) == [True, True, True]
        be.last_logits[rows[1]] = float("nan")
        assert be.rows_finite(rows) == [True, False, True]
        assert be.finite_mask([rows[2], rows[1]]).device.type == "cuda"
    assert counts[0] == counts[1]
    assert counts[0][0] == plain.model.cfg.n_layers * \
        plain.meter.decode_steps > 0
    # one host range, and its annotation on the card's timeline around
    # the replays' kernels
    ranges = [e for e in p.events() if e.name == "probe.decode"]
    assert sum(e.device_type == torch.autograd.DeviceType.CPU
               for e in ranges) == 1
    assert sum(e.device_type == torch.autograd.DeviceType.CUDA
               for e in ranges) == 1
    spans = [e for e in traced.tracer.entries()
             if e[1] == "engine:probe" and e[2] == "decode"]
    assert len(spans) == 2                     # one a call, not a step


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


# ---------------------------------------------------------------------------
# training: the attention backward kernel and gradients on the card
# ---------------------------------------------------------------------------

def _bwd_tol(s):
    return 2e-5 if s <= 128 else 1e-4


def _close_to_max(got, want, tol, what=""):
    torch.testing.assert_close(got, want, rtol=tol,
                               atol=tol * want.abs().max().item(),
                               msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("b,h,kh,s,hd", [
    (16, 8, 4, 112, 28),     # BASE's training shape
    (16, 4, 2, 96, 32),      # SMALL's
    (2, 24, 8, 256, 128),    # minitron-4b's heads
    (3, 6, 6, 77, 64),       # G = 1, a ragged last tile
    (1, 16, 1, 40, 16),      # G = 16
    (2, 2, 2, 3, 8),         # a few positions (row 0's dq is exactly 0)
    (1, 24, 8, 1024, 128),   # minitron-4b's heads at S=1024: 16 dkv blocks
    (1, 24, 8, 4096, 128),   # at minitron-4b's context: the longest sums
    (2, 16, 1, 77, 64),      # G = 16, a ragged last tile of 64 and of 32
    (3, 4, 2, 50, 28),       # hd 28 padded to 32, S not a whole tile
    (2, 4, 2, 33, 15),       # hd 15: element copies, not cp.async
])
def test_flash_bwd_kernel_matches_plain(dev, b, h, kh, s, hd):
    gen = torch.Generator(device=dev).manual_seed(s)
    # the training forward's layout: (B, S, heads, hd) permuted
    q = _randn(gen, b, s, h, hd).permute(0, 2, 1, 3)
    k = _randn(gen, b, s, kh, hd).permute(0, 2, 1, 3)
    v = _randn(gen, b, s, kh, hd).permute(0, 2, 1, 3)
    do = _randn(gen, b, h, s, hd)
    o = flash_attention(q, k, v)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, do)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = ref.mha_backward_reference(q, k, v, do)
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.shape == x.shape and g.stride() == x.stride()
        _close_to_max(g, w, _bwd_tol(s), name)
    again = flash_attention_bwd(q, k, v, o, do)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("hd", [15, 28, 32, 64, 100, 128])
def test_flash_bwd_launch_takes_only_its_plan(dev, hd):
    """The C entry launches ``tile_plan.bwd_launch``'s plan (the wrapper's
    bits) at each head_dim bucket, and refuses with cudaErrorInvalidValue,
    launching nothing, a plan one step off it anywhere; two blocks of the
    plan fit in an H100 SM's 228 KB (1 KB of it reserved a block)."""
    import ctypes
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import tile_plan
    b, h, kh, s = 1, 4, 2, 100
    gen = torch.Generator(device=dev).manual_seed(hd)
    q, do = _randn(gen, b, h, s, hd), _randn(gen, b, h, s, hd)
    k, v = _randn(gen, b, kh, s, hd), _randn(gen, b, kh, s, hd)
    o = flash_attention(q, k, v)

    def launch(plan):
        grads = [torch.zeros_like(t) for t in (q, k, v)]
        lse, dsum, part = fb.scratch(b, h, kh, s, hd, q.device)
        tensors = (q, k, v, o, do, *grads)
        strides = (ctypes.c_longlong * 24)(*(x for t in tensors
                                             for x in t.stride()[:3]))
        rc = fb._lib().flash_attention_bwd_launch(
            *(t.data_ptr() for t in tensors), lse.data_ptr(),
            dsum.data_ptr(), part.data_ptr(), b, h, kh, s, hd, strides,
            (ctypes.c_int * 6)(*plan),
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        return rc, grads

    plan = tile_plan.bwd_launch(b, h, kh, s, hd)
    rc, grads = launch(plan)
    assert rc == 0
    want = flash_attention_bwd(q, k, v, o, do)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))
    for i, step in ((0, -1), (0, 1), (1, 32), (2, -4), (3, 4), (4, -plan[4]),
                    (5, -32)):
        off = list(plan)
        off[i] += step
        rc, grads = launch(off)
        assert rc == 1, (i, step)
        assert not any(g.any() for g in grads)
    assert 2 * (max(plan[2], plan[3]) + 1024) <= 228 * 1024


def test_attention_grad_on_card_runs_the_kernels(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    leaves = [_randn(gen, 2, n, 40, 32).requires_grad_() for n in (4, 2, 2)]
    do = _randn(gen, 2, 4, 40, 32)
    fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
    o = ops.flash_attention(*leaves)
    grads = torch.autograd.grad(o, leaves, do)
    assert (flash_attention.launches, flash_attention_bwd.launches) == \
        (fwd + 1, bwd + 1)
    want = ref.mha_backward_reference(*(t.detach() for t in leaves), do)
    for g, w in zip(grads, want):
        _close_to_max(g, w, _bwd_tol(40))
    # without autograd: #2's launch alone, no history
    with torch.no_grad():
        assert ops.flash_attention(*leaves).grad_fn is None
    assert ops.flash_attention(*(t.detach() for t in leaves)).grad_fn is None
    assert flash_attention_bwd.launches == bwd + 1
    # outside the backward's contract under autograd: refused, not dropped
    with pytest.raises(ValueError, match="training forward"):
        ops.flash_attention(*leaves, window=8)
    lens = torch.full((2,), 40, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.decode_attention(leaves[0][:, :, 0], leaves[1], leaves[2], lens)


def _loss_and_grads(m, params, batch, d):
    p = {k: t.to(d, copy=True).requires_grad_()
         for k, t in flatten(params).items()}
    loss, _ = tloss.loss_fn(m, unflatten(p),
                            {k: torch.from_numpy(x).to(d)
                             for k, x in batch.items()})
    return loss.detach().cpu(), dict(zip(p, (
        g.cpu() for g in torch.autograd.grad(loss, list(p.values())))))


@pytest.mark.parametrize("remat", [True, False])
def test_training_grads_on_card_match_cpu(dev, remat):
    m = Model(dataclasses.replace(testbed.BASE, remat=remat))
    params = m.init(3, device="cpu")
    inp, tgt, wgt = next(pipeline.batch_iterator(
        pipeline.BatchSpec(4, 112), 0, "mixed"))
    batch = {"tokens": inp, "targets": tgt, "weights": wgt}
    fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
    card = _loss_and_grads(m, params, batch, dev)
    n = m.cfg.n_layers
    assert flash_attention_bwd.launches - bwd == n
    assert flash_attention.launches - fwd == n * (2 if remat else 1)
    cpu = _loss_and_grads(m, params, batch, "cpu")
    _close_to_max(card[0], cpu[0], 1e-4, "loss")
    for k, g in cpu[1].items():
        _close_to_max(card[1][k], g, 1e-4, k)


def test_train_on_card_is_deterministic(dev):
    tcfg = TrainConfig(steps=6, batch_size=16, seq_len=96, kind="cot",
                       style_mix=(0.0, 0.0), log_every=1)
    runs = [train(testbed.SMALL, tcfg, log=lambda s: None, device=dev)
            for _ in range(2)]
    assert [h["loss"] for h in runs[0]["history"]] == \
        [h["loss"] for h in runs[1]["history"]]
    for k, t in flatten(runs[0]["params"]).items():
        assert t.is_cuda and not t.requires_grad
        assert torch.equal(t, flatten(runs[1]["params"])[k]), k


def test_tp_two_ranks_share_the_card(dev):
    """Exact tensor parallelism on one card: two rank processes over gloo
    (``serving.tp.run_ranks``, ``tests/torch_tp_ranks.card``), each
    launching #3 and #4 through ``paged_tp`` over its half of testbed
    BASE's heads.  The ranks' logits are bit for bit the same, within
    LOGIT_TOL of tp=1 in this process (cuBLAS picks its variant from N,
    so half the heads may change a reduction order); each rank's
    ``paged_tp`` outputs on the card, gathered, against the plain
    version; every paged launch went through ``paged_tp``."""
    import numpy as np
    import torch_tp_ranks
    from repro_torch.serving.tp import run_ranks
    ranks = run_ranks(2, "cuda", torch_tp_ranks.card, (), timeout_s=600)
    one = torch_tp_ranks.card(None)
    layers = one["layers"]
    assert one["launches"] == [layers, layers, 0, 0]
    plain = torch_tp_ranks.plain_kernels(torch_tp_ranks.kernel_case())
    span = torch_tp_ranks.kernel_case()["span"]
    for r in ranks:
        assert r["backend"] == "gloo" or torch.cuda.device_count() >= 2
        assert r["launches"] == [layers] * 4
        for kind in ("extend", "decode"):
            assert np.array_equal(r[kind], ranks[0][kind])
            np.testing.assert_allclose(r[kind], one[kind], atol=LOGIT_TOL,
                                       rtol=LOGIT_TOL)
        np.testing.assert_allclose(r["kernels"]["decode"], plain["decode"],
                                   atol=TOL[torch.float32],
                                   rtol=TOL[torch.float32])
        for i, n in enumerate(span):
            np.testing.assert_allclose(r["kernels"]["append"][i, :n],
                                       plain["append"][i, :n],
                                       atol=TOL[torch.float32],
                                       rtol=TOL[torch.float32])
