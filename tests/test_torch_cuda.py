"""The port's CUDA kernels on the card: each against its plain version,
the wrappers' refusals, and the model and engine on CUDA against the CPU.

Needs an NVIDIA GPU and nvcc (the kernels build on first use); every test
skips where CUDA is absent.  Imports no JAX, so it runs on a machine
without it:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: kernels fp32 atol = rtol = 2e-5, bf16 2e-2 (as
tests/test_kernels.py); model logits card vs CPU atol = rtol = 1e-4
(fp32 GEMMs on both sides with TF32 off, summed in different orders).
"""

import dataclasses

import pytest
import torch

from repro_torch.checkpoint.checkpoint import params_from_numpy, \
    params_to_numpy
from repro_torch.configs import testbed
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.model import Model
from repro_torch.sampling.sample import SamplingParams
from repro_torch.serving.engine import Engine

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
    with pytest.raises(ValueError, match="H / K"):
        decode_attention(torch.zeros(1, 18, 32, device=dev),
                         k, k, lens)
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention(q[:, :, None], k, k, kv_len=65)
    assert (decode_attention.launches, flash_attention.launches) == before


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
            assert decode_attention.launches == n * e.meter.decode_calls
            assert flash_attention.launches == n * e.meter.prefill_calls
        else:
            assert decode_attention.launches == flash_attention.launches == 0
    assert tokens["cuda"] == tokens["cpu"]


def test_sliding_window_decode_on_card_raises(dev):
    cfg = dataclasses.replace(testbed.MICRO, sliding_window=8)
    m = Model(cfg)
    p = m.init(0, device=dev)
    st = m.init_state(1, 16, device=dev)
    with pytest.raises(NotImplementedError, match="CUDA kernel"):
        m.decode_step(p, st, torch.zeros(1, 1, dtype=torch.long,
                                         device=dev))
