"""The port's plain attention versions against the JAX package: its jnp
oracles (``repro.kernels.ref``), its Pallas kernels in interpret mode, and
the masks of its ``prefill_self_attention`` / ``decode_self_attention``.
Also: CPU calls never count a kernel launch, the CUDA wrappers refuse CPU
tensors, and CUDA entry points raise where CUDA is absent.

Inputs are made with numpy from fixed seeds.  Tolerances follow
tests/test_kernels.py: fp32 atol = rtol = 2e-5 (the two sides sum in
different orders); bf16 atol = rtol = 2e-2 (one bf16 ulp at |x| ~ 2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import testbed as jtestbed
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import attention as jattn
from repro_torch import device as devices
from repro_torch.configs import testbed
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.decode_attention import decode_attention as \
    decode_kernel
from repro_torch.kernels.flash_attention import flash_attention as \
    flash_kernel
from repro_torch.models import attention as tattn

FP32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(x, dtype):
    """numpy fp32 -> (jax array, torch tensor) of the same values."""
    if dtype == "bf16":
        j = jnp.asarray(x, jnp.bfloat16)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
            torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,kh,s,hd", [
    (1, 8, 4, 96, 28),     # BASE heads
    (3, 4, 2, 64, 32),     # SMALL heads, ragged batch
    (2, 2, 2, 48, 16),     # MICRO_SMALL heads: G = 1
])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_decode_reference_matches_jax(b, h, kh, s, hd, dtype):
    rng = np.random.default_rng(b * 100 + hd)
    qj, qt = _both(_rand(rng, (b, h, hd)), dtype)
    kj, kt = _both(_rand(rng, (b, kh, s, hd)), dtype)
    vj, vt = _both(_rand(rng, (b, kh, s, hd)), dtype)
    lens = rng.integers(1, s + 1, size=b).astype(np.int32)
    lens[0] = s
    exp = jref.decode_reference(qj, kj, vj, jnp.asarray(lens))
    out = ref.decode_reference(qt, kt, vt, torch.from_numpy(lens))
    assert out.dtype == qt.dtype
    np.testing.assert_allclose(_np(out), _np(exp),
                               **(BF16 if dtype == "bf16" else FP32))


@pytest.mark.parametrize("hd", [16, 28, 32])
def test_decode_reference_matches_pallas_interpret(hd):
    b, h, kh, s = 2, 4, 2, 256
    rng = np.random.default_rng(hd)
    q, k, v = (_rand(rng, (b, h, hd)), _rand(rng, (b, kh, s, hd)),
               _rand(rng, (b, kh, s, hd)))
    lens = np.array([37, 256], np.int32)
    exp = pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(lens), interpret=True)
    out = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(lens))
    np.testing.assert_allclose(_np(out), _np(exp), **FP32)


# ---------------------------------------------------------------------------
# prefill / full-sequence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,kh,s,hd,causal", [
    (1, 8, 4, 64, 28, True),
    (2, 4, 2, 32, 32, True),
    (1, 2, 2, 48, 16, True),
    (1, 4, 2, 32, 32, False),
])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mha_reference_matches_jax(b, h, kh, s, hd, causal, dtype):
    rng = np.random.default_rng(s + hd)
    qj, qt = _both(_rand(rng, (b, h, s, hd)), dtype)
    kj, kt = _both(_rand(rng, (b, kh, s, hd)), dtype)
    vj, vt = _both(_rand(rng, (b, kh, s, hd)), dtype)
    exp = jref.mha_reference(qj, kj, vj, causal=causal)
    out = ref.mha_reference(qt, kt, vt, causal=causal)
    np.testing.assert_allclose(_np(out), _np(exp),
                               **(BF16 if dtype == "bf16" else FP32))


@pytest.mark.parametrize("hd,causal", [(28, True), (32, True), (16, False)])
def test_mha_reference_matches_pallas_interpret(hd, causal):
    b, h, kh, s = 1, 4, 2, 64
    rng = np.random.default_rng(7 + hd)
    q, k, v = (_rand(rng, (b, h, s, hd)), _rand(rng, (b, kh, s, hd)),
               _rand(rng, (b, kh, s, hd)))
    exp = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, interpret=True)
    out = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(_np(out), _np(exp), **FP32)


@pytest.mark.parametrize("s,cap,q_offset,window", [
    (4, 64, 0, 0), (16, 64, 37, 0), (8, 64, 56, 0), (16, 96, 40, 12),
])
def test_mha_reference_offset_and_window_match_jax_masks(s, cap, q_offset,
                                                         window):
    """Queries at q_offset.. over a cache of ``cap`` slots: the masks of
    the JAX prefill (``attention.causal_mask`` inside ``sdpa``)."""
    b, h, kh, hd = 1, 8, 4, 28
    rng = np.random.default_rng(s * 1000 + q_offset)
    q = _rand(rng, (b, s, h, hd))
    k, v = _rand(rng, (b, cap, kh, hd)), _rand(rng, (b, cap, kh, hd))
    g = h // kh
    exp = jattn.sdpa(jnp.asarray(q), jattn._repeat_kv(jnp.asarray(k), g),
                     jattn._repeat_kv(jnp.asarray(v), g),
                     jattn.causal_mask(s, cap, window=window,
                                       q_offset=q_offset))
    t = lambda x: torch.from_numpy(x).permute(0, 2, 1, 3)  # noqa: E731
    out = ref.mha_reference(t(q), t(k), t(v), causal=True,
                            q_offset=q_offset, kv_len=cap, window=window)
    np.testing.assert_allclose(_np(out.permute(0, 2, 1, 3)), _np(exp),
                               **FP32)


@pytest.mark.parametrize("kv_len,window", [(40, 0), (70, 16)])
def test_mha_reference_kv_len_matches_jax_blockwise(kv_len, window):
    """kv_len masks keys like the JAX blockwise twin's kv_valid_upto."""
    b, h, kh, s, cap, hd, off = 1, 4, 2, 16, 96, 32, 30
    rng = np.random.default_rng(kv_len)
    q = _rand(rng, (b, s, h, hd))
    k, v = _rand(rng, (b, cap, kh, hd)), _rand(rng, (b, cap, kh, hd))
    exp = jattn.blockwise_sdpa(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.int32(off), causal=True,
                               window=window, kv_valid_upto=kv_len,
                               block_q=8, block_k=32)
    t = lambda x: torch.from_numpy(x).permute(0, 2, 1, 3)  # noqa: E731
    out = ref.mha_reference(t(q), t(k), t(v), causal=True, q_offset=off,
                            kv_len=kv_len, window=window)
    np.testing.assert_allclose(_np(out.permute(0, 2, 1, 3)), _np(exp),
                               **FP32)


# ---------------------------------------------------------------------------
# the attention layers that call them
# ---------------------------------------------------------------------------

def _layer_params(cfg, rng):
    d, h, k, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                   cfg.resolved_head_dim)
    shapes = {"wq": (d, h, hd), "wk": (d, k, hd), "wv": (d, k, hd),
              "wo": (h, hd, d)}
    p = {n: _rand(rng, s) * 0.2 for n, s in shapes.items()}
    return ({n: jnp.asarray(a) for n, a in p.items()},
            {n: torch.from_numpy(a) for n, a in p.items()})


@pytest.mark.parametrize("start,s,window", [(0, 8, 0), (21, 16, 0),
                                            (40, 8, 6)])
def test_prefill_self_attention_matches_jax(start, s, window):
    cfg = jtestbed.BASE
    rng = np.random.default_rng(start + s)
    pj, pt = _layer_params(cfg, rng)
    cap = 64
    x = _rand(rng, (1, s, cfg.d_model))
    kc = _rand(rng, (1, cap, cfg.n_kv_heads, cfg.resolved_head_dim))
    vc = _rand(rng, (1, cap, cfg.n_kv_heads, cfg.resolved_head_dim))
    oj, kj, vj = jattn.prefill_self_attention(
        jnp.asarray(x), pj, cfg, jnp.asarray(kc), jnp.asarray(vc),
        jnp.int32(start), window=window)
    kt, vt = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    ot = tattn.prefill_self_attention(torch.from_numpy(x), pt,
                                      testbed.BASE, kt, vt, start, window)
    np.testing.assert_allclose(_np(ot), _np(oj), **FP32)
    np.testing.assert_allclose(_np(kt), _np(kj), **FP32)
    np.testing.assert_allclose(_np(vt), _np(vj), **FP32)


@pytest.mark.parametrize("pos,ring,window", [(0, False, 0), (29, False, 0),
                                             (45, True, 0), (30, False, 8)])
def test_decode_self_attention_matches_jax(pos, ring, window):
    import dataclasses
    cfg = dataclasses.replace(jtestbed.SMALL, sliding_window=window)
    tcfg = dataclasses.replace(testbed.SMALL, sliding_window=window)
    rng = np.random.default_rng(pos + 3)
    pj, pt = _layer_params(cfg, rng)
    cap = 32
    x = _rand(rng, (1, 1, cfg.d_model))
    kc = _rand(rng, (1, cap, cfg.n_kv_heads, cfg.resolved_head_dim))
    vc = _rand(rng, (1, cap, cfg.n_kv_heads, cfg.resolved_head_dim))
    oj, kj, vj = jattn.decode_self_attention(
        jnp.asarray(x), pj, cfg, jnp.asarray(kc), jnp.asarray(vc),
        jnp.int32(pos), ring=ring)
    kt, vt = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    lengths = torch.tensor([min(pos + 1, cap)], dtype=torch.int32)
    ot = tattn.decode_self_attention(torch.from_numpy(x), pt, tcfg, kt, vt,
                                     pos, lengths, ring=ring)
    np.testing.assert_allclose(_np(ot), _np(oj), **FP32)
    np.testing.assert_allclose(_np(kt), _np(kj), **FP32)


# ---------------------------------------------------------------------------
# dispatch: no launches on the CPU, no fallback on CUDA
# ---------------------------------------------------------------------------

def test_cpu_calls_count_no_launches():
    before = (decode_kernel.launches, flash_kernel.launches)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(_rand(rng, (1, 4, 8, 16)))
    k = torch.from_numpy(_rand(rng, (1, 2, 8, 16)))
    ops.flash_attention(q, k, k)
    ops.decode_attention(q[:, :, 0], k, k,
                         torch.tensor([5], dtype=torch.int32))
    assert (decode_kernel.launches, flash_kernel.launches) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    before = (decode_kernel.launches, flash_kernel.launches)
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA kernel"):
        flash_kernel(q, k, k)
    with pytest.raises(ValueError, match="CUDA kernel"):
        decode_kernel(q[:, :, 0], k, k, torch.ones(1, dtype=torch.int32))
    assert (decode_kernel.launches, flash_kernel.launches) == before


def test_cuda_device_raises_when_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        devices.resolve("cuda")
    assert devices.resolve("cpu").type == "cpu"


def test_build_names_libraries_by_source_hash(monkeypatch):
    a = build.library_path("decode_attention")
    b = build.library_path("flash_attention")
    assert a.parent == b.parent == build.BUILD_DIR
    assert a.name.startswith("libdecode_attention-") and a.suffix == ".so"
    assert a != b
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()
