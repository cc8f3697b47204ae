"""The port's plain attention versions against the JAX package: its jnp
oracles (``repro.kernels.ref``), its Pallas kernels in interpret mode, and
the masks of its ``prefill_self_attention`` / ``decode_self_attention``.
Also: CPU calls never count a kernel launch, the CUDA wrappers refuse CPU
tensors, and CUDA entry points raise where CUDA is absent; the precision
plan of the tensor-core products of paged span attention, causal
prefill and the SSD scan (3xTF32 against one TF32 product, emulated in
numpy), and their splits over keys; the flash-decode kernels' split over
keys and their choice of copy width (the Python mirror of the C rule);
the SSD scan's launches and scratch (the Python mirror of its plan).

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
    (2, 18, 2, 40, 96),    # G = 9 (starcoder2-7b's), hd 96
    (1, 9, 1, 33, 128),    # G = 9, hd 128
    (2, 16, 1, 48, 96),    # G = 16 (qwen3-moe's), hd 96
    (2, 32, 2, 40, 128),   # G = 16, hd 128
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


# ---------------------------------------------------------------------------
# paged span attention (#4) and causal prefill (#2): the precision plan of
# their tensor-core products; #4's split of the committed context
# ---------------------------------------------------------------------------

def _tf32(x):
    """Round fp32 to TF32 as ``cvt.rna.tf32.f32`` does: add half an ulp of
    the 10-bit mantissa to the bits, then clear the low 13."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _one_tf32(a, b):
    """One TF32 product per dot, summed exactly and stored as fp32."""
    return (_tf32(a).astype(np.float64)
            @ _tf32(b).astype(np.float64)).astype(np.float32)


def _three_tf32(a, b):
    """3xTF32: hi = tf32(x), lo = tf32(x - hi); lo.hi' + hi.lo' + hi.hi'."""
    def split(x):
        hi = _tf32(x)
        return hi.astype(np.float64), _tf32(x - hi).astype(np.float64)
    ah, al = split(a)
    bh, bl = split(b)
    return (al @ bh + ah @ bl + ah @ bh).astype(np.float32)


@pytest.mark.parametrize("seed,t,n_keys,causal", [
    (0, 64, 4096, False),     # paged span attention (#4): a 64-query chunk
    (1, 64, 4096, False),
    (0, 2048, 2048, True),    # causal prefill (#2) of a 2048-token prompt
], ids=["0", "1", "causal-2048"])
def test_span_attention_needs_the_3xtf32_split_for_fp32(seed, t, n_keys,
                                                        causal):
    """At hd 128, T=64 queries over 4096 keys or a causal prefill of 2048
    queries over themselves, softmax(Q.K^T / sqrt(hd)).V with both
    products as 3xTF32 stays within the fp32 tolerance of float64 (atol =
    rtol = 2e-5); with one TF32 product it does not (at seed 0, T=64, the
    max |err| is 4.8e-5)."""
    rng = np.random.default_rng(seed)
    q, k, v = (_rand(rng, s) for s in ((t, 128), (n_keys, 128),
                                       (n_keys, 128)))
    seen = np.tri(t, n_keys, dtype=bool) if causal else \
        np.ones((t, n_keys), bool)
    s = q.astype(np.float64) @ k.T.astype(np.float64) / np.sqrt(128)
    s = np.where(seen, s, -np.inf)
    p = np.exp(s - s.max(1, keepdims=True))
    exp = (p @ v.astype(np.float64)) / p.sum(1, keepdims=True)

    def attend(prod):
        s = np.where(seen, prod(q, k.T) * np.float32(1 / np.sqrt(128)),
                     -np.inf)
        p = np.exp(s - s.max(1, keepdims=True)).astype(np.float32)
        return prod(p, v) / p.sum(1, keepdims=True, dtype=np.float32)

    np.testing.assert_allclose(attend(_three_tf32), exp, **FP32)
    one = attend(_one_tf32)
    assert not np.allclose(one, exp, **FP32)
    assert np.abs(one - exp).max() > 2 * FP32["atol"]


@pytest.mark.parametrize("b,t,h,kh,ctx_slots,slots,want", [
    (8, 5, 24, 8, 4112, 396, 12),    # minitron-4b verification: 64 blocks
    (8, 64, 24, 8, 4160, 264, 4),    # minitron-4b 64-query chunk: 192
    (6, 256, 24, 8, 4352, 264, 1),   # 576 blocks: a wave and more as it is
    (2, 256, 4, 2, 768, 396, 3),     # SMALL heads: split while slots allow
    (1, 5, 8, 4, 64, 396, 1),        # BASE, one page a row: no room
    (4, 16, 32, 2, 1024, 264, 4),    # G = 16 (over the decode kernels' 8)
])
def test_paged_append_split_plan_fills_the_card(b, t, h, kh, ctx_slots,
                                                slots, want):
    from repro_torch.kernels import tile_plan as tp
    n_split, split_keys = tp.split_plan(b, t, h, kh, ctx_slots, slots)
    base = b * kh * -(-t * (h // kh) // tp.ROWS)
    assert n_split == want
    assert split_keys % 32 == 0 and n_split * split_keys >= ctx_slots
    assert (n_split - 1) * split_keys < ctx_slots      # no empty split
    assert base * n_split >= slots or \
        n_split == -(-ctx_slots // tp.SPLIT_KEYS) or n_split == 1


# ---------------------------------------------------------------------------
# causal prefill (#2): the split over the keys a launch sees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,kh,q_offset,kv_len,causal,window,slots,want", [
    (1, 16, 8, 4, 700, 1024, True, 0, 396, 3),       # BASE bucket at 700
    (1, 16, 8, 4, 700, 1024, True, 600, 396, 3),     # keys 96..715 only
    (1, 16, 8, 4, 100, 1024, True, 0, 396, 1),       # 116 keys: no room
    (1, 256, 24, 8, 1792, 2048, True, 0, 264, 5),    # minitron-4b chunk
    (4, 256, 24, 8, 1792, 2048, True, 0, 264, 1),    # 384 blocks: a wave
    (1, 2048, 24, 8, 0, 2048, True, 0, 264, 1),      # whole prompt: 768
    (1, 16, 32, 2, 900, 1024, True, 0, 264, 4),      # G = 16
    (3, 50, 6, 2, 0, 1000, False, 0, 396, 4),        # not causal: kv_len
])
def test_flash_split_plan_fills_the_card(b, s, h, kh, q_offset, kv_len,
                                         causal, window, slots, want):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import tile_plan as tp
    n_split, split_keys, key_lo = fa.split_plan(b, s, h, kh, q_offset,
                                                kv_len, causal, window, slots)
    hi = min(kv_len, q_offset + s) if causal else kv_len
    first = max(0, q_offset - window + 1) if causal and window else 0
    base = b * kh * -(-s * (h // kh) // tp.ROWS)
    assert n_split == want
    assert key_lo % fa.TILE == 0 and first - fa.TILE < key_lo <= first
    if n_split > 1:
        assert split_keys % fa.TILE == 0
        assert key_lo + n_split * split_keys >= hi          # every key seen
        assert key_lo + (n_split - 1) * split_keys < hi     # no empty split
    assert base * n_split >= slots or n_split == 1 or \
        n_split == -(-(hi - key_lo) // tp.SPLIT_KEYS)


# ---------------------------------------------------------------------------
# flash-decode (#1, #3): the split over keys and the copy width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,kh,keys,slots,want", [
    (8, 24, 8, 4096, 264, 8),     # minitron-4b, B=8: 64 blocks -> 512
    (8, 24, 8, 4096, 396, 12),    # the same at 3 blocks an SM
    (1, 24, 8, 4096, 264, 16),    # one row: splits of SPLIT_KEYS
    (1, 8, 4, 1024, 264, 4),      # BASE's 1024-slot cache
    (4, 8, 4, 640, 264, 3),       # BASE, 4 paged rows of 40 pages
    (40, 8, 8, 512, 264, 1),      # 320 blocks fill a wave as they are
    (2, 4, 2, 200, 264, 1),       # under SPLIT_KEYS: nothing to split
    (2, 32, 2, 2000, 264, 8),     # G = 16: one head group a kv head
    (1, 40, 2, 4096, 264, 16),    # G = 20: two head groups a kv head
])
def test_decode_split_plan_fills_the_card(b, h, kh, keys, slots, want):
    """The decode kernels' split (``tile_plan.split_plan`` over blocks of
    GROUP query heads, one query a row): it fills at least one wave of
    the ``slots`` blocks the card runs at once unless the keys run out of
    splits, never makes more splits than ceil(keys / SPLIT_KEYS), and no
    split starts at or past the capacity."""
    from repro_torch.kernels import tile_plan as tp
    n_split, split_keys = tp.split_plan(b, 1, h, kh, keys, slots,
                                        rows=tp.GROUP)
    base = b * kh * -(-(h // kh) // tp.GROUP)
    assert n_split == want
    assert split_keys % 32 == 0 and n_split * split_keys >= keys
    assert (n_split - 1) * split_keys < keys          # no split past it
    n_max = max(1, -(-keys // tp.SPLIT_KEYS))
    assert n_split <= n_max
    assert base * n_split >= slots or n_split == n_max


_MB = 1 << 20


@pytest.mark.parametrize("esize,hd,ptrs,strides,want", [
    # (B, K, S, hd) views of a (B, S, K, hd) cache: strides (b, head, slot)
    (4, 128, (0, 8 * _MB), (4096 * 8 * 128, 128, 8 * 128), 16),
    (2, 128, (0, 8 * _MB), (4096 * 8 * 128, 128, 8 * 128), 16),
    (4, 28, (0, _MB), (1024 * 4 * 28, 28, 4 * 28), 16),   # 112-byte rows
    (2, 28, (0, _MB), (1024 * 4 * 28, 28, 4 * 28), 4),    # 56-byte rows
    # a (P, K, bs, hd) pool's layer: strides (page, head, slot)
    (2, 28, (3 * 64 * 4 * 16 * 28, _MB), (4 * 16 * 28, 16 * 28, 28), 4),
    (2, 30, (0, _MB), (4 * 16 * 30, 16 * 30, 30), 4),     # 60-byte rows
    (2, 15, (0, _MB), (4 * 16 * 15, 16 * 15, 15), 2),     # element copies
    (4, 15, (0, _MB), (4 * 16 * 15, 16 * 15, 15), 4),
    (4, 128, (8, 0), (4096 * 128, 128, 8 * 128), 4),      # base 8 bytes off
    (4, 128, (0, 4), (4096 * 128, 128, 8 * 128), 4),
    (4, 128, (0, 0), (4096 * 128, 128, 129), 4),          # odd slot stride
    (2, 128, (0, 0), (4096 * 128, 132, 8 * 128), 4),      # 264-byte heads
])
def test_decode_copy_width_rule(esize, hd, ptrs, strides, want):
    """``tile_plan.vector_bytes``, the mirror of the decode kernels' C
    rule (``vector_bytes`` in csrc/decode_core.cuh, held to it on the card
    by tests/test_torch_cuda.py): the wider of 16 and 4 bytes that the
    row's length, both base addresses and every row stride allow, else
    one element."""
    from repro_torch.kernels import tile_plan as tp
    assert tp.vector_bytes(esize, hd, ptrs, strides + strides) == want


# ---------------------------------------------------------------------------
# the SSD scan (#5): the precision plan of its tensor-core products, and
# the Python mirror of its launches and scratch
# ---------------------------------------------------------------------------

def _ssd_emulated(prod, x, dt, a, b, c, init, q):
    """The kernels' arithmetic (csrc/ssd_scan.cu) for one group of heads,
    every product through ``prod``, everything else in float32.  x: (L, H,
    P); dt: (L, H); a: (H,); b, c: (L, N); init: (H, P, N)."""
    l, h, p = x.shape
    f32 = np.float32
    y = np.zeros((l, h, p), f32)
    state = init.copy()
    for t0 in range(0, l, q):
        bc, cc = b[t0:t0 + q], c[t0:t0 + q]
        cb = prod(cc, bc.T)                          # once for the group
        tri = np.tri(q, dtype=bool)
        for k in range(h):
            xc, dtc = x[t0:t0 + q, k], dt[t0:t0 + q, k]
            cum = np.cumsum(a[k] * dtc, dtype=f32)
            last = cum[-1]
            wdec = (dtc * np.exp(last - cum)).astype(f32)
            ds = prod(bc.T, xc * wdec[:, None]).T    # (P, N)
            s_in = state[k]
            yk = prod(cc, s_in.T) * np.exp(cum)[:, None]
            seg = np.where(tri, cum[:, None] - cum[None, :], 0).astype(f32)
            scores = np.where(tri, cb * np.exp(seg), 0).astype(f32)
            yk = yk + prod(scores, xc * dtc[:, None])
            y[t0:t0 + q, k] = yk
            state[k] = (np.exp(last) * s_in + ds).astype(f32)
    return y, state


def test_ssd_scan_needs_the_3xtf32_split_for_fp32():
    """mamba2-1.3b's head widths (P = 64, N = 128, chunks of 128) over
    L = 2048 for 2 heads of one group with an initial state: the kernels'
    steps (C.B^T once for the group, each chunk's state contribution, the
    pass over chunks, y through the scores and the entering state) with
    every product as 3xTF32 stay within the scan's fp32 tolerance of the
    sequential oracle in float64 (atol = rtol = 1e-4,
    tests/test_kernels.py's; max |err| of y 2.7e-5 at max |y| 21).  With
    one TF32 product a dot neither y nor the final state does (y 1.0e-2,
    the state 1.3e-3)."""
    rng = np.random.default_rng(0)
    l, h, p, n, q = 2048, 2, 64, 128, 128
    x = _rand(rng, (l, h, p))
    dt = np.log1p(np.exp(_rand(rng, (l, h)))).astype(np.float32)
    a = -np.exp(_rand(rng, (h,)) * 0.5)
    b, c = _rand(rng, (l, n)) * 0.3, _rand(rng, (l, n)) * 0.3
    init = _rand(rng, (h, p, n)) * 0.5
    t = [torch.from_numpy(v.astype(np.float64)) for v in
         (x[None], dt[None], a, b[None, :, None], c[None, :, None],
          init[None])]
    ye, fe = ref.ssd_reference(*t)
    ye, fe = ye[0].numpy(), fe[0].numpy()
    tol = dict(atol=1e-4, rtol=1e-4)
    y3, f3 = _ssd_emulated(_three_tf32, x, dt, a, b, c, init, q)
    np.testing.assert_allclose(y3, ye, **tol)
    np.testing.assert_allclose(f3, fe, **tol)
    y1, f1 = _ssd_emulated(_one_tf32, x, dt, a, b, c, init, q)
    assert not np.allclose(y1, ye, **tol)
    assert not np.allclose(f1, fe, **tol)


# ---------------------------------------------------------------------------
# the attention backward (2b): the precision plan of its five products and
# its block plan
# ---------------------------------------------------------------------------

def _tf32_cut(x):
    """x as TF32 by truncation: its low 13 bits cleared."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _three_tf32_cut(a, b):
    """3xTF32 as the attention backward splits (csrc/flash_attention_bwd.cu
    ``split_fast``): hi = x with its low 13 bits cleared, lo = x - hi,
    which the tensor core reads as TF32 by dropping its low 13 bits too;
    lo.hi' + hi.lo' + hi.hi'."""
    def split(x):
        hi = _tf32_cut(x)
        return hi.astype(np.float64), _tf32_cut(x - hi).astype(np.float64)
    ah, al = split(a)
    bh, bl = split(b)
    return (al @ bh + ah @ bl + ah @ bh).astype(np.float32)


def _bwd_exact(q, k, v, do):
    """dq, dk, dv and o of causal attention in float64 for one kv head:
    q, do (G, S, hd); k, v (S, hd); dk and dv summed over the G heads."""
    q, k, v, do = (x.astype(np.float64) for x in (q, k, v, do))
    seen = np.tri(q.shape[1], dtype=bool)
    scale = 1 / np.sqrt(q.shape[2])
    dq, o = np.zeros_like(q), np.zeros_like(q)
    dk, dv = np.zeros_like(k), np.zeros_like(v)
    for h in range(q.shape[0]):
        x = np.where(seen, q[h] @ k.T * scale, -np.inf)
        p = np.exp(x - x.max(1, keepdims=True))
        p /= p.sum(1, keepdims=True)
        o[h] = p @ v
        ds = p * (do[h] @ v.T - (do[h] * o[h]).sum(1, keepdims=True))
        dq[h] = ds @ k * scale
        dk += ds.T @ q[h] * scale
        dv += p.T @ do[h]
    return dq, dk, dv, o


def _bwd_emulated(prod, q, k, v, do, o):
    """The backward kernels' arithmetic (csrc/flash_attention_bwd.cu) for
    one kv head, the five products (and the logsumexp's recomputed Q K^T)
    through ``prod``, everything else in float32; o is the forward's fp32
    output.  The kv head's partials are summed in head order."""
    f32 = np.float32
    seen = np.tri(q.shape[1], dtype=bool)
    scale = f32(1 / np.sqrt(q.shape[2]))
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    for h in range(q.shape[0]):
        x = np.where(seen, prod(q[h], k.T) * scale, -np.inf).astype(f32)
        m = x.max(1, keepdims=True)
        lse = m + np.log(np.exp(x - m).sum(1, keepdims=True, dtype=f32))
        p = np.where(seen, np.exp(x - lse), 0).astype(f32)
        dsum = (do[h] * o[h]).sum(1, keepdims=True, dtype=f32)
        ds = (p * (prod(do[h], v.T) - dsum)).astype(f32)
        dv += prod(p.T, do[h])
        dk += prod(ds.T, q[h]) * scale
        dq[h] = prod(ds, k) * scale
    return dq, dk, dv


@pytest.mark.parametrize("s", [256, 2048])
def test_attention_bwd_needs_the_3xtf32_split_for_fp32(s):
    """At hd 128, one kv head's G = 3 query heads over S = 256 and 2048
    (minitron-4b's heads, the ends of the card's backward cases): dQ, dK
    and dV with every product as the kernel's 3xTF32 (split by truncation)
    stay within 1e-4 x each gradient's largest magnitude of float64 (rtol
    1e-4; found: 3.1e-7 to 1.2e-6 of the largest, where the rounding split
    of tf32_mma.cuh gives 1.1e-7 to 3.7e-7).  With one TF32 product none
    of the three does (found: 2.8e-4 to 7.5e-4 of the largest): measured
    against the largest gradient the error does not grow from S = 256 to
    2048, and one TF32 product misses by 3-7x at both.  The sums here are
    exact; the tensor cores' fp32 accumulation adds its own error on the
    card."""
    rng = np.random.default_rng(0)
    q, do = _rand(rng, (3, s, 128)), _rand(rng, (3, s, 128))
    k, v = _rand(rng, (s, 128)), _rand(rng, (s, 128))
    *exact, o = _bwd_exact(q, k, v, do)
    o = o.astype(np.float32)
    for prod in (_three_tf32_cut, _three_tf32):
        for got, want in zip(_bwd_emulated(prod, q, k, v, do, o), exact):
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max())
    for got, want in zip(_bwd_emulated(_one_tf32, q, k, v, do, o), exact):
        top = np.abs(want).max()
        assert not np.allclose(got, want, rtol=1e-4, atol=1e-4 * top)
        assert np.abs(got - want).max() > 2e-4 * top


def _round_to_zero(x):
    """float64 x to float32, rounded toward zero."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y


def _mma_sum(a, b, tile):
    """a @ b as the attention backward's dV and dK accumulate it on the
    tensor cores, under a model of mma.sync's fp32 accumulation: each
    m16n8k8 step adds its eight exact TF32 products (the 3xTF32 split by
    truncation, three steps) to the accumulator and rounds the sum toward
    zero.  tile=None: one running accumulator for the whole sum (the
    kernel before its dot_tile); tile=32: a fresh accumulator a 32-row
    tile, added to the sum in float32 (dot_tile)."""
    def split(x):
        hi = _tf32_cut(x)
        return hi.astype(np.float64), _tf32_cut(x - hi).astype(np.float64)
    ah, al = split(a)
    bh, bl = split(b)
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    n = a.shape[1]
    for t0 in range(0, n, tile or n):
        acc = np.zeros_like(total)
        for t in range(t0, min(t0 + (tile or n), n), 8):
            for x, y in ((al, bh), (ah, bl), (ah, bh)):
                acc = _round_to_zero(acc + x[:, t:t + 8] @ y[t:t + 8])
        total = total + acc
    return total


def test_attention_bwd_error_grows_with_a_running_tensor_core_sum():
    """Why the card's dK and dV error grew with S before the kernel summed
    each tile apart (H100: 2.8e-5 / 6.0e-5 / 1.2e-4 / 2.0e-4 at S = 256 /
    512 / 1024 / 2048, minitron-4b's heads; 2.2e-5 of the largest gradient
    at 2048): under a model of the tensor cores' fp32 accumulation (each
    mma.sync step rounds toward zero, ``_mma_sum``), one running
    accumulator loses up to an ulp of itself at each of 3 S / 8 steps.  At
    hd 128 over the first 64 keys of one head (the longest sums), found,
    of the largest dK or dV: 7.5e-6 / 3.3e-5 / 7.4e-5 at S = 512 / 2048 /
    4096, growing with S toward the 1e-4 tolerance; with a fresh
    accumulator a 32-query tile, added in float32, 6.4e-7 to 1.0e-6 at
    every S."""
    rng = np.random.default_rng(0)
    hd, keys = 128, 64
    found = {}
    for s in (512, 2048, 4096):
        q, k, v, do = (rng.standard_normal((s, hd)).astype(np.float32)
                       for _ in range(4))
        _, dk, dv, _ = _bwd_exact(q[None], k, v, do[None])
        x = np.where(np.tri(s, dtype=bool),
                     q.astype(np.float64) @ k.T.astype(np.float64), -np.inf)
        x /= np.sqrt(hd)
        p = np.exp(x - x.max(1, keepdims=True))
        p /= p.sum(1, keepdims=True)
        o = p @ v.astype(np.float64)
        ds = p * (do @ v.T.astype(np.float64)
                  - (do * o).sum(1, keepdims=True))
        pt, dst = (m.T[:keys].astype(np.float32) for m in (p, ds))
        scale = np.float32(1 / np.sqrt(hd))
        for tile in (None, 32):
            got_v = _mma_sum(pt, do, tile)
            got_k = _mma_sum(dst, q, tile) * scale
            found[s, tile] = max(
                np.abs(got_v - dv[:keys]).max() / np.abs(dv[:keys]).max(),
                np.abs(got_k - dk[:keys]).max() / np.abs(dk[:keys]).max())
    print({key: f"{e:.2g}" for key, e in found.items()})
    assert found[2048, None] > 4 * found[512, None]
    assert found[4096, None] > 1.5 * found[2048, None]
    assert found[4096, None] > 1e-5
    for s in (512, 2048, 4096):
        assert found[s, 32] < 2e-6
        assert found[s, 32] < found[s, None] / 5
    assert found[4096, 32] < 2 * found[512, 32]


@pytest.mark.parametrize("b,h,kh,s,hd,longest,mean", [
    (1, 24, 8, 2048, 128, 64, 33.0),   # minitron-4b's heads, S=2048
    (16, 8, 4, 112, 28, 4, 3.0),       # BASE's training shape
    (16, 4, 2, 96, 32, 3, 2.0),        # SMALL's
    (1, 24, 8, 512, 128, 16, 9.0),
])
def test_attention_bwd_plan_balances_dkv(b, h, kh, s, hd, longest, mean):
    """``tile_plan.bwd_plan``, the launches the wrapper passes
    csrc/flash_attention_bwd.cu's C entry (``bwd_launch``; the entry
    refuses any other plan, tests/test_torch_cuda.py) with their walks: a
    dK/dV block per (64 keys, query head) walks the 32-query tiles of its
    own head at or after its keys, so the longest walk is n_tiles =
    ceil(S / 32) at most (64 at S=2048, where a block per (32 keys, kv
    head) walks G x 64 = 192); blocks run heaviest first; two blocks fit
    in an SM's 228 KB of shared memory (1 KB of it reserved a block); the
    scratch is what the wrapper allocates: lse and D, and with G > 1 the
    partials."""
    from repro_torch.kernels import flash_attention_bwd as bwd
    from repro_torch.kernels import tile_plan as tp
    pl = tp.bwd_plan(b, h, kh, s, hd)
    print(f"dkv walk at b={b} h={h} kh={kh} s={s} hd={hd}: longest "
          f"{pl['dkv_longest']}, mean {pl['dkv_mean']:.2f} of "
          f"{pl['n_tiles']} tiles")
    assert pl["n_tiles"] == -(-s // 32)
    assert pl["dkv_longest"] == longest <= pl["n_tiles"] + 1
    assert pl["dkv_mean"] == mean
    assert pl["dkv_steps"] == sorted(pl["dkv_steps"], reverse=True)
    assert pl["dq_steps"] == sorted(pl["dq_steps"], reverse=True)
    names = [x["name"] for x in pl["launches"]]
    assert names == ["dq_kernel", "dkv_kernel"] + (
        ["sum_kernel"] if h > kh else [])
    assert pl["launches"][1]["grid"] == (h, b, -(-s // 64))
    assert tp.bwd_launch(b, h, kh, s, hd)[0] == -(-s // 64)
    for x in pl["launches"]:
        assert 2 * (x["smem_bytes"] + 1024) <= 228 * 1024
    lse, dsum, part = bwd.scratch(b, h, kh, s, hd, "cpu")
    assert lse.shape == dsum.shape == (b, h, s)
    assert part.numel() == pl["scratch_floats"]["partials"] == (
        2 * b * h * s * hd if h > kh else 0)
    assert lse.numel() + dsum.numel() == pl["scratch_floats"]["stats"]
    assert pl["scratch_bytes"] == 4 * (lse.numel() + dsum.numel()
                                       + part.numel())
    assert lse.untyped_storage().nbytes() == pl["scratch_bytes"]


@pytest.mark.parametrize("b,l,h,p,g,n,q,route,blocks", [
    (1, 37, 64, 64, 1, 128, 37, "one chunk", (67, 0, 64)),
    (1, 2048, 64, 64, 1, 128, 128, "chunks", (1152, 512, 1024)),
    (3, 96, 8, 80, 2, 256, 32, "chunks", (180, 480, 144)),
    (2, 9, 4, 16, 1, 7, 1, "chunks", (90, 8, 72)),   # Q = 1, P x N = 112
    (1, 100, 4, 36, 2, 18, 50, "chunks", (24, 4, 8)),  # P x N = 648
    (1, 8, 2, 5, 1, 7, 4, "chunks", (6, 2, 4)),    # P x N = 35: pitch 36
])
def test_ssd_plan_mirror(b, l, h, p, g, n, q, route, blocks):
    """``tile_plan.ssd_plan``, the mirror of csrc/ssd_scan.cu's plan (held
    to the C entry on the card by tests/test_torch_cuda.py): one chunk
    skips the pass; the chunk launch has a state block per (row, head, 64
    P columns, chunk) and a C.B^T block per (row, group, 16 rows, chunk);
    the pass moves float4s, each chunk's state pitched to a multiple of 4
    floats in the scratch; every scratch part is a whole number of 16-byte
    steps, C.B^T rows padded to 4 floats; two blocks fit an SM's 228 KB of
    shared memory."""
    from repro_torch.kernels import tile_plan as tp
    pl = tp.ssd_plan(b, l, h, p, g, n, q)
    nc = l // q
    assert pl["route"] == route and pl["chunks"] == nc
    assert tuple(x["blocks"] for x in pl["launches"]) == blocks
    assert all(x["threads"] == tp.SSD_THREADS for x in pl["launches"])
    sc = pl["scratch_floats"]
    assert all(v % 4 == 0 for v in sc.values())
    assert sc["cum"] >= b * h * nc * q
    assert sc["cb"] >= b * g * nc * q * (-(-q // 4) * 4)
    assert sc["st"] == (0 if nc == 1 else b * h * nc * (-(-p * n // 4) * 4))
    assert pl["scratch_bytes"] == 4 * sum(sc.values())
    for x in pl["launches"]:
        assert 2 * (x["smem_bytes"] + 1024) <= 228 * 1024
