"""Sliding-window decode in the port, on the CPU: the plain version of
flash-decode with a window (``ref.decode_reference(..., window)``, which
``ops.decode_attention`` runs for a CPU tensor) held to the masks of the
JAX package's ``decode_self_attention`` at G = 1, 5 and 9 query heads a
kv head, for windows below, at and above the row's length; the windowed
decode from a device position (the fused loop's) against a host one; and
the refusals that stay: a ring cache from a device position, recurrent
state on the batched engine (a window over paged rows is served), and
hybrid training.

Inputs are made with numpy from fixed seeds.  fp32 atol = rtol = 2e-5,
as tests/test_torch_kernels.py (the two sides sum in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models.config import ModelConfig as JConfig
from repro_torch.configs import registry
from repro_torch.kernels import ref
from repro_torch.models import attention as tattn
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.serving.batch_engine import BatchEngine
from repro_torch.training import loss as tloss

FP32 = dict(rtol=2e-5, atol=2e-5)
KV_HEADS, HEAD_DIM, CAP = 2, 16, 40


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(cls, g, window):
    return cls(name=f"win-g{g}", n_layers=1, d_model=48,
               n_heads=KV_HEADS * g, n_kv_heads=KV_HEADS, head_dim=HEAD_DIM,
               d_ff=64, vocab_size=64, sliding_window=window).validate()


def _layer(rng, cfg):
    d, hd, h, k = cfg.d_model, HEAD_DIM, cfg.n_heads, cfg.n_kv_heads
    shapes = {"wq": (d, h, hd), "wk": (d, k, hd), "wv": (d, k, hd),
              "wo": (h, hd, d)}
    return {n: rng.standard_normal(s).astype(np.float32) * 0.2
            for n, s in shapes.items()}


# pos is the new token's position, so a row sees pos + 1 keys; each
# window sits below, at or above that length (the last at a full cache)
@pytest.mark.parametrize("pos,window", [(29, 8), (29, 30), (29, 37),
                                        (39, 64)],
                         ids=["below", "at", "above", "above-full"])
@pytest.mark.parametrize("g", [1, 5, 9])
def test_windowed_decode_matches_jax(g, pos, window):
    """The port's ``decode_self_attention`` on a linear windowed cache
    (flash-decode's plain version with the window) against the JAX
    package's, which masks ``pos - window < j <= pos`` in XLA: the output
    and the written caches."""
    rng = np.random.default_rng(100 * g + pos + window)
    jcfg, tcfg = _cfg(JConfig, g, window), _cfg(ModelConfig, g, window)
    p = _layer(rng, jcfg)
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    kc = rng.standard_normal((2, CAP, KV_HEADS, HEAD_DIM)).astype(
        np.float32)
    vc = rng.standard_normal((2, CAP, KV_HEADS, HEAD_DIM)).astype(
        np.float32)
    oj, kj, vj = jattn.decode_self_attention(
        jnp.asarray(x), {n: jnp.asarray(a) for n, a in p.items()}, jcfg,
        jnp.asarray(kc), jnp.asarray(vc), jnp.int32(pos))
    kt, vt = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    lengths = torch.full((2,), min(pos + 1, CAP), dtype=torch.int32)
    ot = tattn.decode_self_attention(
        torch.from_numpy(x), {n: torch.from_numpy(a) for n, a in p.items()},
        tcfg, kt, vt, pos, lengths)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **FP32)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), **FP32)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **FP32)


def test_decode_reference_window_on_ragged_rows():
    """Ragged rows in one call: each row sees its own last ``window``
    keys, as a per-row call with ``lengths`` cut to the window would;
    window 0 and a window past every length are the unwindowed call."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((4, 10, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((4, 2, 64, 16)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((4, 2, 64, 16)).astype(
        np.float32))
    lens = torch.tensor([1, 9, 40, 64], dtype=torch.int32)
    got = ref.decode_reference(q, k, v, lens, 9)
    for b, n in enumerate(lens.tolist()):
        lo = max(0, n - 9)
        want = ref.decode_reference(q[b:b + 1], k[b:b + 1, :, lo:n],
                                    v[b:b + 1, :, lo:n],
                                    torch.tensor([n - lo], dtype=torch.int32))
        torch.testing.assert_close(got[b:b + 1], want, **FP32)
    full = ref.decode_reference(q, k, v, lens)
    assert torch.equal(ref.decode_reference(q, k, v, lens, 0), full)
    assert torch.equal(ref.decode_reference(q, k, v, lens, 64), full)


def test_windowed_decode_from_a_device_position():
    """The fused loop's step: a 0-d position tensor (and ``active``) on a
    windowed linear cache gives the host-position step's output and
    caches; a masked step leaves the caches as they were."""
    rng = np.random.default_rng(3)
    cfg = _cfg(ModelConfig, 5, 8)
    p = {n: torch.from_numpy(a) for n, a in _layer(rng, cfg).items()}
    x = torch.from_numpy(rng.standard_normal((1, 1, 48)).astype(np.float32))
    kc = torch.from_numpy(rng.standard_normal((1, CAP, 2, 16)).astype(
        np.float32))
    vc = torch.from_numpy(rng.standard_normal((1, CAP, 2, 16)).astype(
        np.float32))
    lengths = torch.tensor([21], dtype=torch.int32)
    k1, v1 = kc.clone(), vc.clone()
    want = tattn.decode_self_attention(x, p, cfg, k1, v1, 20, lengths)
    for on in (True, False):
        k2, v2 = kc.clone(), vc.clone()
        got = tattn.decode_self_attention(x, p, cfg, k2, v2,
                                          torch.tensor(20), lengths,
                                          active=torch.tensor(on))
        if on:
            torch.testing.assert_close(got, want, rtol=0, atol=0)
            assert torch.equal(k2, k1) and torch.equal(v2, v1)
        else:
            assert torch.equal(k2, kc) and torch.equal(v2, vc)


def test_refusals_that_stay():
    """A ring cache takes no device position (the JAX package's dry-run
    is its one user); a window over paged rows is served (#3 and #4 take
    it: tests/test_torch_paged_window.py), while recurrent state is
    still refused by the batched engine; hybrid training names its
    missing pieces; a hybrid state takes no ring."""
    cfg = _cfg(ModelConfig, 1, 8)
    p = {n: torch.from_numpy(a) for n, a in
         _layer(np.random.default_rng(0), cfg).items()}
    kc = torch.zeros(1, 8, 2, 16)
    with pytest.raises(NotImplementedError, match="ring"):
        tattn.decode_self_attention(torch.zeros(1, 1, 48), p, cfg, kc,
                                    kc.clone(), torch.tensor(3),
                                    torch.tensor([4], dtype=torch.int32),
                                    ring=True)
    star = registry.reduced("starcoder2-7b")
    model = Model(star)
    be = BatchEngine(model, model.init(0, device="cpu"), batch=2,
                     capacity=64)
    assert be.model.cfg.sliding_window == star.sliding_window > 0
    hyb = Model(registry.reduced("hymba-1.5b"))
    with pytest.raises(ValueError, match="attention-only"):
        BatchEngine(hyb, hyb.init(0, device="cpu"), batch=2, capacity=64)
    with pytest.raises(NotImplementedError, match="queue 2 J"):
        tloss.loss_fn(hyb, None, {})
    with pytest.raises(ValueError, match="linear"):
        hyb.init_state(1, 16, device="cpu", ring=True)
