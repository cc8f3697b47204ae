"""The port's dense model against the JAX package's: the parameter bridge
(JAX ``Model.init`` -> numpy -> ``params_from_numpy``), npz checkpoints
read across both packages, the elementary layers, and fp32 logits of
MICRO, SMALL and BASE over forward and prefill -> extend -> decode.

Every input is made with numpy from a fixed seed; both sides get the same
parameters.  Tolerances: layers atol = rtol = 2e-5 (as
tests/test_kernels.py); logits atol = rtol = 5e-5, because a forward of
up to five layers sums in a different order on each side (measured max
|diff| about 4e-6 at |logit| about 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import testbed as jtestbed
from repro.models import layers as jlayers
from repro.models.model import Model as JModel
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import testbed
from repro_torch.models import layers as tlayers
from repro_torch.models.model import Model as TModel, flatten
from repro_torch.serving.batch_engine import BatchEngine

LAYER_TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = dict(rtol=5e-5, atol=5e-5)
CONFIGS = ["MICRO", "SMALL", "BASE"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name, seed=3):
    """(JAX model, JAX params, port model, port params) with the same
    weights, bridged through numpy."""
    jm = JModel(getattr(jtestbed, name))
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = TModel(getattr(testbed, name))
    tp = tckpt.params_from_numpy(jckpt._flatten(jp), device="cpu")
    return jm, jp, tm, tp


# ---------------------------------------------------------------------------
# parameters and checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_param_bridge_matches_spec(name):
    jm, jp, tm, tp = _pair(name)
    spec = tm.spec()
    flat = flatten(tp)
    assert set(flat) == set(spec) == set(jckpt._flatten(jp))
    for k, t in flat.items():
        assert tuple(t.shape) == spec[k].shape
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), jckpt._flatten(jp)[k])


def test_port_init_follows_the_jax_init_rules():
    """Same keys, shapes and per-tensor scale rules as the JAX init."""
    jm, jp, tm, _ = _pair("SMALL")
    tp = flatten(tm.init(0, device="cpu"))
    jf = jckpt._flatten(jp)
    for k, t in tp.items():
        a, b = t.numpy(), jf[k]
        assert a.shape == b.shape
        if np.all(b == b.flat[0]):             # ones / zeros
            np.testing.assert_array_equal(a, b)
        else:                                  # same stddev within 10%
            assert abs(a.std() / b.std() - 1) < 0.1, k
    again = flatten(tm.init(0, device="cpu"))
    assert all(torch.equal(again[k], tp[k]) for k in tp)


def test_npz_round_trip_jax_to_port(tmp_path):
    jm, jp, tm, _ = _pair("MICRO")
    path = str(tmp_path / "jax_written.npz")
    jckpt.save_checkpoint(path, jp, meta={"by": "jax"})
    shapes = {k: s.shape for k, s in tm.spec().items()}
    tp = tckpt.load_checkpoint(path, device="cpu", expect=shapes)
    for k, t in flatten(tp).items():
        np.testing.assert_array_equal(t.numpy(), jckpt._flatten(jp)[k])
    assert tckpt.load_meta(path) == {"by": "jax"}


def test_npz_round_trip_port_to_jax(tmp_path):
    jm = JModel(jtestbed.MICRO)
    tm = TModel(testbed.MICRO)
    tp = tm.init(5, device="cpu")
    path = str(tmp_path / "port_written.npz")
    tckpt.save_checkpoint(path, tp)
    jp = jckpt.load_checkpoint(path, jm.abstract(jnp.float32))
    jf = jckpt._flatten(jp)
    for k, t in flatten(tp).items():
        np.testing.assert_array_equal(jf[k], t.numpy())


def test_load_checkpoint_checks_keys_and_shapes(tmp_path):
    tm = TModel(testbed.MICRO)
    path = str(tmp_path / "m.npz")
    tckpt.save_checkpoint(path, tm.init(0, device="cpu"))
    shapes = {k: s.shape for k, s in tm.spec().items()}
    with pytest.raises(KeyError, match="missing param"):
        tckpt.load_checkpoint(path, "cpu", dict(shapes, extra=(1,)))
    bad = dict(shapes)
    bad["tok_embed"] = (1, 1)
    with pytest.raises(ValueError, match="tok_embed"):
        tckpt.load_checkpoint(path, "cpu", bad)


def test_other_families_raise():
    """The encdec and vlm families build, with the JAX package's
    parameter keys and shapes, and the batched engine refuses them (the
    JAX package's builds no cross cache); the moe family builds.  Their
    parity with the JAX package is tests/test_torch_crossattn.py's and
    tests/test_torch_moe.py's."""
    for over in (dict(family="encdec", n_encoder_layers=1),
                 dict(family="vlm", cross_attn_every=2)):
        tm = TModel(dataclasses.replace(testbed.MICRO, **over))
        jm = JModel(dataclasses.replace(jtestbed.MICRO, **over))
        want = jckpt._flatten(jm.init(jax.random.PRNGKey(0)))
        assert {k: s.shape for k, s in tm.spec().items()} == \
            {k: tuple(a.shape) for k, a in want.items()}
        with pytest.raises(ValueError, match=over["family"]):
            BatchEngine(tm, tm.init(0, device="cpu"), batch=2,
                        capacity=64)
    moe = TModel(dataclasses.replace(testbed.MICRO, family="moe",
                                     n_experts=4, top_k=2))
    assert "layers/moe/w_gate" in moe.spec() and \
        "layers/mlp/w_up" not in moe.spec()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_norms_rope_positions_mlps_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 28)).astype(np.float32)
    w = rng.standard_normal(28).astype(np.float32)
    bias = rng.standard_normal(28).astype(np.float32)
    pos = np.arange(3, 8)[None].repeat(2, 0).astype(np.int32)
    T, J = torch.from_numpy, jnp.asarray
    pairs = [
        (jlayers.rmsnorm(J(x), J(w)), tlayers.rmsnorm(T(x), T(w))),
        (jlayers.layernorm(J(x), J(w), J(bias)),
         tlayers.layernorm(T(x), T(w), T(bias))),
        (jlayers.apply_rope(J(x), J(pos), 10000.0),
         tlayers.apply_rope(T(x), T(pos), 10000.0)),
        (jlayers.sinusoidal_positions(J(pos), 28),
         tlayers.sinusoidal_positions(T(pos), 28)),
    ]
    h = rng.standard_normal((2, 3, 16)).astype(np.float32)
    for act, names in (("swiglu", ("w_gate", "w_up", "w_down")),
                       ("gelu", ("w_in", "b_in", "w_out", "b_out"))):
        shapes = {"w_gate": (16, 24), "w_up": (16, 24), "w_down": (24, 16),
                  "w_in": (16, 24), "b_in": (24,), "w_out": (24, 16),
                  "b_out": (16,)}
        p = {n: rng.standard_normal(shapes[n]).astype(np.float32) * 0.3
             for n in names}
        pairs.append((jlayers.apply_mlp(J(h), {n: J(a) for n, a in p.items()},
                                        act),
                      tlayers.apply_mlp(T(h), {n: T(a) for n, a in p.items()},
                                        act)))
    for a, b in pairs:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **LAYER_TOL)


# ---------------------------------------------------------------------------
# logits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_forward_logits_match_jax(name):
    jm, jp, tm, tp = _pair(name)
    toks = np.random.default_rng(1).integers(0, 64, (2, 24))
    lj, _ = jax.jit(jm.forward)(jp, jnp.asarray(toks, jnp.int32))
    lt = tm.forward(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_extend_decode_logits_match_jax(name):
    jm, jp, tm, tp = _pair(name)
    toks = np.random.default_rng(2).integers(0, 64, (1, 20))
    cap = 64
    sj, st = jm.init_state(1, cap), tm.init_state(1, cap, device="cpu")
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    for lo, hi in ((0, 9), (9, 16)):      # prompt, then an extend
        a, sj = prefill(jp, jnp.asarray(toks[:, lo:hi], jnp.int32), sj)
        b, st = tm.prefill(tp, torch.from_numpy(toks[:, lo:hi]), st)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **LOGIT_TOL)
    for t in range(16, 20):
        a, sj = decode(jp, sj, jnp.asarray(toks[:, t:t + 1], jnp.int32))
        b, st = tm.decode_step(tp, st, torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **LOGIT_TOL)
    assert st.pos == int(sj.pos) == 20
    np.testing.assert_allclose(st.k[:, :, :20].numpy(),
                               np.asarray(sj.k)[:, :, :20], **LAYER_TOL)
