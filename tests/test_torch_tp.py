"""Exact tensor parallelism in the port (``--tp``), on the CPU over gloo.

One spawn of 2 rank processes for the module (``serving.tp.run_ranks``,
a FileStore under ``tmp_path``, the group's and the spawn's timeouts
bounding every wait) runs every scenario of ``tests/torch_tp_ranks.py``
while this process runs the same scenarios at tp=1.  Held:

  * the port's ``kernels/paged_tp.py`` over each rank's heads, gathered,
    against the JAX package's ``tp_paged_decode_attention`` and
    ``tp_paged_append_attention`` on a 2-device CPU mesh (its reference
    body and its Pallas body in interpret mode), at 1e-5 (fp32 softmax
    sums), and bit for bit against the port's unsharded plain version;
  * the parameter table (``models/sharding.py``) against the JAX
    package's ``Model.partition_specs(rules=EXACT_TP_RULES)``: every dim
    agrees but ``wo``'s and ``w_down``'s, which the JAX rules shard and
    the port keeps whole (the JAX package's design, ``serving/tp.py``,
    replicates them; its rules contradict it, and its TP suite fails on
    that);
  * tp=2 against tp=1 in the port on the reference suite's configs
    (``tests/test_tp_serving.py``) with JAX-initialised parameters:
    tokens and step traces identical greedy, sampled at 0.8, with spec
    decode at gamma 3, on a prefix-cache resubmit with hits, on a
    pressured run that preempts and with a sliding window of 8 on the
    base (#3 and #4 take it per rank); the base's logits of an extend and a
    decode step bit for bit (on the CPU at one thread a column slice of
    a GEMM keeps the whole product's order; on the card cuBLAS picks its
    variant from N, and ``chip_smoke.py`` holds the gap to 1e-4);
  * the contracts: divisibility, a mixed engine pair, per-rank page
    views, the fused loop and ``--tp`` without the continuous scheduler
    refused, no CPU fallback for ``--device cuda``;
  * ``serve --tp 2`` prints ``--tp 1``'s think and answer lines.
"""

import concurrent.futures
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import torch_tp_ranks
from repro.checkpoint import checkpoint as jckpt
from repro.configs import testbed as jtestbed
from repro.kernels.paged_tp import (tp_paged_append_attention as
                                    jax_tp_append,
                                    tp_paged_decode_attention as
                                    jax_tp_decode)
from repro.launch.mesh import make_tp_mesh
from repro.models.layers import EXACT_TP_RULES
from repro.models.model import Model as JModel
from repro_torch.kernels import paged_tp
from repro_torch.launch import mesh, serve
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, flatten, unflatten
from repro_torch.models.sharding import shard_params, sliced_dim
from repro_torch.serving.batch_engine import BatchEngine
from repro_torch.serving.loader import save_random_testbed
from repro_torch.serving.paged_kv import PagedKVPool, PagedKVStore
from repro_torch.serving.prefix_cache import RadixCache
from repro_torch.serving.spec_engine import BatchSpecEngine
from repro_torch.serving.tp import TPContext, run_ranks
from test_tp_serving import BASE_CFG, SMALL_CFG

KERNEL_TOL = 1e-5
RANKS_TIMEOUT_S = 150.0


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(jcfg) -> dict:
    return {f.name: getattr(jcfg, f.name)
            for f in dataclasses.fields(ModelConfig)}


@pytest.fixture(scope="module")
def payload():
    params, cfg = {}, {}
    for which, jcfg, seed in (("base", BASE_CFG, 0), ("small", SMALL_CFG, 1)):
        params[which] = jckpt._flatten(
            jax.jit(JModel(jcfg).init)(jax.random.PRNGKey(seed)))
        cfg[which] = _port_cfg(jcfg)
    return dict(params=params, cfg=cfg,
                kernel_case=torch_tp_ranks.kernel_case())


@pytest.fixture(scope="module")
def runs(payload, tmp_path_factory):
    """(tp=1 here, [rank 0, rank 1] at tp=2): the ranks run in their own
    processes while this one runs tp=1."""
    store = tmp_path_factory.mktemp("tp-store")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, 2, "cpu", torch_tp_ranks.run,
                            (payload,), RANKS_TIMEOUT_S, 1, str(store))
        tp1 = torch_tp_ranks.run(None, payload)
        return tp1, ranks.result()


# ------------------------------------------------------------ kernels

def _jax_kernels(case, **body):
    """The JAX package's shard_map wrappers on a 2-device mesh, jitted
    (run eagerly, the reference body dispatches op by op)."""
    m = make_tp_mesh(2)
    j = {k: jnp.asarray(v) for k, v in case.items()}
    dec = jax.jit(lambda *a: jax_tp_decode(m, *a, **body))(
        j["q"], j["k_pages"], j["v_pages"], j["tables"], j["lengths"])
    app = jax.jit(lambda *a: jax_tp_append(m, *a, **body))(
        j["aq"], j["k_new"], j["v_new"], j["k_pages"], j["v_pages"],
        j["tables"], j["ctx"], j["span"])
    return {"decode": np.asarray(dec), "append": np.asarray(app)}


@pytest.mark.parametrize("body", [dict(use_kernel=False),
                                  dict(interpret=True, use_kernel=True)],
                         ids=["reference", "interpret"])
def test_paged_tp_matches_jax_shard_map(runs, payload, body):
    _, ranks = runs
    case = payload["kernel_case"]
    want = _jax_kernels(case, **body)
    got = ranks[0]["kernels"]
    np.testing.assert_allclose(got["decode"], want["decode"],
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)
    for i, n in enumerate(case["span"]):     # past span_len: unspecified
        np.testing.assert_allclose(got["append"][i, :n],
                                   want["append"][i, :n],
                                   atol=KERNEL_TOL, rtol=KERNEL_TOL)


@pytest.mark.parametrize("kind", ["decode", "append"])
def test_paged_tp_is_the_unsharded_plain_version_bitwise(runs, payload,
                                                         kind):
    _, ranks = runs
    want = torch_tp_ranks.plain_kernels(payload["kernel_case"])[kind]
    for r in ranks:
        assert np.array_equal(r["kernels"][kind], want)


def test_paged_tp_refuses_a_wrong_head_slice():
    tp = TPContext(rank=1, tp_size=2, device=torch.device("cpu"))
    q = torch.zeros(2, 3, 8)
    pages = torch.zeros(4, 2, 4, 8)
    tables = torch.zeros(2, 1, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="GQA group"):
        paged_tp.tp_paged_decode_attention(tp, q, pages, pages, tables, lens)
    with pytest.raises(ValueError, match="slice"):
        paged_tp.tp_paged_decode_attention(tp, torch.zeros(2, 4, 8), pages,
                                           pages, tables, lens,
                                           heads=(4, 2))
    with pytest.raises(ValueError, match="kv heads"):
        paged_tp.tp_paged_append_attention(
            tp, torch.zeros(2, 3, 4, 8), torch.zeros(2, 3, 1, 8),
            torch.zeros(2, 3, 1, 8), pages, pages, tables, lens, lens)


# ------------------------------------------------------ parameter table

def _jax_model_dims(jcfg) -> dict:
    """'/'-key -> the dim JAX shards over "model" (None: replicated)."""
    specs = JModel(jcfg).partition_specs(rules=EXACT_TP_RULES,
                                         mesh_shape={"model": 2})
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    out = {}
    for path, spec in leaves:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        dims = [i for i, m in enumerate(spec) if m == "model"]
        out[key] = dims[0] if dims else None
    return out


@pytest.mark.parametrize("jcfg", [jtestbed.BASE, jtestbed.SMALL, BASE_CFG,
                                  SMALL_CFG],
                         ids=["testbed-base", "testbed-small", "suite-base",
                              "suite-small"])
def test_param_table_matches_exact_tp_rules(jcfg):
    jax_dims = _jax_model_dims(jcfg)
    spec = Model(ModelConfig(**_port_cfg(jcfg))).spec()
    assert set(spec) == set(jax_dims)
    diverged = set()
    for key, s in spec.items():
        dim = sliced_dim(key)
        ours = None if dim is None else dim % len(s.shape)
        if key.rsplit("/", 1)[-1] in ("wo", "w_down"):
            # the JAX rules shard wo on heads and w_down on the hidden;
            # the design (its serving/tp.py) and the port keep them whole
            assert jax_dims[key] is not None and ours is None, key
            diverged.add(key.rsplit("/", 1)[-1])
        else:
            assert ours == jax_dims[key], key
    assert diverged == {"wo", "w_down"}


def test_shard_params_slices_contiguous_copies():
    model = Model(ModelConfig(**_port_cfg(BASE_CFG)))
    params = model.init(0, device="cpu")
    parts = [flatten(shard_params(params, r, 2)) for r in range(2)]
    whole = flatten(params)
    for key, t in whole.items():
        dim = sliced_dim(key)
        if dim is None:
            assert all(p[key] is t for p in parts), key
            continue
        assert all(p[key].is_contiguous() for p in parts), key
        assert torch.equal(torch.cat([p[key] for p in parts], dim), t), key
    tp = TPContext(rank=1, tp_size=2, device=torch.device("cpu"))
    local = tp.shard_params(model, params)
    again = flatten(tp.shard_params(model, local))   # a shard passes
    for key, t in flatten(local).items():
        assert torch.equal(again[key], t) and torch.equal(t, parts[1][key])
    cache = torch.arange(2 * 3 * 5 * 4 * 7.0).reshape(2, 3, 5, 4, 7)
    assert torch.equal(tp.shard_state(cache), cache[:, :, :, 2:])
    assert tp.shard_state(cache).is_contiguous()
    bad = dict(flatten(params), **{"layers/attn/wq": torch.zeros(2, 64, 3,
                                                                 16)})
    with pytest.raises(ValueError, match="neither whole"):
        tp.shard_params(model, unflatten(bad))


# ---------------------------------------------------- tp=2 against tp=1

@pytest.mark.parametrize("name", list(torch_tp_ranks.SCENARIOS))
def test_tp2_tokens_and_traces_equal_tp1(runs, name):
    tp1, ranks = runs
    want = tp1[name]
    for r in ranks:
        got = r[name]
        assert got["traces"] == want["traces"]
        assert (got["ticks"], got["preemptions"], got["cache_hits"]) == \
            (want["ticks"], want["preemptions"], want["cache_hits"])
        assert got["pools"] == {"base": 0.0, "small": 0.0}
    if name == "pressured":
        assert want["preemptions"] > 0
    if name == "prefix":
        assert want["cache_hits"] > 0
    if name == "spec":
        assert ranks[0][name]["spec_tp_size"] == 2
        assert any(t[3][2] > 0 for t in want["traces"])
    if name == "window":     # every prompt outgrows the window
        assert min(want["prompt_lens"]) > 8


@pytest.mark.parametrize("kind", ["extend", "decode"])
def test_tp2_logits_are_tp1_bitwise(runs, kind):
    tp1, ranks = runs
    for r in ranks:
        assert np.array_equal(r["logits"][kind], tp1["logits"][kind])


def test_ranks_hold_their_heads_and_gather_twice_a_layer(runs, payload):
    tp1, ranks = runs
    kh = payload["cfg"]["base"]["n_kv_heads"]
    assert tp1["greedy"]["store_heads"] == kh
    for rank, r in enumerate(ranks):
        assert r["greedy"]["store_heads"] == kh // 2
        assert r["greedy"]["views"] == [
            {"rank": i, "device": "cpu", "kv_head_start": i * kh // 2,
             "kv_heads": kh // 2} for i in range(2)]
        assert r["describe"] == {"axes": {"model": 2}, "tp_size": 2,
                                 "devices": ["cpu", "cpu"]}
        assert r["threads"] == 1
        assert r["gathers"] > 0 and r["gathers"] % 2 == 0
    assert ranks[0]["gathers"] == ranks[1]["gathers"]


# ---------------------------------------------------------- contracts

def _cpu_tp(rank=0):
    return TPContext(rank=rank, tp_size=2, device=torch.device("cpu"))


def test_divisibility_and_family_contracts():
    tp = _cpu_tp()
    odd = ModelConfig(name="odd", family="dense", n_layers=1, d_model=32,
                      n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64,
                      vocab_size=64).validate()
    with pytest.raises(ValueError, match="n_kv_heads=1"):
        tp.check_model(odd)
    with pytest.raises(ValueError, match="n_heads=3"):
        tp.check_model(dataclasses.replace(odd, n_heads=3, n_kv_heads=3))
    with pytest.raises(ValueError, match="d_ff=63"):
        tp.check_model(dataclasses.replace(odd, n_kv_heads=2, d_ff=63))
    # a window goes through paged_tp to #3 and #4 (the "window" scenario)
    tp.check_model(dataclasses.replace(odd, n_kv_heads=2, sliding_window=8))
    with pytest.raises(NotImplementedError, match="dense family.*item 8"):
        tp.check_model(dataclasses.replace(odd, n_kv_heads=2,
                                           family="moe", n_experts=4,
                                           top_k=2))
    tp.check_model(ModelConfig(**_port_cfg(BASE_CFG)))
    pool = PagedKVPool(8, 4)
    with pytest.raises(ValueError, match="kv_heads=3"):
        PagedKVStore(pool, 1, 3, 16, "cpu", tp=tp)
    with pytest.raises(ValueError, match="kv_heads=3"):
        RadixCache(pool, 4, kv_heads=3, tp=tp)
    with pytest.raises(ValueError, match="tp_size must be >= 1"):
        mesh.make_tp_group(0, 0, "file:///nowhere", torch.device("cpu"))


def test_mixed_tp_pair_and_fused_loop_refused():
    tp = _cpu_tp()
    base = Model(ModelConfig(**_port_cfg(BASE_CFG)))
    small = Model(ModelConfig(**_port_cfg(SMALL_CFG)))
    be_tp = BatchEngine(base, base.init(0, device="cpu"), batch=2,
                        capacity=64, tp=tp)
    assert not be_tp.fused and be_tp.params["layers"]["attn"]["wq"].shape[2] \
        == BASE_CFG.n_heads // 2
    be_plain = BatchEngine(small, small.init(1, device="cpu"), batch=2,
                           capacity=64)
    with pytest.raises(ValueError, match="share one TPContext"):
        BatchSpecEngine(be_tp, be_plain)
    with pytest.raises(NotImplementedError, match="cannot be captured"):
        BatchEngine(base, base.init(0, device="cpu"), batch=2, capacity=64,
                    fused=True, tp=tp)
    with pytest.raises(NotImplementedError, match="cannot be captured"):
        be_tp.generate_rows_fused([0], 4, [], None, [torch.Generator()])


def test_paged_store_device_views():
    pool = PagedKVPool(8, 4)
    tp = TPContext(rank=1, tp_size=2, device=torch.device("cpu"),
                   devices=("cuda:0", "cuda:0"))
    store = PagedKVStore(pool, 2, 2, 16, "cpu", tp=tp)
    assert store.k.shape == (2, 9, 1, 4, 16)
    assert store.device_views() == [
        {"rank": 0, "device": "cuda:0", "kv_head_start": 0, "kv_heads": 1},
        {"rank": 1, "device": "cuda:0", "kv_head_start": 1, "kv_heads": 1}]
    plain = PagedKVStore(pool, 2, 2, 16, "cpu")
    assert plain.device_views() == [{"rank": 0, "device": "cpu",
                                     "kv_head_start": 0, "kv_heads": 2}]


def test_cli_refuses_tp_outside_the_continuous_per_token_path(tmp_path):
    base = ["--device", "cpu", "--ckpt-dir", str(tmp_path)]
    for extra in (["--tp", "2"], ["--tp", "0"],
                  ["--tp", "2", "--scheduler", "continuous",
                   "--decode-loop", "fused"]):
        with pytest.raises(SystemExit):
            serve.parse_args(base + extra)
    args = serve.parse_args(base + ["--tp", "2", "--scheduler",
                                    "continuous"])
    assert args.decode_loop == "eager"
    assert serve.parse_args(base).decode_loop == "fused"


def test_tp_on_cuda_without_a_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--scheduler", "continuous", "--tp", "2",
                    "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.rank_device(1, 2, "cuda")


def _request_lines(out: str):
    return [re.sub(r" lat=\S+", "", ln) for ln in out.splitlines()
            if ln.startswith("[continuous] req")]


def test_serve_tp2_prints_tp1_lines(tmp_path, capfd):
    save_random_testbed(str(tmp_path))
    argv = ["--device", "cpu", "--scheduler", "continuous", "-n", "2",
            "--batch", "2", "--budget", "24", "--temperature", "0",
            "--ckpt-dir", str(tmp_path)]
    one = serve.main(argv)
    out1 = capfd.readouterr().out
    two = serve.main(argv + ["--tp", "2"])
    out2 = capfd.readouterr().out
    assert _request_lines(out1) and _request_lines(out2) == \
        _request_lines(out1)
    assert re.search(r"^\[tp\] 2 ranks, backend gloo, devices "
                     r"\['cpu', 'cpu'\]", out2, re.M)
    assert [r[3].answer_ids for r in two.runs] == \
        [r[3].answer_ids for r in one.runs]
    assert two.stats["tp"] == 2 and two.stats["decode_loop"] == "eager"
