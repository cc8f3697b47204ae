"""The port's continuous-batching scheduler over paged KV, inside the
port: continuous == sequential controller (greedy and sampled, from the
same generator seeds, spec decode off and on), a run preempted under
pool pressure gives the tokens of an unpressured one (each under the
batched rows' fused loop and their per-token loop), and a
reject-then-redraft across a copy-on-write tail block reads back the
pre-snapshot K/V.  Also the serve CLI on the CPU against the JAX CLI
with the same flags and checkpoints, and the features this slice leaves
out raising.

Tolerances: utilities and logits inside the port 1e-5
(tests/test_torch_batch.py).
"""

import random

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import testbed as jtestbed
from repro.launch import serve as jserve
from repro.models.model import Model as JModel
from repro.serving.engine import Engine as JEngine
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import testbed
from repro_torch.core import controller
from repro_torch.core.policies import StaticThreshold
from repro_torch.data import tasks
from repro_torch.launch import serve
from repro_torch.models.model import Model
from repro_torch.sampling.sample import SamplingParams
from repro_torch.serving import kv_manager as tkv
from repro_torch.serving.batch_engine import BatchEngine
from repro_torch.serving.engine import Engine
from repro_torch.serving.loader import save_random_testbed
from repro_torch.serving.paged_kv import PagedKVPool, PagedSeq
from repro_torch.serving.scheduler import ContinuousScheduler

THRESHOLD = 4.5
BUDGET = 40
N_REQ = 4
KV_BYTES = 1 << 20


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pairs():
    out = []
    for name, seed in (("MICRO", 0), ("MICRO_SMALL", 1)):
        jm = JModel(getattr(jtestbed, name))
        jp = jm.init(jax.random.PRNGKey(seed))
        tp = tckpt.params_from_numpy(jckpt._flatten(jp), device="cpu")
        out.append((JEngine(jm, jp, max_len=1024, fused=False),
                    Engine(Model(getattr(testbed, name)), tp, max_len=1024,
                           fused=False)))
    (jb, tb), (js, ts) = out
    return (jb, js), (tb, ts)


def _tasks():
    rng = random.Random(1)
    return [tasks.sample_task(rng) for _ in range(N_REQ)]


def _port_sched(pairs, temperature=0.0, spec=False, kv_bytes=KV_BYTES,
                loop="fused", **kw):
    _, (tb, ts) = pairs
    cfg = controller.SpecReasonConfig(
        policy=StaticThreshold(THRESHOLD), token_budget=BUDGET,
        sampling=SamplingParams(temperature), use_spec_decode=spec,
        spec_gamma=3, fused_decode=loop == "fused")
    ctrl = controller.SpecReason(tb, ts, cfg)
    kv = tkv.KVManager(tb.model.cfg, ts.model.cfg, tkv.KVBudget(kv_bytes))
    kw.setdefault("prefix_cache", False)
    return ContinuousScheduler(ctrl, kv, max_batch=3, **kw)


def _port_run(pairs, **kw):
    sched = _port_sched(pairs, **kw)
    handles = [sched.submit(t, generator=torch.Generator().manual_seed(i))
               for i, t in enumerate(_tasks())]
    sched.drain()
    return sched, [h.result for h in handles]


def _trace(res):
    return (res.thinking_ids, [int(t) for t in res.answer_ids],
            [(s.source, s.accepted, list(s.tokens)) for s in res.steps],
            res.spec_stats.as_dict())


@pytest.mark.parametrize("loop", ["fused", "eager"])
@pytest.mark.parametrize("temperature,spec", [(0.0, False), (0.8, False),
                                              (0.8, True)])
def test_continuous_matches_sequential_controller(pairs, temperature, spec,
                                                  loop):
    """Inside the port: every request of a continuous run takes the
    sequential controller's tokens from the same generator seed, under
    either decode loop of the batched rows."""
    _, (tb, ts) = pairs
    cfg = controller.SpecReasonConfig(
        policy=StaticThreshold(THRESHOLD), token_budget=BUDGET,
        sampling=SamplingParams(temperature), use_spec_decode=spec,
        spec_gamma=3)
    seq = [controller.SpecReason(tb, ts, cfg).run(
        tasks.question_tokens(t), torch.Generator().manual_seed(i))
        for i, t in enumerate(_tasks())]
    sched, cont = _port_run(pairs, temperature=temperature, spec=spec,
                            loop=loop)
    assert sched.base_be.fused == sched.small_be.fused == (loop == "fused")
    for a, b in zip(cont, seq):
        assert _trace(a) == _trace(b)
        np.testing.assert_allclose([s.utility for s in a.steps],
                                   [s.utility for s in b.steps],
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("loop", ["fused", "eager"])
@pytest.mark.parametrize("temperature,spec", [(0.0, False), (0.8, False),
                                              (0.8, True)])
def test_preempted_run_matches_unpressured_run(pairs, temperature, spec,
                                               loop):
    """A preempted request restarts from its generator's state at first
    admission, so the recompute gives the unpressured tokens, sampled
    too; with spec decode the reservations go through the ledger."""
    tight, tres = _port_run(pairs, temperature=temperature, spec=spec,
                            kv_bytes=60_000, context_capacity=64, loop=loop)
    assert tight.preemptions > 0
    _, free = _port_run(pairs, temperature=temperature, spec=spec,
                        loop=loop)
    assert [_trace(r) for r in tres] == [_trace(r) for r in free]
    assert all(p.num_used == 0 for p in tight.pools.values())


def test_reject_then_redraft_reads_pre_snapshot_kv():
    """A step snapshot shares the row's partial tail block; the draft
    appended after it lands in a copy, so after the rejection the row
    reads the pre-snapshot K/V and a redraft equals a fresh run."""
    m = Model(testbed.SMALL)
    p = m.init(2, device="cpu")
    pool = PagedKVPool(32, 16)
    be = BatchEngine(m, p, batch=2, capacity=256, pool=pool)
    seqs = [PagedSeq(pool), PagedSeq(pool)]
    rows = [be.alloc_row(s) for s in seqs]
    prompt = [int(t) for t in np.random.default_rng(0).integers(10, 38, 37)]
    be.append_seq(seqs[0], 37)
    be.extend_rows([rows[0]], [prompt])
    tail = seqs[0].blocks[-1]
    kept = be.store.k[:, tail].clone()
    snap_row, snap_seq = be.snapshot_row(rows[0]), seqs[0].snapshot()
    be.append_seq(seqs[0], 9)                     # CoW of the shared tail
    assert seqs[0].blocks[2] != tail
    be.generate_rows([rows[0]], 9, [], SamplingParams(1.0),
                     [torch.Generator().manual_seed(3)])
    be.restore_row(rows[0], snap_row)
    seqs[0].restore(snap_seq)
    assert seqs[0].blocks[-1] == tail
    torch.testing.assert_close(be.store.k[:, tail], kept, rtol=0, atol=0)
    redraft = [11, 12, 13, 14, 15]
    be.append_seq(seqs[0], len(redraft))
    be.extend_rows([rows[0]], [redraft])
    be.append_seq(seqs[1], len(prompt) + len(redraft))
    be.extend_rows([rows[1]], [prompt + redraft])
    torch.testing.assert_close(be.last_logits[rows[0]],
                               be.last_logits[rows[1]], rtol=1e-5, atol=1e-5)


def test_left_out_features_raise(pairs, tmp_path):
    with pytest.raises(NotImplementedError, match="prefix cache"):
        _port_sched(pairs, prefix_cache=True)
    with pytest.raises(NotImplementedError, match="deadlines"):
        _port_sched(pairs).submit(_tasks()[0], deadline_s=1.0)
    ckpt = str(tmp_path / "ckpt")
    base = ["--scheduler", "continuous", "--device", "cpu", "--ckpt-dir",
            ckpt]
    for extra, match in ((["--no-prefix-cache", "--num-samples", "2"],
                          "num-samples"),
                         (["--no-prefix-cache", "--tp", "2"], "tp"),
                         (["--no-prefix-cache", "--trace", "t.json"],
                          "trace"),
                         (["--no-prefix-cache", "--degrade"], "degrade"),
                         ([], "prefix cache")):
        with pytest.raises(NotImplementedError, match=match):
            serve.main(base + extra)


def test_serve_continuous_cli_on_cpu_matches_jax_cli(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    save_random_testbed(ckpt, seed=4)
    argv = ["--scheduler", "continuous", "--no-prefix-cache", "-n", "2",
            "--batch", "2", "--budget", "16", "--temperature", "0",
            "--threshold", str(THRESHOLD), "--ckpt-dir", ckpt]
    report = serve.main(argv + ["--device", "cpu", "--meters"])
    ours = capsys.readouterr().out
    assert report.sched.base_be.device.type == "cpu"
    assert report.sched.base_be.fused and report.decode_loop == "fused"
    # fp32 pages at the 2-byte accounting, and the batched decode step's
    # scratch page
    assert report.stats["kv_store_bytes"]["base"] == \
        2 * report.stats["kv_accounted_bytes"]["base"] \
        + report.sched.base_be.store.scratch_bytes > \
        2 * report.stats["kv_accounted_bytes"]["base"]
    jserve.main(argv)
    theirs = capsys.readouterr().out

    def lines(out):
        return [(ln.split("think=")[1].split()[0], ln.split("answer=")[1])
                for ln in out.splitlines() if ln.startswith("[continuous]")]
    assert len(lines(ours)) == 2 and lines(ours) == lines(theirs)
