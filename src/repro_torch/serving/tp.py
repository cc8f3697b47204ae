"""Exact tensor-parallel serving on ``torch.distributed``: the port of
the JAX package's ``serving/tp.py``.

The JAX package runs one process over a mesh and lets GSPMD place the
arrays.  The port runs SPMD: ``tp_size`` rank processes, each running
the same ``ContinuousScheduler`` on replicated host state (admission,
block tables, free lists, refcounts, sampling draws) and holding on its
own device its shard of each model's weights (``models/sharding.py``)
and its kv-head slice of every page store.  A rank computes its query
and kv heads' attention (``kernels/paged_tp.py``) and its slice of the
ffn hidden, and all-gathers activations at exactly two places a layer:
the heads before the output projection (``gather_heads``) and the hidden
before the down projection (``gather_hidden``).  Every contraction then
runs on whole operands, so each rank holds tp=1's activations at every
layer boundary and its logits are replicated.

A column slice of a GEMM may pick another algorithm than the whole
product (cuBLAS chooses from N) and a kernel's split over keys is
planned from the heads it runs, so tp=N's logits are tp=1's to a stated
tolerance, bitwise where the libraries keep the order.  The ranks agree
with each other bit for bit: they run the same code on the same inputs.

``TPContext`` carries the rank, the degree, the group and the device,
and is shared by both engines, both page stores and both prefix caches
of a scheduler.  ``run_ranks`` starts the rank processes.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..launch.mesh import make_tp_group, rank_device
from ..models.model import flatten, unflatten
from ..models.sharding import local_shape, shard_params


@dataclasses.dataclass
class TPContext:
    """One rank's view of a tensor-parallel group.  ``group`` None is
    the default group; a context built without ``build`` (no group yet)
    serves the checks only, and its collectives raise."""
    rank: int
    tp_size: int
    device: torch.device
    backend: str = "gloo"
    devices: Sequence[str] = ()
    group: Optional[Any] = None
    gathers: int = 0            # all-gathers run
    gather_s: float = 0.0       # host seconds inside them (see _gather)
    broadcasts: int = 0         # rank 0's host decisions sent (broadcast)

    @classmethod
    def build(cls, tp_size: int, rank: int, init_method: str,
              device: torch.device) -> "TPContext":
        """Join the group (``launch.mesh.make_tp_group``)."""
        backend, names = make_tp_group(tp_size, rank, init_method, device)
        return cls(rank, tp_size, device, backend, tuple(names))

    # -------------------------------------------------------- validation
    def check_model(self, cfg) -> None:
        """Refuse a model the exact split cannot serve: another family
        than dense (windowed or not), or a degree that does not divide
        the heads, the kv heads or the ffn hidden."""
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: tensor parallelism serves the dense family, "
                f"not {cfg.family!r}"
                + (": the experts' split (expert parallelism) is ROADMAP "
                   "queue 1 item 8's later work" if cfg.family == "moe"
                   else ""))
        for name, val in (("n_heads", cfg.n_heads),
                          ("n_kv_heads", cfg.n_kv_heads)):
            if val % self.tp_size != 0:
                raise ValueError(
                    f"tp_size={self.tp_size} must divide {name}={val} "
                    f"({cfg.name}): the head_dim sharding fallback would "
                    f"split a contraction dim and break the bit-exact TP "
                    f"contract")
        if cfg.d_ff % self.tp_size:
            raise ValueError(f"tp_size={self.tp_size} must divide "
                             f"d_ff={cfg.d_ff} ({cfg.name})")

    # --------------------------------------------------------- placement
    def local_heads(self, n: int) -> slice:
        """This rank's contiguous slice of ``n`` heads (query or kv)."""
        k = n // self.tp_size
        return slice(self.rank * k, (self.rank + 1) * k)

    def shard_params(self, model, params) -> Dict:
        """This rank's shard of ``params`` on the rank's device.  A whole
        tree is sliced (``models.sharding.shard_params``); a tree whose
        sliced tensors already have the local shapes (a loader that drew
        only this rank's slices) is taken as it is; anything else
        raises."""
        flat = flatten(params)
        spec = model.spec()
        if set(flat) != set(spec):
            raise ValueError(f"{model.cfg.name}: the parameters' keys are "
                             "not the model's")
        whole = {k: tuple(s.shape) for k, s in spec.items()}
        local = {k: local_shape(k, s, self.tp_size)
                 for k, s in whole.items()}
        shapes = {k: tuple(v.shape) for k, v in flat.items()}
        if shapes == whole:
            flat = flatten(shard_params(params, self.rank, self.tp_size))
        elif shapes != local:
            raise ValueError(f"{model.cfg.name}: parameters are neither "
                             f"whole nor a {self.tp_size}-way shard")
        return unflatten({k: v.to(self.device) for k, v in flat.items()})

    def shard_state(self, k: torch.Tensor) -> torch.Tensor:
        """This rank's kv heads of a (L, B, C, K, hd) decode-state cache,
        as a contiguous copy (a page store allocates only its own)."""
        return k[..., self.local_heads(k.shape[-2]), :].contiguous()

    # ------------------------------------------------------- collectives
    def _gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x``, concatenated on ``dim`` in rank order.
        Under gloo the host first waits for the card (gloo's copy to the
        host waits for it anyway), so ``gather_s`` holds the exchange
        alone."""
        if self.tp_size == 1:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.tp_size)]
        if x.is_cuda and self.backend == "gloo":
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        dist.all_gather(parts, x, group=self.group)
        self.gather_s += time.perf_counter() - t0
        self.gathers += 1
        return torch.cat(parts, dim=dim)

    def gather_heads(self, x: torch.Tensor) -> torch.Tensor:
        """(..., H / tp, hd) per rank -> (..., H, hd) on every rank."""
        return self._gather(x, x.dim() - 2)

    def gather_hidden(self, x: torch.Tensor) -> torch.Tensor:
        """(..., ff / tp) per rank -> (..., ff) on every rank."""
        return self._gather(x, x.dim() - 1)

    def broadcast(self, obj):
        """Rank 0's ``obj`` on every rank (a decision that reads a clock
        is taken on rank 0)."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group)
        self.broadcasts += 1
        return box[0]

    def all_objects(self, obj) -> List:
        """Every rank's ``obj``, in rank order."""
        out: List = [None] * self.tp_size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    # ----------------------------------------------------- observability
    def describe(self) -> Dict[str, Any]:
        """The reference's mesh section: axes, degree, devices."""
        return {"axes": {"model": self.tp_size}, "tp_size": self.tp_size,
                "devices": list(self.devices)}


def _rank_main(rank: int, tp_size: int, init_method: str, device: str,
               threads: Optional[int], fn: Callable, args: tuple,
               results) -> None:
    """One rank process: build the context, run ``fn(tp, *args)``, put
    (rank, ok, result or traceback) on ``results``."""
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = rank_device(rank, tp_size, device)
        tp = TPContext.build(tp_size, rank, init_method, dev)
        try:
            out = fn(tp, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:          # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(tp_size: int, device: str, fn: Callable, args: tuple = (),
              timeout_s: Optional[float] = None,
              threads: Optional[int] = None,
              store_dir: Optional[str] = None) -> List[Any]:
    """Run ``fn(tp, *args)`` in ``tp_size`` rank processes (spawned, never
    forked) joined by a process group on a ``FileStore`` in a fresh
    directory under ``store_dir`` (the temporary directory when None),
    each rank on ``mesh.rank_device`` with ``threads`` torch threads
    (None: torch's default).  ``fn`` must be importable by name.
    Returns the ranks' results in rank order; raises when a rank raises
    or dies, or when the ranks take longer than ``timeout_s`` (None: no
    limit; a rank stuck in a collective raises after the group's
    timeout), after stopping every rank."""
    ctx = mp.get_context("spawn")
    # a fresh directory a call: a FileStore file that a killed group left
    # behind would hold its stale keys
    store_dir = tempfile.mkdtemp(prefix="tp-store-", dir=store_dir)
    init = "file://" + os.path.join(store_dir, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, tp_size, init, device, threads, fn, args,
                               results), name=f"tp-rank-{r}")
             for r in range(tp_size)]
    for p in procs:
        p.start()
    out: Dict[int, Any] = {}
    errors: List[str] = []
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while len(out) + len(errors) < tp_size:
            try:
                rank, ok, res = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.name for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    errors.append(f"{dead} exited without a result")
                    break
                if deadline is not None and time.monotonic() > deadline:
                    errors.append(f"ranks still running after {timeout_s} s")
                    break
                continue
            if ok:
                out[rank] = res
            else:
                errors.append(f"rank {rank}:\n{res}")
                break
        for p in procs:                 # each has put its result
            p.join(timeout=5.0 if errors else 60.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        shutil.rmtree(store_dir, ignore_errors=True)
    if errors:
        raise RuntimeError("tensor-parallel ranks failed: "
                           + "\n".join(errors))
    return [out[r] for r in range(tp_size)]
