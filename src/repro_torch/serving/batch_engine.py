"""Multi-sequence batched engine: one model, B ragged rows over a paged KV
store.

The port of the JAX package's ``serving/batch_engine.py``.  Every row
sits at its own context length (``pos`` is a per-row host vector) and
any subset of rows advances together:

  * ``extend_rows``   -- length-bucketed batched extend: each involved
    row's tokens land at its own offset; the attention is
    ``kernels.paged_append_attention`` (span queries over the row's
    committed pages plus the span's own K/V).
  * ``generate_rows`` -- the multi-sequence decode: per-row stop sets,
    budgets and generators, attention ``kernels.paged_decode_attention``.
    It dispatches to the fused loop (``generate_rows_fused``) or to the
    per-token loop (``generate_rows_eager``), by the engine's ``fused``.
  * ``feed_rows``     -- one batched decode step over chosen tokens.

Differences from the JAX package:

  * The rows' KV lives in a ``PagedKVStore`` and each row is bound to a
    ``PagedSeq`` whose block table is the physical layout: a call writes
    the K/V of real tokens only, at ``(table[t // bs], t % bs)``.  The
    pages a call writes must be in the row's table before it runs: a
    standalone engine (no ``pool`` given) owns a pool of ``batch *
    ceil(capacity / block_size)`` blocks and grows its rows' tables
    itself; an engine over a caller's pool (the scheduler) raises if the
    caller did not reserve them.
  * An extend and ``feed_rows`` run the involved rows only, their page
    index built on the host (``kvcache.paged_rows``).  A step of either
    ``generate_rows`` loop runs every one of the ``batch`` row slots at
    once (``kvcache.slot_rows``): block tables of a fixed width,
    ``ceil(capacity / block_size)``, filled once a call into a device
    buffer, and positions and the active mask on the device.  A row
    outside the step is masked: its K/V go to the store's scratch page
    and its logits are thrown away.  So both loops launch the same
    shapes whatever rows they run, and the GEMMs and flash-decode's
    split (``tile_plan.decode_split``, from the row count and the
    table's width) sum a row's terms in one order.
  * ``generate_rows_fused`` is the JAX package's one ``while_loop`` a
    call, rebuilt for a CUDA graph as ``Engine.generate_fused`` is
    (``serving/graph_loop.py`` captures and replays both): a
    body of k masked one-token steps (sample every slot, record the
    active rows' tokens, stop checks, decode the tokens) over static
    buffers -- the tables, positions, budgets, counters, stop sets,
    token and probability buffers, ``last_logits`` and the pages --
    captured once a key (sampling params, probabilities, buffer, stop
    slots, k) and replayed chunk by chunk; the host reads the step index
    and the live row count one chunk behind through pinned memory.  The
    key does not hold the row set, so calls on any rows replay one
    graph.  On the CPU the same body runs eagerly.  A failed capture or
    replay raises; nothing falls back to the per-token loop.
  * ``generate_rows_eager`` is a per-token host loop (one forward, one
    host sync and one sample per token), the specification of the fused
    loop.  The Meter counts one decode call per ``generate_rows`` as the
    JAX package does, the forward passes in ``decode_steps`` (in a fused
    call every step run, masked ones and a capture's warm-up step
    included) and host waits of a fused call in ``decode_syncs``.
  * Random draws come from one ``torch.Generator`` per row (its
    request's), in the order the sequential engine draws them.  The
    fused loop draws from one engine generator per row slot, seeded
    from the row's, and leaves the row's generator where the per-token
    loop would.

Identity with the sequential engine rests on row-independent
arithmetic; the port runs the rows of a call as one batch, so a GEMM
that picks another algorithm for another row count can move a logit by
an ulp (a hazard ROADMAP section 3 watches).
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.kvcache import paged_rows, slot_rows
from ..models.model import Model
from ..sampling.sample import SamplingParams, gumbel, probs_from_logits, \
    sample_rows
from . import graph_loop
from .engine import DEFAULT_BUCKETS, Meter
from .kv_manager import DEFAULT_BLOCK_SIZE
from .paged_kv import PagedKVPool, PagedKVStore, PagedSeq, cdiv


@dataclasses.dataclass
class RowSnapshot:
    """O(1) per-row rollback point: position + the logits at it."""
    pos: int
    last_logits: torch.Tensor          # (V,)


@dataclasses.dataclass
class _RowsLoop:
    """The static buffers of one capture key of the fused rows loop and,
    on the card, the graph that reads and writes them (with the engine's
    block tables, last logits, pages and slot generators)."""
    sp: SamplingParams
    k: int                 # one-token steps a body
    n_slots: int           # stop ids, a multiple of STOP_SLOTS
    # int64: i, live rows, then per slot pos, n_max, n, active, then the
    # stop ids (n_slots, -1 pads) and the (batch, n_slots) stop mask
    ctl: torch.Tensor
    toks: torch.Tensor     # int64 (batch, buf), -1 past each row's count
    probs: Optional[torch.Tensor]   # float32 (batch, buf, V)
    inp: torch.Tensor      # host staging of ctl (pinned on CUDA)
    # pinned host buffers of the card: two slots of (i, live) (look-ahead),
    # the final counters (ctl up to the active mask) and the tokens
    status: Optional[torch.Tensor] = None
    final: Optional[torch.Tensor] = None
    toks_host: Optional[torch.Tensor] = None
    graph: Optional[torch.cuda.CUDAGraph] = None
    # kernel launches a replay runs (``kernels.counts``)
    launches: Optional[Counter] = None


class BatchEngine:
    """One model, ``batch`` independent ragged rows over one paged KV
    store.

    Rows are allocated and freed by the caller (``alloc_row`` /
    ``free_row``); every multi-row method advances only the rows it is
    given.  Rollback of a row's position is O(1) (``snapshot_row`` /
    ``restore_row`` / ``truncate_row``); its block table is rolled back
    by the caller through ``PagedSeq`` (``append_seq`` / ``truncate_seq``
    run the copy-on-write copies the table emits).  ``last_logits``, the
    store's pages and the block-table buffer are written in place only:
    a captured graph holds their addresses."""

    def __init__(self, model: Model, params, batch: int,
                 capacity: int = 1024,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, name: str = "",
                 pad_id: int = 0, pool: Optional[PagedKVPool] = None,
                 fused: Optional[bool] = None):
        """``fused``: the decode loop of ``generate_rows``, the fused
        one unless False."""
        cfg = model.cfg
        if cfg.has_ssm:
            raise ValueError(
                "BatchEngine is attention-only: ragged batched rows rely on "
                "position-masked caches; SSM state would be polluted by "
                "pads.  Serve ssm/hybrid models through the sequential "
                "Engine.")
        if cfg.family != "dense":
            raise NotImplementedError(f"family {cfg.family!r}: the batched "
                                      "engine serves the dense family")
        self.model = model
        self.params = params
        self.device = params["tok_embed"].device
        self.batch = batch
        self.capacity = capacity
        self.buckets = tuple(sorted(b for b in buckets if b <= capacity))
        self.name = name or f"batch-{cfg.name}"
        self.pad_id = pad_id
        self.fused = True if fused is None else fused
        self.meter = Meter()
        self.own_pool = pool is None
        if pool is None:
            pool = PagedKVPool(batch * cdiv(capacity, DEFAULT_BLOCK_SIZE),
                               DEFAULT_BLOCK_SIZE)
        self.pool = pool
        self.store = PagedKVStore(pool, cfg.n_layers, cfg.n_kv_heads,
                                  cfg.resolved_head_dim, self.device,
                                  params["tok_embed"].dtype)
        self.pos = np.zeros(batch, np.int64)
        self.last_logits = torch.zeros((batch, cfg.vocab_size),
                                       dtype=torch.float32,
                                       device=self.device)
        self.seqs: List[Optional[PagedSeq]] = [None] * batch
        self._free = list(range(batch - 1, -1, -1))
        self._live = [False] * batch
        # every slot's block table at a fixed width, padded with the
        # scratch page (``_fill_tables``)
        self._tables = torch.full(
            (batch, cdiv(capacity, pool.block_size)),
            self.store.scratch_page, dtype=torch.int32, device=self.device)
        self._loops = {}
        self._slot_gens: Optional[List[torch.Generator]] = None
        self.captures = 0          # CUDA graphs captured
        self.capture_time = 0.0    # seconds spent capturing them

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- rows
    def alloc_row(self, seq: Optional[PagedSeq] = None) -> Optional[int]:
        """Claim a fresh row at position 0 bound to ``seq`` (a new
        sequence on the engine's own pool when None); None when all rows
        are live."""
        if not self._free:
            return None
        if seq is None:
            if not self.own_pool:
                raise ValueError("an engine over a caller's pool needs the "
                                 "caller's PagedSeq for each row")
            seq = PagedSeq(self.pool)
        if seq.pool is not self.pool:
            raise ValueError("the row's sequence must live on the engine's "
                             "pool")
        r = self._free.pop()
        self._live[r] = True
        self.pos[r] = 0
        self.last_logits[r] = 0.0
        self.seqs[r] = seq
        return r

    def free_row(self, row: int) -> None:
        """Return a live row to the free list; an engine that owns its
        pool also frees the row's blocks (a caller's pool is the
        caller's to free)."""
        assert self._live[row], f"free of dead row {row}"
        if self.own_pool:
            self.seqs[row].free()
        self._live[row] = False
        self.pos[row] = 0
        self.seqs[row] = None
        self._free.append(row)

    @property
    def free_rows(self) -> int:
        return len(self._free)

    def snapshot_row(self, row: int) -> RowSnapshot:
        return RowSnapshot(int(self.pos[row]),
                           self.last_logits[row].clone())

    def restore_row(self, row: int, snap: RowSnapshot) -> None:
        """Reset the position and its logits (the block table is the
        caller's to restore)."""
        assert snap.pos <= self.pos[row]
        self.pos[row] = snap.pos
        self.last_logits[row] = snap.last_logits

    def truncate_row(self, row: int, pos: int) -> None:
        """Position-only truncate (the spec-decode rollback); the row's
        last_logits become stale until a feed or an extend refreshes
        them."""
        assert self._live[row], f"truncate of dead row {row}"
        assert 0 <= pos <= self.pos[row], \
            f"row {row}: truncate to {pos} above position {self.pos[row]}"
        self.pos[row] = pos

    # ------------------------------------------------------ block tables
    def append_seq(self, seq: PagedSeq, n_tokens: int) -> None:
        """``seq.append`` plus the page copies it emits (may raise
        ``PoolExhausted``, with the table unchanged)."""
        _, copies = seq.append(n_tokens)
        self.store.apply_copies(copies)

    def truncate_seq(self, seq: PagedSeq, length: int) -> None:
        """``seq.truncate`` plus the page copy it emits when the kept
        tail block is shared."""
        _, copies = seq.truncate(length)
        self.store.apply_copies(copies)

    def _cover(self, row: int, end: int) -> None:
        """Make the row's table cover tokens [0, end) before a write."""
        seq = self.seqs[row]
        if seq.length >= end:
            return
        if not self.own_pool:
            raise RuntimeError(
                f"{self.name} row {row}: pages for tokens up to {end} are "
                f"not reserved (the table covers {seq.length})")
        self.append_seq(seq, end - seq.length)

    def _fill_tables(self) -> None:
        """Write every live row's block table into the fixed-width device
        buffer (one copy), free slots and padding as the scratch page."""
        tab = np.full(tuple(self._tables.shape), self.store.scratch_page,
                      np.int32)
        for r, seq in enumerate(self.seqs):
            if seq is not None:
                if len(seq.blocks) > tab.shape[1]:
                    raise RuntimeError(
                        f"{self.name} row {r}: {len(seq.blocks)} blocks, "
                        f"beyond the capacity's {tab.shape[1]}")
                tab[r, :len(seq.blocks)] = seq.blocks
        self._tables.copy_(torch.from_numpy(tab))

    # ---------------------------------------------------------- helpers
    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"extend of {n} tokens exceeds bucket max "
                         f"{self.buckets[-1]}")

    def _view(self, rows: Sequence[int], counts: Sequence[int], width: int):
        return paged_rows(self.store.k, self.store.v,
                          [self.seqs[r].blocks for r in rows],
                          [int(self.pos[r]) for r in rows], counts, width)

    def _slots(self, pos: torch.Tensor, active: torch.Tensor):
        return slot_rows(self.store.k, self.store.v, self._tables, pos,
                         active, self.store.scratch_page)

    def _decode(self, rows: Sequence[int],
                tokens: torch.Tensor) -> torch.Tensor:
        """One step of the per-token loop, over every row slot:
        ``tokens[i]`` at row ``rows[i]``'s position, the other slots
        masked.  Returns (len(rows), V) logits.  The rows' pages must be
        covered and the tables filled; positions are not advanced
        here."""
        dev = self.device
        idx = torch.tensor(list(rows), dtype=torch.long, device=dev)
        toks = torch.full((self.batch,), self.pad_id, dtype=torch.long,
                          device=dev)
        toks[idx] = tokens
        active = torch.zeros(self.batch, dtype=torch.bool)
        active[list(rows)] = True
        view = self._slots(torch.from_numpy(self.pos).to(dev),
                           active.to(dev))
        self.meter.decode_steps += 1
        return self.model.decode_rows(self.params, toks[:, None], view)[idx]

    # ------------------------------------------------------------ extend
    def extend_rows(self, rows: Sequence[int],
                    token_lists: Sequence[Sequence[int]],
                    want_logits: bool = False
                    ) -> Optional[List[torch.Tensor]]:
        """Length-bucketed batched extend: append ``token_lists[i]`` to row
        ``rows[i]``, all involved rows in one forward.  With
        ``want_logits`` returns each row's (n_i, V) logits."""
        assert len(rows) == len(token_lists)
        lens = [len(t) for t in token_lists]
        if not rows or max(lens, default=0) == 0:
            return [self.last_logits[:0] for _ in rows] \
                if want_logits else None
        bucket = self._bucket(max(lens))
        for r, n in zip(rows, lens):
            assert self._live[r], f"extend of dead row {r}"
            if self.pos[r] + n > self.capacity:
                raise ValueError(f"row {r} context overflow: "
                                 f"{self.pos[r]}+{n} > {self.capacity}")
            self._cover(r, int(self.pos[r]) + n)
        toks = torch.full((len(rows), bucket), self.pad_id, dtype=torch.long)
        for i, t in enumerate(token_lists):
            toks[i, :len(t)] = torch.tensor(list(t), dtype=torch.long)
        toks = toks.to(self.device)
        t0 = time.perf_counter()
        logits = self.model.prefill_rows(self.params, toks,
                                         self._view(rows, lens, bucket))
        self._sync()
        self.meter.prefill_time += time.perf_counter() - t0
        self.meter.prefill_tokens += bucket * len(rows)
        self.meter.prefill_calls += 1
        out = []
        for i, (r, n) in enumerate(zip(rows, lens)):
            self.pos[r] += n
            if n > 0:
                self.last_logits[r] = logits[i, n - 1]
            if want_logits:
                out.append(logits[i, :n])
        return out if want_logits else None

    def prefill_rows(self, rows: Sequence[int],
                     chunks: Sequence[Sequence[int]],
                     starts: Sequence[int],
                     want_logits: bool = False
                     ) -> Optional[List[torch.Tensor]]:
        """Multi-row chunked prefill: ``chunks[i]`` continues row
        ``rows[i]`` at its prefill cursor ``starts[i]``, which must be the
        row's position."""
        assert len(rows) == len(chunks) == len(starts)
        for r, s in zip(rows, starts):
            assert self._live[r], f"chunked prefill into dead row {r}"
            assert self.pos[r] == s, \
                f"row {r}: chunk declared at offset {s} but the row " \
                f"sits at {self.pos[r]} -- prefill cursor out of sync"
        return self.extend_rows(rows, chunks, want_logits)

    # ---------------------------------------------------------- generate
    def generate_rows(self, rows: Sequence[int], max_tokens,
                      stop_ids: Sequence[int], params: SamplingParams,
                      generators: Sequence[torch.Generator],
                      stop_ids_rows: Optional[Sequence[Sequence[int]]] = None,
                      collect_probs: bool = False):
        """Decode every row in ``rows`` until its own stop id or budget.
        ``max_tokens`` is an int or a per-row list (each clamped to the
        row's free capacity); ``generators`` one per row (row i draws
        exactly what the sequential engine draws from it);
        ``stop_ids_rows`` gives each row its own stop set (``stop_ids`` is
        then ignored).  Generated ids (a stop id included) are fed back.
        With ``collect_probs`` also returns each row's (n_i, V) sampling
        distributions.  The engine's ``fused`` picks the loop."""
        loop = self.generate_rows_fused if self.fused \
            else self.generate_rows_eager
        return loop(rows, max_tokens, stop_ids, params, generators,
                    stop_ids_rows, collect_probs)

    def _call_plan(self, rows, max_tokens, stop_ids, generators,
                   stop_ids_rows):
        """(per-row budgets clamped to capacity, per-row stop sets)."""
        budgets = list(max_tokens) if not isinstance(max_tokens, int) \
            else [max_tokens] * len(rows)
        assert len(budgets) == len(rows) == len(generators)
        stops = [set(int(s) for s in (stop_ids_rows[i]
                                      if stop_ids_rows is not None
                                      else stop_ids))
                 for i in range(len(rows))]
        n_max = [max(min(m, self.capacity - int(self.pos[r])), 0)
                 for r, m in zip(rows, budgets)]
        for r, n in zip(rows, n_max):
            if n > 0:
                self._cover(r, int(self.pos[r]) + n)
        return n_max, stops

    def generate_rows_eager(self, rows: Sequence[int], max_tokens,
                            stop_ids: Sequence[int], params: SamplingParams,
                            generators: Sequence[torch.Generator],
                            stop_ids_rows: Optional[
                                Sequence[Sequence[int]]] = None,
                            collect_probs: bool = False):
        """The per-token loop: one forward over the row slots, one host
        sync and one sample per token, until every row hits its stop id
        or budget.  The specification of ``generate_rows_fused``."""
        if not rows:
            return ([], []) if collect_probs else []
        n_max, stops = self._call_plan(rows, max_tokens, stop_ids,
                                       generators, stop_ids_rows)
        out: List[List[int]] = [[] for _ in rows]
        probs: List[List[torch.Tensor]] = [[] for _ in rows]
        active = [i for i in range(len(rows)) if n_max[i] > 0]
        self._fill_tables()
        t0 = time.perf_counter()
        calls = 0
        while active:
            idx = [rows[i] for i in active]
            logits = self.last_logits[idx]
            toks = sample_rows(logits, params,
                               [generators[i] for i in active])
            if collect_probs:
                p = probs_from_logits(logits, params)
                for j, i in enumerate(active):
                    probs[i].append(p[j])
            new_logits = self._decode(idx, toks)
            calls += 1
            for i, tok in zip(active, toks.tolist()):
                out[i].append(tok)
                self.pos[rows[i]] += 1
            self.last_logits[idx] = new_logits.float()
            active = [i for i in active
                      if out[i][-1] not in stops[i]
                      and len(out[i]) < n_max[i]]
        if calls:
            self._sync()
            self.meter.decode_time += time.perf_counter() - t0
            self.meter.decode_tokens += sum(len(o) for o in out)
            self.meter.decode_calls += 1
        if not collect_probs:
            return out
        vocab = self.last_logits.shape[1]
        return out, [torch.stack(p) if p else self.last_logits.new_zeros(
            (0, vocab)) for p in probs]

    def generate_rows_fused(self, rows: Sequence[int], max_tokens,
                            stop_ids: Sequence[int], params: SamplingParams,
                            generators: Sequence[torch.Generator],
                            stop_ids_rows: Optional[
                                Sequence[Sequence[int]]] = None,
                            collect_probs: bool = False):
        """The fused loop (module docstring): what ``generate_rows_eager``
        gives -- tokens, probabilities, positions, last logits and each
        row's generator -- from chunks of masked one-token steps over
        every row slot, replayed as a CUDA graph on the card.  Metered as
        one decode call of the rows' tokens; ``decode_steps`` counts
        every step run, masked ones included."""
        if not rows:
            return ([], []) if collect_probs else []
        n_max, stops = self._call_plan(rows, max_tokens, stop_ids,
                                       generators, stop_ids_rows)
        top = max(n_max)
        if top == 0:         # every row at its capacity: as the eager loop
            return self.generate_rows_eager(rows, 0, [], params, generators,
                                            None, collect_probs)
        b = self.batch
        stop = sorted(set().union(*stops))
        n_slots = graph_loop.stop_slots(len(stop))
        k = graph_loop.chunk_steps(top)
        t0 = time.perf_counter()
        loop = self._rows_loop(params, collect_probs,
                               graph_loop.decode_buf(top), n_slots, k)
        # the call's inputs: one copy of ctl (the layout of _RowsLoop.ctl)
        ctl = np.zeros((2 + 4 * b + n_slots + b * n_slots,), np.int64)
        ctl[2:2 + b] = self.pos
        mask = np.zeros((b, n_slots), np.int64)
        for r, n, st in zip(rows, n_max, stops):
            ctl[2 + b + r] = n
            ctl[2 + 3 * b + r] = n > 0
            mask[r, :len(stop)] = [s in st for s in stop]
        ctl[2 + 4 * b:2 + 4 * b + len(stop)] = stop
        ctl[2 + 4 * b + len(stop):2 + 4 * b + n_slots] = -1
        ctl[2 + 4 * b + n_slots:] = mask.reshape(-1)
        loop.inp.copy_(torch.from_numpy(ctl))
        loop.ctl.copy_(loop.inp, non_blocking=True)
        loop.toks.fill_(-1)
        self._fill_tables()
        gens = self._slot_generators()
        sampled = params.temperature > 0.0
        cuda = loop.graph is not None
        start = {}          # each row's generator offset (the card)
        for r, g in zip(rows, generators if sampled else []):
            if cuda:
                start[r] = g.get_offset()
                gens[r].manual_seed(g.initial_seed())
                gens[r].set_offset(start[r])
            else:
                gens[r].set_state(g.get_state())
        if cuda:
            chunks = self._replay(loop, top)
            final, toks = loop.final, loop.toks_host
        else:                          # the CPU: the body, eagerly
            chunks = 0
            while True:
                self._rows_steps(loop, gens, k)
                chunks += 1
                if int(loop.ctl[1]) == 0:
                    break
            final, toks = loop.ctl, loop.toks
        pos_dev = final[2:2 + b].tolist()
        n = final[2 + 2 * b:2 + 3 * b].tolist()
        out = []
        for r, g in zip(rows, generators):
            out.append(toks[r, :n[r]].tolist())
            self.pos[r] += n[r]
            if self.pos[r] != pos_dev[r]:
                raise RuntimeError(f"{self.name} row {r}: the fused loop's "
                                   f"position {pos_dev[r]} != {self.pos[r]}")
            if not sampled:
                continue
            if cuda:
                per_step = (gens[r].get_offset() - start[r]) // (chunks * k)
                g.set_offset(start[r] + n[r] * per_step)
            else:          # the per-token loop draws once a token
                for _ in range(n[r]):
                    gumbel(self.last_logits.shape[-1:], g, "cpu")
        self.meter.decode_time += time.perf_counter() - t0
        self.meter.decode_tokens += sum(n[r] for r in rows)
        self.meter.decode_calls += 1
        self.meter.decode_steps += chunks * k
        if not collect_probs:
            return out
        return out, [loop.probs[r, :n[r]].clone() for r in rows]

    def _slot_generators(self) -> List[torch.Generator]:
        """One generator a row slot, on the engine's device: the fused
        loop's noise, seeded from the rows' own generators each call."""
        if self._slot_gens is None:
            self._slot_gens = [torch.Generator(device=self.device)
                               for _ in range(self.batch)]
        return self._slot_gens

    def _rows_loop(self, sp: SamplingParams, collect_probs: bool, buf: int,
                   n_slots: int, k: int) -> _RowsLoop:
        """The static buffers (and on the card the captured graph) of one
        key.  The tables, pages and last logits are the engine's, so the
        key holds neither them nor the call's rows."""
        key = (sp, collect_probs, buf, n_slots, k)
        loop = self._loops.get(key)
        if loop is not None:
            return loop
        dev, b = self.device, self.batch
        vocab = self.last_logits.shape[1]
        cuda = dev.type == "cuda"
        size = 2 + 4 * b + n_slots + b * n_slots
        loop = _RowsLoop(
            sp=sp, k=k, n_slots=n_slots,
            ctl=torch.zeros(size, dtype=torch.long, device=dev),
            toks=torch.full((b, buf), -1, dtype=torch.long, device=dev),
            probs=torch.zeros((b, buf, vocab), device=dev)
            if collect_probs else None,
            inp=torch.zeros(size, dtype=torch.long, pin_memory=cuda))
        if cuda:
            self._capture(loop)
        self._loops[key] = loop
        return loop

    def _rows_steps(self, loop: _RowsLoop, gens: Sequence[torch.Generator],
                    steps: int) -> None:
        """``steps`` one-token steps over every row slot, each masked by
        the slot's ``active``: sample from the last logits, record the
        active rows' tokens (and probabilities) at the shared step index
        ``i``, stop checks, then decode the tokens (a stop token joins the
        context); a row stays active while ``i + 1 < n_max`` and no stop
        id of its own came.  Ends by counting the live rows.  Reads
        nothing back to the host: the graph records exactly this."""
        b = self.batch
        ctl = loop.ctl
        i, live = ctl[0], ctl[1]
        pos, n_max, n, act = ctl[2:2 + 4 * b].view(4, b)
        stop = ctl[2 + 4 * b:2 + 4 * b + loop.n_slots]
        mask = ctl[2 + 4 * b + loop.n_slots:].view(b, loop.n_slots).bool()
        last = loop.toks.shape[1] - 1
        logits = self.last_logits
        for _ in range(steps):
            active = act.bool()
            tok = sample_rows(logits, loop.sp, gens)
            slot = i.clamp(max=last).reshape(1)
            if loop.probs is not None:
                p = probs_from_logits(logits, loop.sp)[:, None]
                loop.probs.index_copy_(1, slot, torch.where(
                    active[:, None, None], p,
                    loop.probs.index_select(1, slot)))
            loop.toks.index_copy_(1, slot, torch.where(
                active[:, None], tok[:, None],
                loop.toks.index_select(1, slot)))
            n.add_(act)
            hit = ((tok[:, None] == stop) & mask).any(-1)
            new = self.model.decode_rows(self.params, tok[:, None],
                                         self._slots(pos, active))
            logits.copy_(torch.where(active[:, None], new.float(), logits))
            pos.add_(act)
            act.copy_(active & ~hit & (i + 1 < n_max))
            i.add_(1)
        live.copy_(act.sum())

    def _capture(self, loop: _RowsLoop) -> None:
        """Capture a body of ``loop.k`` steps (``graph_loop.capture``),
        every slot generator registered with it; its warm-up step runs
        with every slot masked (the buffers are zero)."""
        t0 = time.perf_counter()
        gens = self._slot_generators()
        loop.graph, loop.launches = graph_loop.capture(
            self.device, lambda n: self._rows_steps(loop, gens, n), loop.k,
            gens)
        self.meter.decode_steps += 1
        loop.status = torch.zeros((2, 2), dtype=torch.long, pin_memory=True)
        loop.final = torch.zeros(2 + 4 * self.batch, dtype=torch.long,
                                 pin_memory=True)
        loop.toks_host = torch.empty_like(loop.toks, device="cpu",
                                          pin_memory=True)
        self.captures += 1
        self.capture_time += time.perf_counter() - t0

    def _replay(self, loop: _RowsLoop, top: int) -> int:
        """Replay chunks until one reports no live row or the largest
        budget is spent (``graph_loop.replay``), then read the final
        counters and the tokens into ``loop.final`` and
        ``loop.toks_host``.  Returns the chunks replayed."""
        chunks, waits = graph_loop.replay(
            self.device, loop.graph, loop.launches, loop.ctl[:2],
            loop.status, -(-top // loop.k), lambda st: int(st[1]) == 0,
            [(loop.toks_host, loop.toks),
             (loop.final, loop.ctl[:loop.final.numel()])])
        self.meter.decode_syncs += waits
        return chunks

    # -------------------------------------------------------------- feed
    def feed_rows(self, rows: Sequence[int],
                  tokens: Sequence[int]) -> None:
        """Append ``tokens[i]`` to row ``rows[i]`` with one batched decode
        step over these rows only (the multi-row ``Engine.decode_one``),
        refreshing last_logits."""
        assert len(rows) == len(tokens)
        if not rows:
            return
        assert all(self.pos[r] < self.capacity for r in rows), \
            "feed would write past capacity; truncate or preempt first"
        for r in rows:
            self._cover(r, int(self.pos[r]) + 1)
        t0 = time.perf_counter()
        toks = torch.tensor(list(tokens), dtype=torch.long,
                            device=self.device)
        self.meter.decode_steps += 1
        logits = self.model.decode_rows(
            self.params, toks[:, None],
            self._view(rows, [1] * len(rows), 1))
        self._sync()
        self.meter.decode_time += time.perf_counter() - t0
        self.meter.decode_tokens += len(rows)
        self.meter.decode_calls += 1
        for r in rows:
            self.pos[r] += 1
        self.last_logits[list(rows)] = logits.float()

    def kv_dims(self) -> Tuple[int, int, int]:
        """(n_layers, kv_heads, head_dim) of the attention cache."""
        ll, _, kh, _, hd = self.store.k.shape
        return ll, kh, hd
