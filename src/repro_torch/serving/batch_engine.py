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
    budgets and generators; one batched forward per token over the rows
    still running, attention ``kernels.paged_decode_attention``.
  * ``feed_rows``     -- one batched decode step over chosen tokens.

Differences from the JAX package:

  * The rows' KV lives in a ``PagedKVStore`` and each row is bound to a
    ``PagedSeq`` whose block table is the physical layout: a call writes
    the K/V of real tokens only, at ``(table[t // bs], t % bs)``.  Pads
    and uninvolved rows write nothing, and only the involved rows enter
    a call's forward.  The pages a call writes must be in the row's
    table before it runs: a standalone engine (no ``pool`` given) owns a
    pool of ``batch * ceil(capacity / block_size)`` blocks and grows its
    rows' tables itself; an engine over a caller's pool (the scheduler)
    raises if the caller did not reserve them.
  * ``generate_rows`` is a per-token host loop (one forward, one host
    sync and one sample per token), like the port's sequential
    ``Engine.generate``.  The Meter counts one decode call per
    ``generate_rows`` as the JAX package does, and the forward passes in
    ``decode_steps``.
  * Random draws come from one ``torch.Generator`` per row (its
    request's), in the order the sequential engine draws them.

Identity with the sequential engine rests on row-independent
arithmetic; the port runs the rows of a call as one batch, so a GEMM
that picks another algorithm for another row count can move a logit by
an ulp (the hazard in ROADMAP queue 1, item 5).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.kvcache import paged_rows
from ..models.model import Model
from ..sampling.sample import SamplingParams, probs_from_logits, sample_rows
from .engine import DEFAULT_BUCKETS, Meter
from .kv_manager import DEFAULT_BLOCK_SIZE
from .paged_kv import PagedKVPool, PagedKVStore, PagedSeq, cdiv


@dataclasses.dataclass
class RowSnapshot:
    """O(1) per-row rollback point: position + the logits at it."""
    pos: int
    last_logits: torch.Tensor          # (V,)


class BatchEngine:
    """One model, ``batch`` independent ragged rows over one paged KV
    store.

    Rows are allocated and freed by the caller (``alloc_row`` /
    ``free_row``); every multi-row method advances only the rows it is
    given.  Rollback of a row's position is O(1) (``snapshot_row`` /
    ``restore_row`` / ``truncate_row``); its block table is rolled back
    by the caller through ``PagedSeq`` (``append_seq`` / ``truncate_seq``
    run the copy-on-write copies the table emits)."""

    def __init__(self, model: Model, params, batch: int,
                 capacity: int = 1024,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, name: str = "",
                 pad_id: int = 0, pool: Optional[PagedKVPool] = None):
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

    def _decode(self, rows: Sequence[int],
                tokens: torch.Tensor) -> torch.Tensor:
        """One batched forward: ``tokens[i]`` at row ``rows[i]``'s
        position; returns (len(rows), V) logits.  Positions are not
        advanced here."""
        for r in rows:
            self._cover(r, int(self.pos[r]) + 1)
        view = self._view(rows, [1] * len(rows), 1)
        self.meter.decode_steps += 1
        return self.model.decode_rows(self.params, tokens[:, None], view)

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
        """Decode every row in ``rows`` until its own stop id or budget:
        one batched forward per token over the rows still running.
        ``max_tokens`` is an int or a per-row list; ``generators`` one per
        row (row i draws exactly what the sequential engine draws from
        it); ``stop_ids_rows`` gives each row its own stop set
        (``stop_ids`` is then ignored).  Generated ids (a stop id
        included) are fed back.  With ``collect_probs`` also returns each
        row's (n_i, V) sampling distributions."""
        if not rows:
            return ([], []) if collect_probs else []
        budgets = list(max_tokens) if not isinstance(max_tokens, int) \
            else [max_tokens] * len(rows)
        assert len(budgets) == len(rows) == len(generators)
        stops = [set(int(s) for s in (stop_ids_rows[i]
                                      if stop_ids_rows is not None
                                      else stop_ids))
                 for i in range(len(rows))]
        n_max = [max(min(m, self.capacity - int(self.pos[r])), 0)
                 for r, m in zip(rows, budgets)]
        out: List[List[int]] = [[] for _ in rows]
        probs: List[List[torch.Tensor]] = [[] for _ in rows]
        active = [i for i in range(len(rows)) if n_max[i] > 0]
        for i in active:
            self._cover(rows[i], int(self.pos[rows[i]]) + n_max[i])
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

    # -------------------------------------------------------------- feed
    def feed_rows(self, rows: Sequence[int],
                  tokens: Sequence[int]) -> None:
        """Append ``tokens[i]`` to row ``rows[i]`` with one batched decode
        step (the multi-row ``Engine.decode_one``), refreshing
        last_logits."""
        assert len(rows) == len(tokens)
        if not rows:
            return
        assert all(self.pos[r] < self.capacity for r in rows), \
            "feed would write past capacity; truncate or preempt first"
        t0 = time.perf_counter()
        logits = self._decode(list(rows), torch.tensor(
            list(tokens), dtype=torch.long, device=self.device))
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
