"""Paged KV: a block-pool allocator with per-sequence block tables, a
free-list, refcounted copy-on-write snapshots, and the physical page
store the port's batched attention reads.

The accounting (``PagedKVPool``, ``PagedSeq``, ``BlockTableSnapshot``,
``pad_block_tables``) is a copy of the JAX package's numpy code, so the
two packages take the same allocation, CoW and rollback decisions.

Where the JAX package's batched rows are dense slabs and its pools only
do the accounting, here the pool's block tables ARE the physical layout:
``PagedKVStore`` holds ``(L, P, K, block_size, head_dim)`` pages on the
engine's device, every batched forward writes its K/V through a row's
block table, and the paged attention kernels (``kernels.
paged_decode_attention``, ``kernels.paged_append_attention``) read them
through the same tables.  So every ``(src, dst)`` copy that
``PagedSeq.append`` / ``truncate`` emits must run on the store
(``apply_copies``) before the next write into ``dst``.

Layers:
  PagedKVPool   block ids + free-list + refcounts (pure accounting)
  PagedSeq      one sequence's block table over a pool (CoW append/rollback)
  PagedKVStore  the physical pages; indexed writes, CoW copies, gathers
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class PoolExhausted(Exception):
    """The block pool has no free block; caller should preempt or queue."""


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


class PagedKVPool:
    """Fixed-size-block allocator: free-list + per-block refcounts.

    Blocks are plain integer ids; the pool never touches tensor data (that
    is ``PagedKVStore``).  Refcounts > 1 mean the block is shared between a
    live sequence and one or more snapshots (or a shared prefix)."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO free-list: reuse hot blocks first
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._ref = np.zeros(num_blocks, np.int32)

    # ------------------------------------------------------------- queries
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.num_blocks - len(self._free)

    def refcount(self, block: int) -> int:
        return int(self._ref[block])

    def refcounts(self) -> np.ndarray:
        """Copy of the per-block refcount array — the ground truth the
        audits reconcile against the holders they can enumerate (live
        sequences, snapshots)."""
        return self._ref.copy()

    def blocks_for_tokens(self, n_tokens: int) -> int:
        return cdiv(n_tokens, self.block_size)

    # ---------------------------------------------------------- lifecycle
    def alloc(self) -> int:
        if not self._free:
            raise PoolExhausted(
                f"pool exhausted: {self.num_blocks} blocks all live")
        b = self._free.pop()
        assert self._ref[b] == 0
        self._ref[b] = 1
        return b

    def retain(self, block: int) -> None:
        assert self._ref[block] > 0, f"retain of free block {block}"
        self._ref[block] += 1

    def release(self, block: int) -> None:
        assert self._ref[block] > 0, f"double free of block {block}"
        self._ref[block] -= 1
        if self._ref[block] == 0:
            self._free.append(block)


@dataclasses.dataclass(frozen=True)
class BlockTableSnapshot:
    """A refcounted view of a sequence at a past length.  Holds one
    reference on every listed block until consumed by ``PagedSeq.restore``
    or dropped via ``PagedSeq.discard_snapshot``."""
    blocks: Tuple[int, ...]
    length: int


class PagedSeq:
    """One sequence's block table over a shared pool.

    ``append(n)`` grows the logical length by n tokens, allocating blocks
    as needed.  It returns ``(new_blocks, copies)`` where ``copies`` is a
    list of ``(src, dst)`` block pairs that a physical store must copy —
    emitted when the tail block was shared with a snapshot (copy-on-write).
    """

    def __init__(self, pool: PagedKVPool):
        self.pool = pool
        self.blocks: List[int] = []
        self.length = 0

    @property
    def block_table(self) -> List[int]:
        """Copy of the block-id table (kernel block-table source)."""
        return list(self.blocks)

    def append(self, n_tokens: int) -> Tuple[List[int], List[Tuple[int, int]]]:
        """Grow the logical length by ``n_tokens``, allocating whole
        blocks as needed — a partially-filled tail block's free slots are
        reused first (what makes chunk-by-chunk prefill reservation sum
        to the monolithic reservation).  Returns ``(new_blocks, copies)``
        where ``copies`` lists the ``(src, dst)`` CoW pairs a physical
        store must execute (emitted when the tail was shared with a
        snapshot or a cached prefix).  On ``PoolExhausted`` the partial
        grow is rolled back so the caller can preempt and retry."""
        if n_tokens < 0:
            raise ValueError("append of negative token count")
        if n_tokens == 0:
            return [], []
        bs = self.pool.block_size
        copies: List[Tuple[int, int]] = []
        new_blocks: List[int] = []
        # copy-on-write: writing into a partially-filled tail block that a
        # snapshot still references must not mutate the snapshot's view
        if self.length % bs != 0 and self.blocks:
            tail = self.blocks[-1]
            if self.pool.refcount(tail) > 1:
                fresh = self.pool.alloc()
                copies.append((tail, fresh))
                self.blocks[-1] = fresh
                self.pool.release(tail)
        need = self.pool.blocks_for_tokens(self.length + n_tokens) \
            - len(self.blocks)
        try:
            for _ in range(need):
                b = self.pool.alloc()
                new_blocks.append(b)
                self.blocks.append(b)
        except PoolExhausted:
            # roll the partial grow back so the caller can preempt + retry
            for b in reversed(new_blocks):
                self.blocks.pop()
                self.pool.release(b)
            for src, dst in reversed(copies):
                self.blocks[-1] = src
                self.pool.retain(src)
                self.pool.release(dst)
            raise
        self.length += n_tokens
        return new_blocks, copies

    def truncate(self, length: int
                 ) -> Tuple[List[int], List[Tuple[int, int]]]:
        """Shrink the logical length to ``length``, releasing every block
        wholly past it — the no-copy rollback of a rejected speculative
        suffix (serving/spec_engine.py).  Unlike :meth:`restore` this
        needs no snapshot.

        Copy-on-write on the kept tail: when ``length`` lands *inside* a
        block whose refcount > 1 — a radix-cached prefix block or a live
        step-boundary snapshot — the truncated sequence must not keep
        writable claim on slots past ``length`` that the other owner
        still reads (a spec-decode rollback into a cached prefix would
        otherwise let the row's next in-place write corrupt every
        sequence sharing that block).  The shared tail is detached onto a
        fresh block instead of being kept (or freed) shared: the emitted
        ``(src, dst)`` copy pair is the physical page copy a paged store
        must execute, exactly like :meth:`append`'s CoW list.  If the
        pool cannot supply a fresh block even after the suffix release,
        the tail stays shared (the next ``append`` will CoW it before any
        write lands there).

        Returns ``(freed, copies)``: the block ids that became fully free
        and the CoW copy list (both for the physical store and tests)."""
        if not 0 <= length <= self.length:
            raise ValueError(f"truncate to {length} outside [0, "
                             f"{self.length}]")
        keep = self.pool.blocks_for_tokens(length)
        freed = []
        for b in self.blocks[keep:]:
            self.pool.release(b)
            if self.pool.refcount(b) == 0:
                freed.append(b)
        del self.blocks[keep:]
        copies: List[Tuple[int, int]] = []
        if length % self.pool.block_size != 0 and self.blocks \
                and self.pool.refcount(self.blocks[-1]) > 1:
            tail = self.blocks[-1]
            try:
                fresh = self.pool.alloc()
            except PoolExhausted:
                fresh = None    # keep sharing; append will CoW later
            if fresh is not None:
                copies.append((tail, fresh))
                self.blocks[-1] = fresh
                self.pool.release(tail)
        self.length = length
        return freed, copies

    def adopt(self, blocks: Sequence[int], n_tokens: int) -> None:
        """Initialize an empty sequence onto SHARED blocks — the radix
        prefix-cache hit path: the cached prefix's blocks enter this
        sequence's table with one new reference each (the cache keeps its
        own), so the prefix is shared read-only until this sequence
        appends into a partial tail (CoW) or frees."""
        if self.blocks or self.length:
            raise ValueError("adopt onto a non-empty sequence")
        if self.pool.blocks_for_tokens(n_tokens) != len(blocks):
            raise ValueError(
                f"adopt of {n_tokens} tokens needs "
                f"{self.pool.blocks_for_tokens(n_tokens)} blocks, "
                f"got {len(blocks)}")
        for b in blocks:
            self.pool.retain(b)
        self.blocks = list(blocks)
        self.length = n_tokens

    def snapshot(self) -> BlockTableSnapshot:
        """Refcounted rollback point: retains every current block (so
        later appends into the shared tail copy-on-write) until the
        snapshot is consumed by :meth:`restore` or dropped via
        :meth:`discard_snapshot` — leaking one leaks its blocks."""
        for b in self.blocks:
            self.pool.retain(b)
        return BlockTableSnapshot(tuple(self.blocks), self.length)

    def restore(self, snap: BlockTableSnapshot) -> List[int]:
        """Roll back to ``snap`` (consuming it).  Blocks the sequence grew
        beyond the snapshot are released; returns the orphaned block ids
        that became fully free (for observability/tests)."""
        freed = []
        for b in self.blocks:
            self.pool.release(b)
            if self.pool.refcount(b) == 0:
                freed.append(b)
        # adopt the snapshot's references (no retain: ownership transfers)
        self.blocks = list(snap.blocks)
        self.length = snap.length
        return freed

    def discard_snapshot(self, snap: BlockTableSnapshot) -> None:
        for b in snap.blocks:
            self.pool.release(b)

    def free(self) -> None:
        """Release the sequence's own reference on every block (shared
        cache/snapshot references survive) and empty the table."""
        for b in self.blocks:
            self.pool.release(b)
        self.blocks = []
        self.length = 0


class PagedKVStore:
    """Physical paged KV for one attention model: ``k`` and ``v`` pages of
    shape ``(L, P, K, block_size, head_dim)`` on one device, page ``p``
    of layer ``l`` being ``k[l, p]`` -- the layout the paged kernels read
    through block tables.  Written in place.

    The arrays hold one page more than the pool's blocks, page
    ``scratch_page`` (= ``pool.num_blocks``), which the pool never hands
    out: a batched decode step over every row slot sends the writes of
    its masked rows there (``models.kvcache.slot_rows``).  A store built
    with ``shadow_pages`` holds that many more after it, from
    ``shadow_page``: one a row slot of an engine whose rows interact
    (the moe family), where a masked row's token reads its own context
    (``slot_rows`` with ``shadow``).

    Under tensor parallelism (``tp``, a ``serving.tp.TPContext``) the
    store holds the rank's contiguous slice of the ``kv_heads``: every
    page of the pool, its kv heads ``tp.local_heads(kv_heads)``.  Block
    ids, tables and the pool's accounting mean the same on every rank,
    so nothing else changes; the arrays are 1/tp of what the KVManager
    accounts for."""

    def __init__(self, pool: PagedKVPool, n_layers: int, kv_heads: int,
                 head_dim: int, device, dtype=torch.float32, tp=None,
                 shadow_pages: int = 0):
        self.pool = pool
        self.kv_heads = kv_heads
        self.tp = tp
        if tp is not None and kv_heads % tp.tp_size != 0:
            raise ValueError(
                f"tp_size={tp.tp_size} must divide kv_heads={kv_heads}")
        self.scratch_page = pool.num_blocks
        self.shadow_page = pool.num_blocks + 1
        local = kv_heads // tp.tp_size if tp is not None else kv_heads
        shape = (n_layers, pool.num_blocks + 1 + shadow_pages, local,
                 pool.block_size, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros_like(self.k)

    def device_views(self) -> List[Dict[str, object]]:
        """Which contiguous kv-head slice of the pool each rank holds, on
        which device (block tables are replicated host state and have no
        per-rank variant)."""
        if self.tp is None:
            return [{"rank": 0, "device": str(self.k.device),
                     "kv_head_start": 0, "kv_heads": self.kv_heads}]
        local = self.kv_heads // self.tp.tp_size
        names = list(self.tp.devices) or [None] * self.tp.tp_size
        return [{"rank": i, "device": d, "kv_head_start": i * local,
                 "kv_heads": local} for i, d in enumerate(names)]

    @property
    def nbytes(self) -> int:
        """Real bytes of both page arrays, the scratch and shadow pages
        included (the KVManager's accounting counts 2 bytes per element
        whatever the dtype, neither of them, and every kv head)."""
        return 2 * self.k.numel() * self.k.element_size()

    @property
    def scratch_bytes(self) -> int:
        """Bytes of the scratch page in both arrays."""
        return 2 * self.k[:, 0].numel() * self.k.element_size()

    def scatter(self, seq: PagedSeq, k_new: torch.Tensor,
                v_new: torch.Tensor, start: int) -> None:
        """Write ``k_new``/``v_new`` of shape (L, n, K, hd) into the
        sequence's pages at token offsets start..start+n-1, one indexed
        write per array (token t lies at ``(table[t // bs], t % bs)``)."""
        bs = self.pool.block_size
        t = np.arange(start, start + k_new.shape[1])
        pages = torch.from_numpy(np.asarray(seq.blocks, np.int64)[t // bs])
        slots = torch.from_numpy(t % bs)
        dev = self.k.device
        pages, slots = pages.to(dev), slots.to(dev)
        # advanced indices split by a slice lead the result: (n, L, K, hd)
        self.k[:, pages, :, slots] = k_new.transpose(0, 1).to(self.k.dtype)
        self.v[:, pages, :, slots] = v_new.transpose(0, 1).to(self.v.dtype)

    def apply_copies(self, copies: Sequence[Tuple[int, int]]) -> None:
        """Execute the (src, dst) page copies a CoW append or truncate
        emitted, all layers, in one indexed copy per array."""
        if not copies:
            return
        src = torch.tensor([s for s, _ in copies], device=self.k.device)
        dst = torch.tensor([d for _, d in copies], device=self.k.device)
        self.k[:, dst] = self.k[:, src]
        self.v[:, dst] = self.v[:, src]

    def gather(self, seq: PagedSeq, layer: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dense (length, K, hd) caches for one layer of one sequence (the
        rank's kv heads under tensor parallelism)."""
        idx = torch.tensor(seq.blocks, dtype=torch.long,
                           device=self.k.device)
        k, v = self.k[layer, idx], self.v[layer, idx]  # (nb, K, bs, hd)
        nb, kh, bs, hd = k.shape
        k = k.transpose(1, 2).reshape(nb * bs, kh, hd)
        v = v.transpose(1, 2).reshape(nb * bs, kh, hd)
        return k[:seq.length], v[:seq.length]


def pad_block_tables(seqs: Sequence[PagedSeq],
                     max_blocks: Optional[int] = None) -> np.ndarray:
    """(B, max_blocks) int32 block tables for a batched kernel call.
    Padding entries are 0, a valid page id; the kernels never read a table
    entry at or past ``ceil(length / block_size)``."""
    nb = max((len(s.blocks) for s in seqs), default=1)
    nb = max(nb, 1)
    if max_blocks is not None:
        nb = max(nb, max_blocks)
    out = np.zeros((len(seqs), nb), np.int32)
    for i, s in enumerate(seqs):
        out[i, :len(s.blocks)] = s.blocks
    return out
