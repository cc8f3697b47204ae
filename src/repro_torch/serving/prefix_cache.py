"""Radix-tree prefix cache over the paged KV pool: shared prompt prefixes
(best-of-N samples of one prompt, prompt templates, a preempted request's
own prompt) are served from cached pool blocks instead of prefilled.

The port of the JAX package's ``serving/prefix_cache.py``.  There the
batched rows are dense slabs, so a cached block's KV is copied into a
second page store (``PrefixKVStore``) at insert and copied back into the
row at a hit.  Here the pool's block tables are the physical layout of
the rows' KV (``PagedKVStore``), so the cache is **zero-copy**: a cached
block is a pool block on which the cache holds one reference, a hit
adopts those blocks into the new row's table (``PagedSeq.adopt``), and
the suffix prefill's span attention reads them through that table.  No
KV moves at an insert or a hit, and there is no page store of the
cache's own.

Structure: a trie whose edges are whole KV blocks.  Each node is one full
block of ``block_size`` tokens, keyed under its parent by its token tuple
(``chain_hash`` keeps the rolling hash of every token up to the block, for
observability); ``node.block`` is the pool block id the cache holds one
reference on.  The pool's refcounts are the only truth about sharing: a
cached block with refcount 1 is held by the cache alone and evictable; one
with refcount > 1 is in flight (a live sequence or a snapshot holds it)
and untouchable.

Match rule (block-aligned): a lookup walks whole blocks of the prompt and
returns the longest cached chain; a match covering the whole prompt drops
its last block, so at least one token is always prefilled (that suffix
prefill produces the row's ``last_logits``).

Eviction: LRU-first over evictable leaves (no children, refcount 1, not
pinned), cascading up as parents become leaves.  Triggered by pool
pressure (the scheduler's admission and mid-serve grow, before preempting
a victim) and by the cap: ``max_blocks`` bounds the cached nodes, as the
JAX package's store slots do, and an insert at the cap evicts exactly as
an insert there does under slot pressure.  Cached blocks count against
the pool in both packages, so admission, eviction and preemption follow
the same accounting.

Ownership protocol with ``PagedSeq``:

  hit    -> ``PagedSeq.adopt(blocks, n)``: +1 reference a block (the cache
            keeps its own); the prefix is shared read-only, and the CoW
            rules of ``append`` / ``truncate`` protect it thereafter.
  insert -> the cache retains (+1) each newly cached full block of a
            freshly prefilled prompt; the sequence's later free drops only
            its own reference.
  evict  -> release the cache's reference; the refcount reaches 0 and the
            block returns to the pool's free list.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .engine import Meter
from .paged_kv import PagedKVPool


def _chain_hash(parent: int, tokens: Tuple[int, ...]) -> int:
    """Stable rolling per-block hash (observability; exactness comes from
    keying children by the token tuple itself)."""
    h = parent
    for t in tokens:
        h = (h * 1000003 + int(t) + 1) & 0xFFFFFFFFFFFFFFFF
    return h


@dataclasses.dataclass
class _Node:
    tokens: Tuple[int, ...]
    block: int                       # pool block id (the cache holds a ref)
    parent: Optional["_Node"]
    chain_hash: int
    children: Dict[Tuple[int, ...], "_Node"] = dataclasses.field(
        default_factory=dict)
    last_used: int = 0
    pinned: bool = False


@dataclasses.dataclass
class CacheStats:
    lookups: int = 0
    hits: int = 0                    # lookups that matched >= 1 block
    hit_tokens: int = 0
    lookup_tokens: int = 0
    inserted_blocks: int = 0
    evicted_blocks: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hit_tokens / self.lookup_tokens \
            if self.lookup_tokens else 0.0

    def as_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["hit_rate"] = round(self.hit_rate, 4)
        return d


class RadixCache:
    """The radix-tree prefix cache over one engine's pool, holding at most
    ``max_blocks`` cached blocks."""

    def __init__(self, pool: PagedKVPool, max_blocks: int,
                 meter: Optional[Meter] = None, kv_heads: int = 0,
                 tp=None):
        """``tp``: the ranks' ``serving.tp.TPContext``, which must divide
        the cached pages' ``kv_heads``; a cached block is a pool block, so
        each rank's pages hold its heads of it and nothing else
        changes."""
        if max_blocks <= 0:
            raise ValueError("RadixCache needs max_blocks >= 1")
        if tp is not None and kv_heads % tp.tp_size != 0:
            raise ValueError(
                f"tp_size={tp.tp_size} must divide kv_heads={kv_heads}")
        self.pool = pool
        self.max_blocks = max_blocks
        self.meter = meter
        self.bs = pool.block_size
        self.root = _Node(tokens=(), block=-1, parent=None,
                          chain_hash=_chain_hash(0xCBF29CE4, ()))
        self.stats = CacheStats()
        self._clock = 0
        self._nodes = 0              # cached blocks (root excluded)

    # ------------------------------------------------------------ queries
    @property
    def cached_blocks(self) -> int:
        """Number of cached blocks (trie nodes, root excluded)."""
        return self._nodes

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def iter_nodes(self):
        """Every cached node, root excluded (order unspecified)."""
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def _key(self, tokens: Sequence[int], i: int) -> Tuple[int, ...]:
        return tuple(int(t) for t in tokens[i * self.bs:(i + 1) * self.bs])

    def _walk(self, tokens: Sequence[int]) -> List[_Node]:
        """Longest cached block-aligned chain for ``tokens`` (no LRU
        touch, no stats)."""
        chain: List[_Node] = []
        node = self.root
        for i in range(len(tokens) // self.bs):
            child = node.children.get(self._key(tokens, i))
            if child is None:
                break
            chain.append(child)
            node = child
        return chain

    def peek(self, tokens: Sequence[int]) -> int:
        """Tokens of the longest cached block-aligned prefix of ``tokens``
        under the match rule (a match of the whole prompt drops its last
        block).  Pure: no stats, no LRU touch (the scheduler peeks both
        engines' caches for the common hit, then ``acquire``s that)."""
        chain = self._walk(tokens)
        if chain and len(chain) * self.bs == len(tokens):
            chain = chain[:-1]
        return len(chain) * self.bs

    def acquire(self, tokens: Sequence[int], n_tokens: int) -> List[int]:
        """The pool blocks of the first ``n_tokens`` (block-aligned, at
        most ``peek``) of ``tokens``, touching their LRU clocks.  Retains
        nothing (``PagedSeq.adopt`` takes the sequence's references) and
        counts nothing (the scheduler ``record``s once a successful
        admission)."""
        assert n_tokens % self.bs == 0, n_tokens
        chain = self._walk(tokens)[:n_tokens // self.bs]
        assert len(chain) * self.bs == n_tokens, \
            f"acquire of {n_tokens} tokens but only " \
            f"{len(chain) * self.bs} cached"
        now = self._tick()
        for n in chain:
            n.last_used = now
        return [n.block for n in chain]

    def record(self, lookup_tokens: int, hit_tokens: int) -> None:
        """Count one lookup's outcome (stats and the engine's meter)."""
        self.stats.lookups += 1
        self.stats.lookup_tokens += lookup_tokens
        self.stats.hit_tokens += hit_tokens
        self.stats.hits += hit_tokens > 0
        if self.meter is not None:
            self.meter.cache_lookup_tokens += lookup_tokens
            self.meter.cache_hit_tokens += hit_tokens

    def match(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """``peek`` + ``acquire`` + ``record`` in one call: ``(blocks,
        n_tokens)`` of the longest cached prefix of ``tokens``.  The
        scheduler calls the three apart (its hit is the common one of both
        caches); this is the JAX package's one-call lookup, which the
        parity tests and ``chip_smoke.py`` drive."""
        hit = self.peek(tokens)
        blocks = self.acquire(tokens, hit)
        self.record(len(tokens), hit)
        return blocks, hit

    # ------------------------------------------------------------- insert
    def insert(self, tokens: Sequence[int], blocks: Sequence[int]) -> int:
        """Cache every full block of ``tokens`` not cached yet.
        ``blocks[i]`` is the owning sequence's pool block holding tokens
        ``[i * bs, (i + 1) * bs)``, already written; the cache retains each
        newly cached block.  At the cap, LRU cache-only entries are
        evicted; when nothing is evictable the rest is not cached.
        Returns the number of blocks newly cached."""
        nb = len(tokens) // self.bs
        assert len(blocks) >= nb, (len(blocks), nb)
        node = self.root
        now = self._tick()
        # the cached prefix is contiguous from the root, so every block
        # after the first miss is new
        first_new = nb
        walked: List[_Node] = []
        for i in range(nb):
            child = node.children.get(self._key(tokens, i))
            if child is None:
                first_new = i
                break
            child.last_used = now
            walked.append(child)
            node = child
        # room for the whole new run first (evicting LRU cache-only
        # entries at the cap; stopping when nothing more is evictable).
        # The walked chain is pinned meanwhile: the inserting sequence
        # need not have adopted it (the scheduler adopts the common hit of
        # both engines), and evicting the attach point would hang the new
        # nodes off a detached subtree, their blocks leaked.
        was_pinned = [n.pinned for n in walked]
        for n in walked:
            n.pinned = True
        room = 0
        try:
            for _ in range(nb - first_new):
                if self._nodes + room >= self.max_blocks \
                        and self.evict(1) == 0:
                    break            # the cap is full of in-flight entries
                room += 1
        finally:
            for n, p in zip(walked, was_pinned):
                n.pinned = p
        for i in range(first_new, first_new + room):
            key = self._key(tokens, i)
            self.pool.retain(blocks[i])
            child = _Node(tokens=key, block=blocks[i], parent=node,
                          chain_hash=_chain_hash(node.chain_hash, key),
                          last_used=now)
            node.children[key] = child
            node = child
            self._nodes += 1
        self.stats.inserted_blocks += room
        return room

    # -------------------------------------------------------------- evict
    def _evictable_leaves(self) -> List[_Node]:
        return [n for n in self.iter_nodes()
                if not n.children and not n.pinned
                and self.pool.refcount(n.block) == 1]

    def evict(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` cached blocks, LRU-first over evictable
        leaves, cascading to parents as they become leaves; never an
        in-flight or pinned entry.  Returns the blocks freed."""
        freed = 0
        while freed < n_blocks:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            self._drop(min(leaves, key=lambda n: n.last_used))
            freed += 1
        self.stats.evicted_blocks += freed
        if self.meter is not None:
            self.meter.cache_evictions += freed
        return freed

    def _drop(self, node: _Node) -> None:
        assert not node.children
        del node.parent.children[node.tokens]
        self.pool.release(node.block)
        assert self.pool.refcount(node.block) == 0, \
            "evicted an in-flight block"
        self._nodes -= 1

    def clear(self) -> int:
        """Release every evictable entry; entries adopted by live
        sequences survive.  Returns the blocks freed."""
        return self.evict(self._nodes)

    # ---------------------------------------------------------------- pin
    def pin(self, tokens: Sequence[int]) -> int:
        """Pin the cached chain matching ``tokens`` (a shared template,
        say) so eviction never takes it.  Returns the blocks pinned."""
        chain = self._walk(tokens)
        for n in chain:
            n.pinned = True
        return len(chain)

    def unpin(self, tokens: Sequence[int]) -> int:
        chain = self._walk(tokens)
        for n in chain:
            n.pinned = False
        return len(chain)
