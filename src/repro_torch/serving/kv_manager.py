"""Static KV-memory partition between the colocated base and small models —
the paper's §4.1 implementation detail ("memory reserved for KV caches is
statically partitioned between the two models"), expressed for a device memory
budget.

Given the per-device HBM budget and both model configs, the manager solves
for the capacity each engine can be provisioned with under a fixed split
fraction, and accounts for every live session's cache.

Accounting unit: **KV blocks**, not raw bytes.  The continuous-batching
subsystem allocates attention KV in fixed-size token blocks
(serving/paged_kv.py), so each partition's capacity is expressed as a
block count and every attention allocation is quantized to whole blocks —
``capacity_blocks``/``used_blocks``/``free_blocks`` are what the paged
pools and the admission controller consume.  Constant-size recurrent (SSM)
state is not paged (it never grows); it is charged exactly, in
block-equivalents.

A copy of the JAX package's module, arithmetic unchanged so that
admission decisions match it: ``kv_bytes_per_token`` counts 2 bytes per
element.  The port's page store (``paged_kv.PagedKVStore``) holds fp32
pages, so its real bytes are twice what this accounting charges
(``PagedKVStore.nbytes`` reports them)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ..models.config import ModelConfig

DEFAULT_BLOCK_SIZE = 16       # tokens per KV block (paged_kv pool unit)


def kv_bytes_per_token(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    """Attention KV bytes per context token (per sequence)."""
    if not cfg.has_attention:
        return 0
    n_attn = cfg.n_self_layers if cfg.family == "vlm" else cfg.n_layers
    return n_attn * 2 * cfg.n_kv_heads * cfg.resolved_head_dim * dtype_bytes


def ssm_state_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    """Constant-size recurrent state bytes (per sequence)."""
    if not cfg.has_ssm:
        return 0
    conv = cfg.n_layers * (cfg.ssm_conv_width - 1) * \
        (cfg.ssm_d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state) * dtype_bytes
    ssm = cfg.n_layers * cfg.ssm_n_heads * cfg.ssm_head_dim * \
        cfg.ssm_state * 4  # f32 state
    return conv + ssm


@dataclasses.dataclass
class KVBudget:
    total_bytes: int
    base_fraction: float = 0.8      # paper colocates; base dominates

    def split(self) -> Tuple[int, int]:
        """(base_bytes, small_bytes) under the static fraction."""
        b = int(self.total_bytes * self.base_fraction)
        return b, self.total_bytes - b


class KVManager:
    """Tracks live sessions' cache usage against the static partition, in
    whole KV blocks."""

    def __init__(self, base_cfg: ModelConfig, small_cfg: ModelConfig,
                 budget: KVBudget, block_size: int = DEFAULT_BLOCK_SIZE):
        self.cfgs = {"base": base_cfg, "small": small_cfg}
        self.budget = budget
        self.block_size = block_size
        b, s = budget.split()
        self.capacity_bytes = {"base": b, "small": s}
        self.used_blocks = {"base": 0, "small": 0}
        self.sessions: Dict[str, Tuple[str, int]] = {}

    # ------------------------------------------------------------- blocks
    def block_bytes(self, which: str) -> int:
        """Bytes of one KV block of ``which``'s attention cache (0 for
        attention-less models — their state is charged in equivalents of
        the OTHER accounting below)."""
        return kv_bytes_per_token(self.cfgs[which]) * self.block_size

    def capacity_blocks(self, which: str) -> int:
        """Total KV blocks ``which``'s static partition can hold — the
        size of its paged pool."""
        bb = self.block_bytes(which)
        if bb == 0:
            # no attention cache: express the byte budget in units of one
            # session's constant-size state so admission still counts
            per = max(ssm_state_bytes(self.cfgs[which]), 1)
            return self.capacity_bytes[which] // per
        return self.capacity_bytes[which] // bb

    def free_blocks(self, which: str) -> int:
        """Blocks not charged to any live session."""
        return self.capacity_blocks(which) - self.used_blocks[which]

    def headroom_blocks(self, step_tokens: int, gamma: int = 0) -> int:
        """Admission headroom per in-flight request, in blocks: one
        reasoning step plus its score-token probe — and, in spec-decode
        mode, the worst case must ALSO cover the ``gamma`` in-flight
        draft tokens a verification pass keeps in the cache beyond the
        committed context, plus the reconcile feed slot.  Admitting
        without the gamma term lets a full pool meet a mid-verification
        grow with no victim left to preempt (regression-tested in
        tests/test_serving.py)."""
        inflight = step_tokens + 1 + ((gamma + 1) if gamma > 0 else 0)
        return -(-inflight // self.block_size)

    def chunk_blocks(self, cursor_tokens: int, chunk_tokens: int) -> int:
        """New blocks one prefill chunk claims on top of a sequence
        already ``cursor_tokens`` long — the chunked-prefill admission /
        reservation unit.  Partial-final-block aware: a chunk that starts
        inside the cursor's partially-filled tail block reuses its free
        slots and claims blocks only for the overflow, so reserving chunk
        by chunk sums to exactly the monolithic reservation."""
        before = -(-cursor_tokens // self.block_size)
        after = -(-(cursor_tokens + chunk_tokens) // self.block_size)
        return after - before

    def prefix_cache_blocks(self, which: str, fraction: float = 0.25,
                            max_blocks: int = 256) -> int:
        """Default cap on ``which``'s radix prefix cache
        (``serving.prefix_cache.RadixCache``, in cached blocks): a
        fraction of the partition's block capacity, capped, the JAX
        package's sizing of its cache's page store.  The cache's pool
        accounting needs no separate budget: cached blocks are ordinary
        refcounted pool blocks and eviction yields them back under
        admission pressure."""
        return max(1, min(int(self.capacity_blocks(which) * fraction),
                          max_blocks))

    def _blocks_needed(self, which: str, capacity: int, batch: int) -> int:
        cfg = self.cfgs[which]
        bb = self.block_bytes(which)
        if bb == 0:
            return batch  # one constant-size state unit per sequence
        attn = -(-capacity // self.block_size) * batch
        fixed = -(-ssm_state_bytes(cfg) * batch // bb)  # hybrid: exact, in
        return attn + fixed                             # block-equivalents

    # ---------------------------------------------------------- sessions
    def max_context(self, which: str, batch: int = 1) -> int:
        """Longest context capacity a new batch could be provisioned with."""
        cfg = self.cfgs[which]
        bb = self.block_bytes(which)
        if bb == 0:
            return (1 << 30) if self.free_blocks(which) >= batch else 0
        free = self.free_blocks(which)
        fixed = -(-ssm_state_bytes(cfg) * batch // bb)
        return max(((free - fixed) // batch) * self.block_size, 0)

    def allocate(self, session_id: str, which: str, capacity: int,
                 batch: int = 1) -> bool:
        need = self._blocks_needed(which, capacity, batch)
        if self.used_blocks[which] + need > self.capacity_blocks(which):
            return False
        self.used_blocks[which] += need
        self.sessions[session_id] = (which, need)
        return True

    def release(self, session_id: str) -> None:
        """Idempotent: releasing an unknown or already-released session is
        a no-op (the scheduler's error paths may release twice)."""
        entry = self.sessions.pop(session_id, None)
        if entry is None:
            return
        which, need = entry
        self.used_blocks[which] -= need
        assert self.used_blocks[which] >= 0, \
            f"negative KV usage for {which!r} after releasing {session_id!r}"

    def utilization(self) -> Dict[str, float]:
        return {k: self.used_blocks[k] / max(self.capacity_blocks(k), 1)
                for k in self.used_blocks}
