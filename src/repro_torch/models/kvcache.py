"""Decode state of the dense and ssm families and its rollback rules, and
the per-call view of batched rows over a paged KV store (``PagedRows``,
built on the host by ``paged_rows`` for an extend, on the device by
``slot_rows`` for a decode step).

A :class:`DecodeState` holds the attention KV caches, stacked over layers
as (L, B, C, K, hd) like the JAX package's (dense family), or the mamba2
states, conv (L, B, W-1, C) and ssm (L, B, H, P, N) (ssm family), and the
absolute position (the number of tokens already in context) as a host
integer.

**Caches are written in place.**  JAX arrays are immutable, so there a
snapshot is the state object itself.  Here ``prefill`` and
``decode_step`` write new keys and values into the same tensors and hand
back a new ``DecodeState`` over them, so a snapshot shares its caches
with every state that follows it.  For a *linear* cache that is still a
correct snapshot:

  * every write after the snapshot lands at a slot at or past the
    snapshot's position (each call writes slots pos, pos+1, ...), so the
    slots the snapshot can see are never touched;
  * a query at position p sees only slots j <= p, and every slot in
    [snapshot position, p] was rewritten by the call that brought the
    context to p, or by one after the rollback, before any query could
    see it.

So restoring a snapshot, or ``truncate``-ing to an earlier position,
rolls the context back with no copy.  A ring-buffered cache wraps, so a
later write can land on a slot the snapshot still sees: ``snapshot``
therefore copies ring caches.

**Recurrent states are never written in place.**  Every call folds each
token into the whole conv and ssm state, so a shared state written in
place would let a snapshot see later tokens.  ``prefill`` and
``decode_step`` of the ssm family therefore build *new* conv and ssm
tensors and hand back a state over them; the old tensors are untouched.
A snapshot shares them and stays O(1), as in the JAX package (no 103 MB
copy per snapshot at mamba2-1.3b); a call costs one fresh state's
allocation instead.  SSM state cannot be rolled back by position:
``truncate`` raises, and rollback restores a snapshot (and replays).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class DecodeState:
    k: Optional[torch.Tensor]     # (L, B, C, K, hd); None without attention
    v: Optional[torch.Tensor]
    pos: int             # absolute position = tokens already in context
    ring: bool = False   # ring-buffer (sliding window) cache
    conv: Optional[torch.Tensor] = None   # (L, B, W-1, C) mamba conv state
    ssm: Optional[torch.Tensor] = None    # (L, B, H, P, N) SSM state
    # held by every state over an engine's pooled caches, so the engine
    # knows when no live state holds them (``Engine.new_session``)
    lease: object = dataclasses.field(default=None, repr=False,
                                      compare=False)

    @property
    def capacity(self) -> int:
        """Attention cache length; 0 without an attention cache (SSM
        state has no positional capacity)."""
        return self.k.shape[2] if self.k is not None else 0

    def truncate(self, new_pos: int) -> "DecodeState":
        """Roll back to an earlier position; stale slots are masked by
        position and overwritten before they become visible.  Refused for
        SSM state, which cannot be rolled back by position."""
        if self.ssm is not None:
            raise ValueError("truncate() cannot roll back SSM state; keep a "
                             "snapshot of the DecodeState at the step "
                             "boundary and restore it")
        if self.ring:
            raise ValueError("truncate() cannot roll back a ring buffer; "
                             "restore a snapshot instead")
        if not 0 <= new_pos <= self.pos:
            raise ValueError(f"truncate to {new_pos} from {self.pos}")
        return dataclasses.replace(self, pos=int(new_pos))

    def snapshot(self) -> "DecodeState":
        """The state as it is now.  Shares linear caches and SSM states
        (see the module docstring); copies ring caches."""
        if self.ring:
            return dataclasses.replace(self, k=self.k.clone(),
                                       v=self.v.clone())
        return dataclasses.replace(self)


def make_decode_state(cfg, batch: int, capacity: int, device,
                      dtype=torch.float32, ring: bool = False) -> DecodeState:
    """A zeroed decode state for a dense or ssm ``cfg`` on ``device``
    (``capacity`` and ``ring`` are unused for ssm)."""
    if cfg.family == "ssm":
        ch = cfg.ssm_d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state
        conv = torch.zeros((cfg.n_layers, batch, cfg.ssm_conv_width - 1, ch),
                           dtype=dtype, device=device)
        ssm = torch.zeros((cfg.n_layers, batch, cfg.ssm_n_heads,
                           cfg.ssm_head_dim, cfg.ssm_state),
                          dtype=torch.float32, device=device)
        return DecodeState(k=None, v=None, pos=0, conv=conv, ssm=ssm)
    if cfg.family != "dense":
        raise NotImplementedError(f"decode state for family {cfg.family!r} "
                                  "is not ported yet")
    shape = (cfg.n_layers, batch, capacity, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    k = torch.zeros(shape, dtype=dtype, device=device)
    return DecodeState(k=k, v=torch.zeros_like(k), pos=0, ring=ring)


@dataclasses.dataclass
class PagedRows:
    """One batched call's view of B rows over a paged KV store (the
    continuous-batching path; ``serving.paged_kv.PagedKVStore`` holds the
    pages).  Row b holds ``ctx_lens[b]`` committed tokens and takes
    ``span_lens[b]`` real new tokens of the call's T; its new token i
    sits at absolute position ``ctx_lens[b] + i``.  Only real tokens are
    written: token (``write_rows[n]``, ``write_cols[n]``) of the call goes
    to page ``write_pages[n]``, slot ``write_slots[n]``."""
    k_pages: torch.Tensor       # (L, P, K, bs, hd)
    v_pages: torch.Tensor
    tables: torch.Tensor        # (B, nb) int32, padded with page 0
    ctx_lens: torch.Tensor      # (B,) int32
    span_lens: torch.Tensor     # (B,) int32
    positions: torch.Tensor     # (B, T) int64, ctx_lens[:, None] + i
    write_rows: torch.Tensor    # (n,) int64
    write_cols: torch.Tensor
    write_pages: torch.Tensor
    write_slots: torch.Tensor


def paged_rows(k_pages: torch.Tensor, v_pages: torch.Tensor,
               tables, ctx_lens, span_lens, width: int) -> PagedRows:
    """Build the index tensors of one batched call on the pages' device:
    ``tables`` lists each row's block ids (covering its context and its
    new tokens), ``ctx_lens`` / ``span_lens`` its committed and new token
    counts, ``width`` the call's padded T."""
    bs = k_pages.shape[3]
    b = len(tables)
    nb = max(1, max(len(t) for t in tables))
    tab = np.zeros((b, nb), np.int32)
    for i, t in enumerate(tables):
        tab[i, :len(t)] = t
    ctx = np.asarray(ctx_lens, np.int64)
    span = np.asarray(span_lens, np.int64)
    rows = np.repeat(np.arange(b), span)
    cols = np.concatenate([np.arange(n) for n in span]) if b else rows
    tok = ctx[rows] + cols
    pages = tab[rows, tok // bs].astype(np.int64)
    dev = k_pages.device

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    ctx_t = put(ctx, torch.int32)
    return PagedRows(
        k_pages, v_pages, put(tab, torch.int32), ctx_t, put(span, torch.int32),
        ctx_t.long()[:, None] + torch.arange(width, device=dev)[None, :],
        put(rows, torch.long), put(cols, torch.long), put(pages, torch.long),
        put(tok % bs, torch.long))


def slot_rows(k_pages: torch.Tensor, v_pages: torch.Tensor,
              tables: torch.Tensor, pos: torch.Tensor, active: torch.Tensor,
              scratch: int) -> PagedRows:
    """One-token decode step over every row slot of a batched engine,
    built on the pages' device from static buffers with no host read
    (the batched decode loops, which a CUDA graph records): ``tables``
    (B, W) int32 block tables padded with the ``scratch`` page, ``pos``
    (B,) int64 positions, ``active`` (B,) bool.  An active row's token at
    ``pos[b]`` is written to page ``tables[b, pos // bs]``, slot
    ``pos % bs``, and attends over ``pos + 1`` keys.  A masked row writes
    into the scratch page, which the pool never hands out, so that no
    page of a live row changes, and attends over one key; its output is
    the caller's to throw away."""
    bs = k_pages.shape[3]
    b, width = tables.shape
    col = (pos // bs).clamp(max=width - 1)
    page = tables.gather(1, col[:, None])[:, 0].long()
    ctx = torch.where(active, pos, 0).to(torch.int32)
    return PagedRows(
        k_pages, v_pages, tables, ctx, active.to(torch.int32), pos[:, None],
        torch.arange(b, device=pos.device), torch.zeros_like(pos),
        torch.where(active, page, scratch), torch.where(active, pos % bs, 0))
