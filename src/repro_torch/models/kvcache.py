"""Decode state of every family and its
rollback rules, and the per-call view of batched rows over a paged KV
store (``PagedRows``, built on the host by ``paged_rows`` for an extend,
on the device by ``slot_rows`` for a decode step).

A :class:`DecodeState` holds the attention KV caches, stacked over layers
as (L, B, C, K, hd) like the JAX package's (dense and moe families), or
the mamba2 states, conv (L, B, W-1, C) and ssm (L, B, H, P, N) (ssm
family), or both (hybrid family: each layer runs attention and a mamba2
mixer side by side), and the absolute position (the number of tokens
already in context) as a host integer.  The cross-attention families
add the cross K/V, stacked over the cross layers as (Lc, B, S_src, K,
hd) like the JAX package's (encdec: every decoder layer, over the
encoded frames; vlm: one a group, over the patch embeddings, its self
caches then holding ``n_self_layers`` layers), and ``cross_len``, the
(B,) int32 ``lengths`` of flash-decode over them (S_src in every row),
made once with the pair.  ``Model.prep_cross`` writes the cross pair
once a session; nothing after it writes them, so a snapshot, a
``truncate`` and every later state share them unchanged.

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

**A session's recurrent state is never written in place.**  Every call
folds each token into the whole conv and ssm state, so a shared state
written in place would let a snapshot see later tokens.  ``prefill`` and
``decode_step`` of the ssm family therefore build *new* conv and ssm
tensors and hand back a state over them; the old tensors are untouched.
A snapshot shares them and stays O(1), as in the JAX package (no 103 MB
copy per snapshot at mamba2-1.3b); a call costs one fresh state's
allocation instead.  The one exception is the fused decode loop
(``Engine.generate_fused``), whose CUDA graph needs static buffers: its
step (``decode_step`` with ``active``) writes into a conv/ssm pair that
the engine owns and no session holds.  The call copies the session's
state into that pair first and copies the pair out into fresh tensors
for the session it returns, so a state a snapshot holds is still never
written.  SSM state cannot be rolled back by position: ``truncate``
raises, and rollback restores a snapshot (and replays).

A hybrid state follows both rules at once: its K/V caches are written in
place and masked by position, as a dense model's, and its conv/ssm
states are new tensors after every call, as an ssm model's.  Its
``truncate`` raises (the ssm rule), and its snapshot shares all four
tensors and stays O(1): restoring it is correct because the K/V slots
below its position are never written again, which holds for linear
caches only.  A hybrid state is therefore always linear.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
    # cross-attention K/V (Lc, B, S_src, K, hd) and their decode lengths
    # (B,) int32, all S_src; None without a cross source
    cross_k: Optional[torch.Tensor] = None
    cross_v: Optional[torch.Tensor] = None
    cross_len: Optional[torch.Tensor] = None
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


def make_ssm_state(cfg, batch: int, device, dtype=torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed mamba2 states of an ssm or hybrid ``cfg``: conv (L, B, W-1,
    C) in ``dtype`` and ssm (L, B, H, P, N) in float32."""
    ch = cfg.ssm_d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state
    conv = torch.zeros((cfg.n_layers, batch, cfg.ssm_conv_width - 1, ch),
                       dtype=dtype, device=device)
    ssm = torch.zeros((cfg.n_layers, batch, cfg.ssm_n_heads,
                       cfg.ssm_head_dim, cfg.ssm_state),
                      dtype=torch.float32, device=device)
    return conv, ssm


def make_decode_state(cfg, batch: int, capacity: int, device,
                      dtype=torch.float32, ring: bool = False,
                      n_cross_src: int = 0) -> DecodeState:
    """A zeroed decode state for ``cfg`` on ``device`` (``capacity`` and
    ``ring`` are unused for ssm; a hybrid state takes linear caches
    only, as the module docstring says).  ``n_cross_src``: the source
    tokens a cross-attention family attends over (encoder frames, image
    patches); 0 leaves the cross pair out, as the JAX package's
    ``make_decode_state`` does."""
    conv = ssm = None
    if cfg.has_ssm:
        conv, ssm = make_ssm_state(cfg, batch, device, dtype)
        if cfg.family == "ssm":
            return DecodeState(k=None, v=None, pos=0, conv=conv, ssm=ssm)
        if ring:
            raise ValueError("a hybrid state takes linear caches only: a "
                             "snapshot must never see its slots rewritten")
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    k = torch.zeros((cfg.n_self_layers, batch, capacity, kv, hd),
                    dtype=dtype, device=device)
    ck = cv = clen = None
    if cfg.n_cross_layers and n_cross_src:
        ck = torch.zeros((cfg.n_cross_layers, batch, n_cross_src, kv, hd),
                         dtype=dtype, device=device)
        cv = torch.zeros_like(ck)
        clen = torch.full((batch,), n_cross_src, dtype=torch.int32,
                          device=device)
    return DecodeState(k=k, v=torch.zeros_like(k), pos=0, ring=ring,
                       conv=conv, ssm=ssm, cross_k=ck, cross_v=cv,
                       cross_len=clen)


@dataclasses.dataclass
class PagedRows:
    """One batched call's view of B rows over a paged KV store (the
    continuous-batching path; ``serving.paged_kv.PagedKVStore`` holds the
    pages).  Row b holds ``ctx_lens[b]`` committed tokens and takes
    ``span_lens[b]`` real new tokens of the call's T; its new token i
    sits at absolute position ``ctx_lens[b] + i``.  Only real tokens are
    written: token (``write_rows[n]``, ``write_cols[n]``) of the call goes
    to page ``write_pages[n]``, slot ``write_slots[n]``.  A view with
    shadow pages first copies page ``shadow_src[b]`` to ``shadow_dst[b]``
    for every row (``slot_rows``)."""
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
    # tensor parallelism: the rank's ``serving.tp.TPContext`` (the pages
    # hold its kv heads; ``models/attention.py`` gathers the heads), or
    # None
    tp: Optional[object] = None
    # (B,) int64 page ids, or None: each layer copies page shadow_src[b]
    # to shadow_dst[b] before its writes
    shadow_src: Optional[torch.Tensor] = None
    shadow_dst: Optional[torch.Tensor] = None


def paged_rows(k_pages: torch.Tensor, v_pages: torch.Tensor,
               tables, ctx_lens, span_lens, width: int,
               tp: Optional[object] = None,
               attend_pads: bool = False) -> PagedRows:
    """Build the index tensors of one batched call on the pages' device:
    ``tables`` lists each row's block ids (covering its context and its
    new tokens), ``ctx_lens`` / ``span_lens`` its committed and new token
    counts, ``width`` the call's padded T; ``tp`` the rank's context.
    With ``attend_pads`` every query of the span attends causally over
    the whole span, pads included (the view's ``span_lens`` are
    ``width``), as the JAX package's batched extend computes its pads;
    only the real tokens are written either way."""
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
    attend = np.full_like(span, width) if attend_pads else span
    return PagedRows(
        k_pages, v_pages, put(tab, torch.int32), ctx_t,
        put(attend, torch.int32),
        ctx_t.long()[:, None] + torch.arange(width, device=dev)[None, :],
        put(rows, torch.long), put(cols, torch.long), put(pages, torch.long),
        put(tok % bs, torch.long), tp)


def slot_rows(k_pages: torch.Tensor, v_pages: torch.Tensor,
              tables: torch.Tensor, pos: torch.Tensor, active: torch.Tensor,
              scratch: int, tp: Optional[object] = None,
              shadow: Optional[int] = None) -> PagedRows:
    """One-token decode step over every row slot of a batched engine,
    built on the pages' device from static buffers with no host read
    (the batched decode loops, which a CUDA graph records): ``tables``
    (B, W) int32 block tables padded with the ``scratch`` page, ``pos``
    (B,) int64 positions, ``active`` (B,) bool.  An active row's token at
    ``pos[b]`` is written to page ``tables[b, pos // bs]``, slot
    ``pos % bs``, and attends over ``pos + 1`` keys.  A masked row writes
    into the scratch page, which the pool never hands out, so that no
    page of a live row changes, and attends over one key; its output is
    the caller's to throw away.

    With ``shadow``, the first of ``B`` shadow pages (one a slot, never
    handed out by the pool), a masked row is computed as the JAX
    package's batched decode computes it: its token at ``pos[b]``
    attends over the row's context and itself.  Each layer copies the
    row's page at its position into the slot's shadow page
    (``PagedRows.shadow_src`` / ``shadow_dst``), the masked row's K/V
    go there, and its table reads that page in the position's column,
    so its context is read and no page of a live row changes.  A model
    whose rows interact (the moe family's capacity) needs this; the
    others throw a masked row's output away."""
    bs = k_pages.shape[3]
    b, width = tables.shape
    col = (pos // bs).clamp(max=width - 1)
    page = tables.gather(1, col[:, None])[:, 0].long()
    if shadow is not None:
        own = torch.arange(b, device=pos.device) + shadow
        dst = torch.where(active, page, own)
        return PagedRows(
            k_pages, v_pages, tables.scatter(1, col[:, None],
                                             dst.to(tables.dtype)[:, None]),
            pos.to(torch.int32), torch.ones_like(pos, dtype=torch.int32),
            pos[:, None], torch.arange(b, device=pos.device),
            torch.zeros_like(pos), dst, pos % bs, tp, page, own)
    ctx = torch.where(active, pos, 0).to(torch.int32)
    return PagedRows(
        k_pages, v_pages, tables, ctx, active.to(torch.int32), pos[:, None],
        torch.arange(b, device=pos.device), torch.zeros_like(pos),
        torch.where(active, page, scratch), torch.where(active, pos % bs, 0),
        tp)
