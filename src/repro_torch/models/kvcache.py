"""Decode state of the dense family and its rollback rules.

A :class:`DecodeState` holds the attention KV caches, stacked over layers
as (L, B, C, K, hd) like the JAX package's, and the absolute position
(the number of tokens already in context) as a host integer.

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
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class DecodeState:
    k: torch.Tensor      # (L, B, C, K, hd)
    v: torch.Tensor
    pos: int             # absolute position = tokens already in context
    ring: bool = False   # ring-buffer (sliding window) cache

    @property
    def capacity(self) -> int:
        return self.k.shape[2]

    def truncate(self, new_pos: int) -> "DecodeState":
        """Roll back to an earlier position; stale slots are masked by
        position and overwritten before they become visible."""
        if self.ring:
            raise ValueError("truncate() cannot roll back a ring buffer; "
                             "restore a snapshot instead")
        if not 0 <= new_pos <= self.pos:
            raise ValueError(f"truncate to {new_pos} from {self.pos}")
        return dataclasses.replace(self, pos=int(new_pos))

    def snapshot(self) -> "DecodeState":
        """The state as it is now.  Shares linear caches (see the module
        docstring); copies ring caches."""
        if self.ring:
            return dataclasses.replace(self, k=self.k.clone(),
                                       v=self.v.clone())
        return dataclasses.replace(self)


def make_decode_state(cfg, batch: int, capacity: int, device,
                      dtype=torch.float32, ring: bool = False) -> DecodeState:
    """A zeroed decode state for a dense ``cfg`` on ``device``."""
    if cfg.family != "dense":
        raise NotImplementedError(f"decode state for family {cfg.family!r} "
                                  "is not ported yet")
    shape = (cfg.n_layers, batch, capacity, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    k = torch.zeros(shape, dtype=dtype, device=device)
    return DecodeState(k=k, v=torch.zeros_like(k), pos=0, ring=ring)
