"""GQA self-attention of the dense family: full-sequence, chunked prefill
into a KV cache, one-token decode, and their batched forms over a paged
KV store (``extend_rows_attention``, ``decode_rows_attention``).

The attention itself goes through ``kernels.ops``: on a CUDA tensor the
hand-written kernels (``flash_attention`` for full-sequence and prefill,
``decode_attention`` for decode, ``paged_append_attention`` and
``paged_decode_attention`` for the batched rows), on a CPU tensor their
plain versions.
Caches are (B, C, K, hd) per layer, as in the JAX package, and are
written in place (see ``kvcache.py`` for why that is safe); the kernels
read them through permuted views, so no cache is copied per call.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..kernels import ops
from .config import ModelConfig
from .kvcache import PagedRows
from .layers import ParamSpec, apply_rope

NEG_INF = -1e30


def attn_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, k = cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": ParamSpec((d, h, hd), "scaled", 1.0, 0),
        "wk": ParamSpec((d, k, hd), "scaled", 1.0, 0),
        "wv": ParamSpec((d, k, hd), "scaled", 1.0, 0),
        "wo": ParamSpec((h, hd, d), "scaled", 1.0, 2),
    }


def qkv(x: torch.Tensor, p: Dict[str, torch.Tensor]
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> q (B,S,H,hd), k and v (B,S,K,hd)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    return q, k, v


def out_proj(o: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) <-> (B, H, S, hd) as a view."""
    return t.permute(0, 2, 1, 3)


def self_attention(x: torch.Tensor, p: Dict[str, torch.Tensor],
                   cfg: ModelConfig, positions: torch.Tensor,
                   window: int = 0) -> torch.Tensor:
    """Full-sequence causal self-attention (the training-path forward)."""
    q, k, v = qkv(x, p)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = ops.flash_attention(_heads_first(q), _heads_first(k),
                            _heads_first(v), causal=True, window=window)
    return out_proj(_heads_first(o), p)


def prefill_self_attention(x: torch.Tensor, p: Dict[str, torch.Tensor],
                           cfg: ModelConfig, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, start: int,
                           window: int = 0) -> torch.Tensor:
    """Chunked prefill: S new tokens at absolute positions start..start+S-1
    are written into the (B, C, K, hd) caches in place, and each attends
    over every cache slot j <= its position (and > position - window).

    Tokens that would land past the capacity are not written (a bucket's
    trailing pads near the end of the cache; the engine keeps real tokens
    below capacity).  The JAX package's ``dynamic_update_slice`` would
    instead shift the whole chunk back to fit."""
    b, s, _ = x.shape
    cap = k_cache.shape[1]
    q, k, v = qkv(x, p)
    if cfg.use_rope:
        positions = start + torch.arange(s, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    n = max(0, min(s, cap - start))
    k_cache[:, start:start + n] = k[:, :n].to(k_cache.dtype)
    v_cache[:, start:start + n] = v[:, :n].to(v_cache.dtype)
    o = ops.flash_attention(_heads_first(q), _heads_first(k_cache),
                            _heads_first(v_cache), causal=True,
                            q_offset=start, kv_len=cap, window=window)
    return out_proj(_heads_first(o), p)


def decode_self_attention(x: torch.Tensor, p: Dict[str, torch.Tensor],
                          cfg: ModelConfig, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, pos,
                          lengths: torch.Tensor, ring: bool = False,
                          active: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """One-token decode.  x: (B, 1, d); k_cache/v_cache: (B, C, K, hd),
    written in place at the new token's slot; pos: the new token's
    absolute position, a host int (the per-token loop) or a 0-d integer
    tensor on x's device (the fused loop, which reads nothing back);
    lengths: (B,) int32 on x's device, the number of valid slots
    (``min(pos + 1, C)``), built once per decode step.

    With a tensor ``pos`` the slot ``min(pos, C - 1)`` is written by an
    indexed copy, and ``active`` (a 0-d bool tensor) may mask the step: a
    step the fused loop runs after its stop writes back the K/V already
    at the slot, so a masked step at ``pos == C`` leaves slot C - 1, which
    is in the context, as it was.

    Linear caches run the decode kernel (``ops.decode_attention``).  Ring
    buffers and sliding windows run a plain masked path on the CPU with a
    host ``pos`` and raise on CUDA until a kernel covers them."""
    b = x.shape[0]
    cap = k_cache.shape[1]
    q, k, v = qkv(x, p)
    on_device = isinstance(pos, torch.Tensor)
    if on_device and (ring or cfg.sliding_window):
        raise NotImplementedError(
            "a device position (the fused decode loop) takes linear caches "
            "without a window")
    if cfg.use_rope:
        posv = pos.reshape(1, 1).expand(b, 1) if on_device else \
            torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, posv, cfg.rope_theta)
        k = apply_rope(k, posv, cfg.rope_theta)
    if on_device:
        slot = pos.clamp(max=cap - 1).long().reshape(1)
        _write_slot(k_cache, slot, k, active)
        _write_slot(v_cache, slot, v, active)
    else:
        slot = pos % cap if ring else min(pos, cap - 1)
        k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
    if ring or cfg.sliding_window:
        if x.is_cuda:
            raise NotImplementedError(
                "ring-buffer and sliding-window decode have no CUDA kernel "
                "yet; run them with device='cpu'")
        o = _masked_decode(q[:, 0], k_cache, v_cache, pos, ring,
                           cfg.sliding_window)
    else:
        o = ops.decode_attention(q[:, 0], _heads_first(k_cache),
                                 _heads_first(v_cache), lengths)
    return out_proj(o[:, None], p)


def _write_slot(cache: torch.Tensor, slot: torch.Tensor, new: torch.Tensor,
                active: Optional[torch.Tensor]) -> None:
    """cache (B, C, K, hd)[:, slot] = new (B, 1, K, hd) by an indexed copy
    at the device index ``slot`` (1,); where ``active`` is false, the
    slot's own K/V are written back."""
    new = new.to(cache.dtype)
    if active is not None:
        new = torch.where(active, new, cache.index_select(1, slot))
    cache.index_copy_(1, slot, new)


def _masked_decode(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, pos: int, ring: bool,
                   window: int) -> torch.Tensor:
    """Plain decode attention with the ring / sliding-window masks of the
    JAX package's ``decode_self_attention``.  q: (B, H, hd)."""
    b, h, hd = q.shape
    cap, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    qg = q.reshape(b, kh, g, hd).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg,
                          k_cache.float()) / math.sqrt(hd)
    j = torch.arange(cap, device=q.device)
    if ring:
        mask = j < min(pos + 1, cap)
    else:
        mask = (j <= pos) & (j > pos - window)
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v_cache.float())
    return out.reshape(b, h, hd).to(q.dtype)


def _paged_only(cfg: ModelConfig) -> None:
    if cfg.sliding_window:
        raise NotImplementedError(
            "sliding-window attention over paged rows has no kernel and no "
            "plain version yet; the batched path serves full attention")


def _write_rows(rows: PagedRows, layer: int, k: torch.Tensor,
                v: torch.Tensor) -> None:
    """Write the call's real tokens' K/V of one layer into the pages, one
    indexed write per array: (B, T, K, hd) -> the (page, slot) of each
    real token.  Pads and uninvolved rows write nothing into a row's
    pages: ``paged_rows`` leaves them out, ``slot_rows`` sends a masked
    row's write to the scratch page."""
    sel = (rows.write_rows, rows.write_cols)
    rows.k_pages[layer, rows.write_pages, :, rows.write_slots] = \
        k[sel].to(rows.k_pages.dtype)
    rows.v_pages[layer, rows.write_pages, :, rows.write_slots] = \
        v[sel].to(rows.v_pages.dtype)


def extend_rows_attention(x: torch.Tensor, p: Dict[str, torch.Tensor],
                          cfg: ModelConfig, layer: int,
                          rows: PagedRows) -> torch.Tensor:
    """Batched extend over a paged store: T new tokens per row (the first
    ``span_lens[b]`` real, the rest bucket pads) at positions
    ``ctx_lens[b] + i``.  Attention is ``ops.paged_append_attention``
    over the row's committed pages plus the span's fresh K/V as the side
    buffer; then the real tokens' K/V are written into the pages."""
    _paged_only(cfg)
    q, k, v = qkv(x, p)
    if cfg.use_rope:
        q = apply_rope(q, rows.positions, cfg.rope_theta)
        k = apply_rope(k, rows.positions, cfg.rope_theta)
    o = ops.paged_append_attention(q, k, v, rows.k_pages[layer],
                                   rows.v_pages[layer], rows.tables,
                                   rows.ctx_lens, rows.span_lens)
    _write_rows(rows, layer, k, v)
    return out_proj(o, p)


def decode_rows_attention(x: torch.Tensor, p: Dict[str, torch.Tensor],
                          cfg: ModelConfig, layer: int, rows: PagedRows,
                          lengths: torch.Tensor) -> torch.Tensor:
    """Batched one-token decode over a paged store (a ``slot_rows``
    view, or a ``paged_rows`` view of width 1): row b's token at
    ``positions[b]`` is written into its page first, then attends over
    the row's ``lengths[b] = ctx_lens[b] + 1`` keys through
    ``ops.paged_decode_attention``."""
    _paged_only(cfg)
    q, k, v = qkv(x, p)
    if cfg.use_rope:
        q = apply_rope(q, rows.positions, cfg.rope_theta)
        k = apply_rope(k, rows.positions, cfg.rope_theta)
    _write_rows(rows, layer, k, v)
    o = ops.paged_decode_attention(q[:, 0], rows.k_pages[layer],
                                   rows.v_pages[layer], rows.tables, lengths)
    return out_proj(o[:, None], p)
