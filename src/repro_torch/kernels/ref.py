"""Plain PyTorch versions of the attention kernels (and of the causal
attention backward), and the SSD scan's sequential oracle.

Counterparts of the JAX package's ``kernels/ref.py`` oracles, written in
the most direct way: repeat the kv heads, form the whole score matrix in
fp32, mask, softmax; the paged versions first gather each row's pages
into a dense cache.  The CPU path of the port runs them, the tests hold
them to the JAX oracles, and ``chip_smoke.py`` holds the CUDA kernels to
them on the card.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _repeat_kv_heads(k: torch.Tensor, group: int) -> torch.Tensor:
    """(B, K, S, hd) -> (B, K*group, S, hd)."""
    return k.repeat_interleave(group, dim=1)


def attention_mask(s: int, skv: int, causal: bool = True, q_offset: int = 0,
                   kv_len: Optional[int] = None, window: int = 0,
                   device=None) -> torch.Tensor:
    """(s, skv) bool: query i (absolute position q_offset + i) sees key j
    iff j < kv_len and, when causal, j <= q_offset + i and (with a
    window) j > q_offset + i - window."""
    kv_len = skv if kv_len is None else kv_len
    qi = q_offset + torch.arange(s, device=device)[:, None]
    kj = torch.arange(skv, device=device)[None, :]
    valid = kj < kv_len
    if causal:
        valid = valid & (kj <= qi)
        if window:
            valid = valid & (kj > qi - window)
    return valid


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, q_offset: int = 0,
                  kv_len: Optional[int] = None,
                  window: int = 0) -> torch.Tensor:
    """q: (B,H,S,hd); k,v: (B,K,Skv,hd).  Direct softmax attention with
    the masks of ``attention_mask``.  With ``q_offset=0`` and
    ``kv_len=None`` over Skv == S this is the JAX ``mha_reference``."""
    b, h, s, hd = q.shape
    kh, skv = k.shape[1], k.shape[2]
    group = h // kh
    k = _repeat_kv_heads(k, group)
    v = _repeat_kv_heads(v, group)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                          k.float()) / math.sqrt(hd)
    mask = attention_mask(s, skv, causal, q_offset, kv_len, window,
                          device=q.device)
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def mha_backward_reference(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, do: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(dq, dk, dv) of causal ``mha_reference`` from position 0 over Skv ==
    S keys, by the explicit formulas in float32: P = softmax(S), dV =
    P^T dO, dP = dO V^T, D = rowsum(dO * O), dS = P * (dP - D), dQ = dS K /
    sqrt(hd), dK = dS^T Q / sqrt(hd); dk and dv summed over the G query
    heads of each kv head.  The plain version of
    ``flash_attention_bwd``."""
    b, h, s, hd = q.shape
    kh = k.shape[1]
    group = h // kh
    qf, dof = q.float(), do.float()
    kr = _repeat_kv_heads(k, group).float()
    vr = _repeat_kv_heads(v, group).float()
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kr) * scale
    mask = attention_mask(s, s, True, device=q.device)
    p = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vr)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vr)
    ds = p * (dp - (dof * o).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dk = dk.reshape(b, kh, group, s, hd).sum(2)
    dv = dv.reshape(b, kh, group, s, hd).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_reference(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor, window: int = 0) -> torch.Tensor:
    """q: (B,H,hd); k_cache/v_cache: (B,K,S,hd); lengths: (B,); row b
    attends over the keys j < lengths[b] and, with a window,
    j >= lengths[b] - window."""
    b, h, hd = q.shape
    kh, s = k_cache.shape[1], k_cache.shape[2]
    group = h // kh
    k = _repeat_kv_heads(k_cache, group)
    v = _repeat_kv_heads(v_cache, group)
    scores = torch.einsum("bhd,bhkd->bhk", q.float(),
                          k.float()) / math.sqrt(hd)
    j = torch.arange(s, device=q.device)[None, None, :]
    lens = lengths.to(q.device)[:, None, None]
    valid = j < lens
    if window:
        valid = valid & (j >= lens - window)
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", probs, v.float()).to(q.dtype)


def _gather_pages(pages: torch.Tensor,
                  block_tables: torch.Tensor) -> torch.Tensor:
    """(P, K, bs, hd) pages through (B, nb) tables -> (B, K, nb*bs, hd)."""
    b, nb = block_tables.shape
    _, kh, bs, hd = pages.shape
    return pages[block_tables.long()].transpose(1, 2).reshape(
        b, kh, nb * bs, hd)


def paged_decode_reference(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor,
                           window: int = 0) -> torch.Tensor:
    """Paged flash-decode: gather each row's pages into a dense cache,
    then ``decode_reference``.  q: (B, H, hd); k_pages/v_pages: (P, K,
    bs, hd); block_tables: (B, nb) page ids (padding entries are masked
    by ``lengths``); lengths: (B,); with a ``window``, row b sees the keys
    ``lengths[b] - window <= j < lengths[b]`` (the JAX package's decode
    mask ``pos - window < j <= pos`` at lengths = pos + 1)."""
    return decode_reference(q, _gather_pages(k_pages, block_tables),
                            _gather_pages(v_pages, block_tables), lengths,
                            window)


def paged_append_reference(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           ctx_lens: torch.Tensor,
                           span_lens: torch.Tensor,
                           window: int = 0) -> torch.Tensor:
    """Span attention: gather each row's pages into a dense cache, append
    the span's fresh K/V, masked softmax.  q: (B, T, H, hd); k_new/v_new:
    (B, T, K, hd); k_pages/v_pages: (P, K, bs, hd); block_tables: (B, nb);
    ctx_lens/span_lens: (B,).  Query i of a row sees context slots below
    ctx_len plus span slots j <= i with j < span_len; with a ``window``,
    only the keys whose position (slot j of the context, ctx_len + j of
    the span) is above ``ctx_len + i - window`` (the JAX package's
    prefill mask).  Outputs past a row's span_len are zero (the kernel
    leaves them unspecified)."""
    bsz, t, h, hd = q.shape
    kh = k_pages.shape[1]
    kc = _gather_pages(k_pages, block_tables)
    vc = _gather_pages(v_pages, block_tables)
    s_ctx = kc.shape[2]
    k = _repeat_kv_heads(torch.cat([kc, k_new.transpose(1, 2)], dim=2),
                         h // kh)
    v = _repeat_kv_heads(torch.cat([vc, v_new.transpose(1, 2)], dim=2),
                         h // kh)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.transpose(1, 2).float(),
                          k.float()) / math.sqrt(hd)
    dev = q.device
    kj = torch.arange(s_ctx + t, device=dev)[None, None, None, :]
    qi = torch.arange(t, device=dev)[None, None, :, None]
    ctx = ctx_lens.to(dev)[:, None, None, None]
    span = span_lens.to(dev)[:, None, None, None]
    in_ctx = (kj < s_ctx) & (kj < ctx)
    in_span = (kj >= s_ctx) & (kj - s_ctx <= qi) & (kj - s_ctx < span)
    seen = in_ctx | in_span
    if window:
        key_pos = torch.where(kj < s_ctx, kj, ctx + kj - s_ctx)
        seen = seen & (key_pos > ctx + qi - window)
    scores = scores.masked_fill(~seen, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)
    out = out.transpose(1, 2)                          # (B, T, H, hd)
    valid = torch.arange(t, device=dev)[None, :, None, None] < span
    return out.masked_fill(~valid, 0.0)


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor, init_state: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential (non-chunked) SSD recurrence, the definitional form and
    the oracle of the SSD scan kernel.

    x: (B,L,H,P); dt: (B,L,H); a: (H,); b,c: (B,L,G,N);
    init_state: (B,H,P,N).  Computes in float32, or float64 for float64
    x.  Returns (y in x's dtype, final state in that precision)."""
    wide = torch.promote_types(x.dtype, torch.float32)
    h = x.shape[2]
    rep = h // b.shape[2]
    bh = b.repeat_interleave(rep, dim=2).to(wide)
    ch = c.repeat_interleave(rep, dim=2).to(wide)
    xf, dtf, af = x.to(wide), dt.to(wide), a.to(wide)
    state = init_state.to(wide)
    ys = []
    for t in range(x.shape[1]):
        decay = torch.exp(af[None, :] * dtf[:, t])               # (B,H)
        upd = torch.einsum("bhp,bhn->bhpn", xf[:, t] * dtf[:, t, :, None],
                           bh[:, t])
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state
