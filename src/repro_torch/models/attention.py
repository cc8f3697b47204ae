"""GQA self-attention of the dense family: full-sequence, chunked prefill
into a KV cache, and one-token decode.

The attention itself goes through ``kernels.ops``: on a CUDA tensor the
hand-written kernels (``flash_attention`` for full-sequence and prefill,
``decode_attention`` for decode), on a CPU tensor their plain versions.
Caches are (B, C, K, hd) per layer, as in the JAX package, and are
written in place (see ``kvcache.py`` for why that is safe); the kernels
read them through permuted views, so no cache is copied per call.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..kernels import ops
from .config import ModelConfig
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
                          v_cache: torch.Tensor, pos: int,
                          lengths: torch.Tensor,
                          ring: bool = False) -> torch.Tensor:
    """One-token decode.  x: (B, 1, d); k_cache/v_cache: (B, C, K, hd),
    written in place at the new token's slot; pos: the new token's
    absolute position; lengths: (B,) int32 on x's device, the number of
    valid slots (``min(pos + 1, C)``), built once per decode step.

    Linear caches run the decode kernel (``ops.decode_attention``).  Ring
    buffers and sliding windows run a plain masked path on the CPU and
    raise on CUDA until a kernel covers them."""
    b = x.shape[0]
    cap = k_cache.shape[1]
    q, k, v = qkv(x, p)
    if cfg.use_rope:
        posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, posv, cfg.rope_theta)
        k = apply_rope(k, posv, cfg.rope_theta)
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
