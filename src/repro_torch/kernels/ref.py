"""Plain PyTorch versions of the attention kernels.

Counterparts of the JAX package's ``kernels/ref.py`` oracles, written in
the most direct way: repeat the kv heads, form the whole score matrix in
fp32, mask, softmax.  The CPU path of the port runs them, the tests hold
them to the JAX oracles, and ``chip_smoke.py`` holds the CUDA kernels to
them on the card.
"""

from __future__ import annotations

import math
from typing import Optional

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


def decode_reference(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: (B,H,hd); k_cache/v_cache: (B,K,S,hd); lengths: (B,)."""
    b, h, hd = q.shape
    kh, s = k_cache.shape[1], k_cache.shape[2]
    group = h // kh
    k = _repeat_kv_heads(k_cache, group)
    v = _repeat_kv_heads(v_cache, group)
    scores = torch.einsum("bhd,bhkd->bhk", q.float(),
                          k.float()) / math.sqrt(hd)
    valid = (torch.arange(s, device=q.device)[None, None, :]
             < lengths.to(q.device)[:, None, None])
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", probs, v.float()).to(q.dtype)
