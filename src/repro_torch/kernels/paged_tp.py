"""Tensor-parallel paged attention: one rank's launch of #3 or #4 over
its heads.  The port of the JAX package's ``kernels/paged_tp.py``
(``tp_paged_decode_attention``, ``tp_paged_append_attention``), which
``shard_map``s the paged kernels over the kv heads of a ``("model",)``
mesh.

Attention is independent across kv heads, so the split is exact: rank r
runs the unmodified kernel over its contiguous slice of ``H / tp`` query
heads and ``K / tp`` kv heads (GQA groups stay whole because tp divides
K), with the block tables and lengths replicated, and its output is its
slice of the unsharded output.  The functions take the rank's local
tensors and return the rank's heads un-gathered, as the ``shard_map``'s
``out_specs`` do; the caller gathers (``serving.tp.TPContext.
gather_heads``).  There is no kernel body here: each call goes through
``kernels.ops``, which launches the CUDA kernel for a CUDA tensor (and
counts it there as #3 or #4) and runs the plain version for a CPU
tensor.  Each function counts its own launches too, on the card, so a
run can show that its #3 and #4 came through the split.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import counts, ops


def check_heads(tp, h: int, kh: int,
                heads: Optional[Tuple[int, int]] = None) -> None:
    """Rank ``tp.rank``'s ``h`` query heads over ``kh`` kv heads must be
    whole GQA groups, and, given the model's ``heads`` (H, K), its
    ``H / tp`` and ``K / tp``."""
    if kh <= 0 or h % kh:
        raise ValueError(f"rank {tp.rank}: {h} query heads over {kh} kv "
                         "heads split a GQA group")
    if heads is not None and (h * tp.tp_size, kh * tp.tp_size) != \
            tuple(heads):
        raise ValueError(
            f"rank {tp.rank} of {tp.tp_size}: {h} query heads over {kh} kv "
            f"heads are not the 1/{tp.tp_size} slice of {tuple(heads)}")


def tp_paged_decode_attention(tp, q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              block_tables: torch.Tensor,
                              lengths: torch.Tensor,
                              heads: Optional[Tuple[int, int]] = None,
                              window: int = 0) -> torch.Tensor:
    """The rank's paged flash-decode: q (B, H/tp, hd) over its pages (P,
    K/tp, bs, hd), replicated tables (B, nb) and lengths (B,), with the
    model's sliding ``window`` (0: none).  Returns its (B, H/tp, hd)."""
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"q (B, H, hd) and pages (P, K, bs, hd); got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}")
    check_heads(tp, q.shape[1], k_pages.shape[1], heads)
    out = ops.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                     lengths, window)
    if q.is_cuda:
        counts.launched(tp_paged_decode_attention)
    return out


def tp_paged_append_attention(tp, q: torch.Tensor, k_new: torch.Tensor,
                              v_new: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              block_tables: torch.Tensor,
                              ctx_lens: torch.Tensor,
                              span_lens: torch.Tensor,
                              heads: Optional[Tuple[int, int]] = None,
                              window: int = 0) -> torch.Tensor:
    """The rank's span attention: q (B, T, H/tp, hd) and the span's
    k_new/v_new (B, T, K/tp, hd) over its pages (P, K/tp, bs, hd), with
    replicated tables and lengths and the model's sliding ``window`` (0:
    none).  Returns its (B, T, H/tp, hd)."""
    if q.dim() != 4 or k_new.dim() != 4 or k_pages.dim() != 4:
        raise ValueError(f"q (B, T, H, hd), k_new (B, T, K, hd), pages (P, "
                         f"K, bs, hd); got {tuple(q.shape)}, "
                         f"{tuple(k_new.shape)}, {tuple(k_pages.shape)}")
    check_heads(tp, q.shape[2], k_pages.shape[1], heads)
    if k_new.shape[2] != k_pages.shape[1]:
        raise ValueError(f"rank {tp.rank}: the span's {k_new.shape[2]} kv "
                         f"heads against the pages' {k_pages.shape[1]}")
    out = ops.paged_append_attention(q, k_new, v_new, k_pages, v_pages,
                                     block_tables, ctx_lens, span_lens,
                                     window)
    if q.is_cuda:
        counts.launched(tp_paged_append_attention)
    return out


tp_paged_decode_attention.launches = 0
tp_paged_append_attention.launches = 0
