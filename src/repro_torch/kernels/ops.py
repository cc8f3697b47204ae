"""Kernel entry points of the port (attention and the SSD scan): the
plain version for a CPU tensor, the CUDA kernel for a CUDA tensor.

The dispatch looks only at the device of the query (of x for the scan):
a CPU tensor runs the plain PyTorch version; a CUDA tensor launches the
hand-written kernel, whose wrapper raises on anything it does not take.
There is no fallback from the kernel to the plain version and no
override.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import ref
from .decode_attention import decode_attention as decode_kernel
from .flash_attention import flash_attention as flash_kernel
from .paged_append_attention import paged_append_attention as append_kernel
from .paged_decode_attention import paged_decode_attention as paged_kernel
from .ssd_scan import ssd_scan as ssd_kernel


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel path for device {t.device}")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """(B,H,hd) x (B,K,S,hd)^2 + lengths (B,) -> (B,H,hd)."""
    if _on_cpu(q):
        return ref.decode_reference(q, k_cache, v_cache, lengths)
    return decode_kernel(q, k_cache, v_cache, lengths)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0,
                    kv_len: Optional[int] = None,
                    window: int = 0) -> torch.Tensor:
    """(B,H,S,hd) x (B,K,Skv,hd)^2 -> (B,H,S,hd); masks as in
    ``ref.attention_mask``."""
    if _on_cpu(q):
        return ref.mha_reference(q, k, v, causal, q_offset, kv_len, window)
    return flash_kernel(q, k, v, causal, q_offset, kv_len, window)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """(B,H,hd) over (P,K,bs,hd)^2 pages through (B,nb) tables + lengths
    (B,) -> (B,H,hd)."""
    if _on_cpu(q):
        return ref.paged_decode_reference(q, k_pages, v_pages, block_tables,
                                          lengths)
    return paged_kernel(q, k_pages, v_pages, block_tables, lengths)


def paged_append_attention(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           ctx_lens: torch.Tensor,
                           span_lens: torch.Tensor) -> torch.Tensor:
    """(B,T,H,hd) span queries over the committed pages plus the span's
    (B,T,K,hd) K/V -> (B,T,H,hd); rows past span_len unspecified."""
    if _on_cpu(q):
        return ref.paged_append_reference(q, k_new, v_new, k_pages, v_pages,
                                          block_tables, ctx_lens, span_lens)
    return append_kernel(q, k_new, v_new, k_pages, v_pages, block_tables,
                         ctx_lens, span_lens)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, chunk: int,
        init_state: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan: x (B,L,H,P), dt (B,L,H), a (H,), b/c (B,L,G,N),
    init_state (B,H,P,N) or None (zeros); L a multiple of ``chunk``.
    Returns (y (B,L,H,P), final state (B,H,P,N)).  On the CPU the final
    state is in x's dtype (``ssd_chunked``, as the JAX package's plain
    path), on the card float32 (the kernel, as the Pallas kernel)."""
    if _on_cpu(x):
        # imported here: models.mamba2 imports this module
        from ..models.mamba2 import ssd_chunked
        return ssd_chunked(x, dt, a, b, c, chunk, init_state)
    init = None if init_state is None else init_state.float().contiguous()
    return ssd_kernel(x, dt.float(), a.float(), b, c, chunk, init)
