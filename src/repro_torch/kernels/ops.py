"""Kernel entry points of the port (attention and the SSD scan): the
plain version for a CPU tensor, the CUDA kernel for a CUDA tensor.

The dispatch looks only at the device of the query (of x for the scan):
a CPU tensor runs the plain PyTorch version; a CUDA tensor launches the
hand-written kernel, whose wrapper raises on anything it does not take.
There is no fallback from the kernel to the plain version and no
override.

Gradients: on the CPU torch autograd differentiates the plain versions.
On the card a kernel's output has no autograd history, so causal
attention under autograd (grad enabled and an input that requires grad:
the training forward) goes through ``FlashAttention``, whose forward is
kernel #2's launch unchanged and whose backward is the hand-written
``flash_attention_bwd``; with grad disabled or no input requiring grad
(every serving path) the call is #2's launch alone, as before.  The other
kernels have no backward and raise under autograd on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import ref
from .decode_attention import decode_attention as decode_kernel
from .flash_attention import flash_attention as flash_kernel
from .flash_attention_bwd import check_contract as check_bwd_contract
from .flash_attention_bwd import flash_attention_bwd as flash_bwd_kernel
from .paged_append_attention import paged_append_attention as append_kernel
from .paged_decode_attention import paged_decode_attention as paged_kernel
from .ssd_scan import ssd_scan as ssd_kernel


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel path for device {t.device}")


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in tensors)


def _no_grad_on_card(name: str, *tensors: torch.Tensor) -> None:
    """A kernel without a backward must not run where autograd would need
    one: its output would silently drop the gradient."""
    if _needs_grad(*tensors):
        raise NotImplementedError(f"{name} has no backward kernel; on the "
                                  "card only causal attention from position "
                                  "0 trains")


class FlashAttention(torch.autograd.Function):
    """Causal attention from position 0 on the card, differentiable:
    forward = kernel #2, backward = ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v):
        o = flash_kernel(q, k, v, True, 0, None, 0)
        ctx.save_for_backward(q, k, v, o)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        return flash_bwd_kernel(q, k, v, o, do)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor, window: int = 0) -> torch.Tensor:
    """(B,H,hd) x (B,K,S,hd)^2 + lengths (B,) -> (B,H,hd); with a
    ``window``, row b sees only its last ``window`` keys."""
    if _on_cpu(q):
        return ref.decode_reference(q, k_cache, v_cache, lengths, window)
    _no_grad_on_card("decode_attention", q, k_cache, v_cache)
    return decode_kernel(q, k_cache, v_cache, lengths, window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0,
                    kv_len: Optional[int] = None,
                    window: int = 0) -> torch.Tensor:
    """(B,H,S,hd) x (B,K,Skv,hd)^2 -> (B,H,S,hd); masks as in
    ``ref.attention_mask``.  Differentiable on the card in the training
    forward's case only (``flash_attention_bwd.check_contract``)."""
    if _on_cpu(q):
        return ref.mha_reference(q, k, v, causal, q_offset, kv_len, window)
    if _needs_grad(q, k, v):
        check_bwd_contract(q, k, v, causal, q_offset, kv_len, window)
        return FlashAttention.apply(q, k, v)
    return flash_kernel(q, k, v, causal, q_offset, kv_len, window)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor,
                           window: int = 0) -> torch.Tensor:
    """(B,H,hd) over (P,K,bs,hd)^2 pages through (B,nb) tables + lengths
    (B,) -> (B,H,hd); with a ``window``, row b sees only its last
    ``window`` keys."""
    if _on_cpu(q):
        return ref.paged_decode_reference(q, k_pages, v_pages, block_tables,
                                          lengths, window)
    _no_grad_on_card("paged_decode_attention", q, k_pages, v_pages)
    return paged_kernel(q, k_pages, v_pages, block_tables, lengths, window)


def paged_append_attention(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           ctx_lens: torch.Tensor,
                           span_lens: torch.Tensor,
                           window: int = 0) -> torch.Tensor:
    """(B,T,H,hd) span queries over the committed pages plus the span's
    (B,T,K,hd) K/V -> (B,T,H,hd); rows past span_len unspecified; with a
    ``window``, query i of row b sees only the keys at positions above
    ``ctx_lens[b] + i - window``."""
    if _on_cpu(q):
        return ref.paged_append_reference(q, k_new, v_new, k_pages, v_pages,
                                          block_tables, ctx_lens, span_lens,
                                          window)
    _no_grad_on_card("paged_append_attention", q, k_new, v_new, k_pages,
                     v_pages)
    return append_kernel(q, k_new, v_new, k_pages, v_pages, block_tables,
                         ctx_lens, span_lens, window)


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
    _no_grad_on_card("ssd_scan", x, dt, a, b, c)
    init = None if init_state is None else init_state.float().contiguous()
    return ssd_kernel(x, dt.float(), a.float(), b, c, chunk, init)
