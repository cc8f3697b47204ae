"""Attention entry points of the port: the plain version for a CPU
tensor, the CUDA kernel for a CUDA tensor.

The dispatch looks only at the device of the query: a CPU tensor runs
the plain PyTorch version in ``ref``; a CUDA tensor launches the
hand-written kernel, whose wrapper raises on anything it does not take.
There is no fallback from the kernel to the plain version and no
override.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .decode_attention import decode_attention as decode_kernel
from .flash_attention import flash_attention as flash_kernel


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no attention path for device {t.device}")


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
