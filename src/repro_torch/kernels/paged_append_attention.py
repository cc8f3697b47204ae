"""Paged span attention on the card: wrapper around
``csrc/paged_append_attention.cu``.

The port of the JAX package's Pallas kernel
``kernels/paged_append_attention.py``: T span queries per row attend
over the row's committed pages (through its block table) plus a dense
(B, T, K, hd) side buffer of the span's own fresh K/V, causal within the
span, with ragged context and span lengths.  The port runs every batched
extend through it (prompt chunks, step scoring, delimiters, spec-decode
verification), so T goes up to the largest extend bucket.  The kernel
computes on the tensor cores (3xTF32 for fp32 operands).  This wrapper
checks its arguments, picks the split over the committed context against
the blocks the card runs at once (asked of the kernel's occupancy once
per shape class), launches the CUDA kernel on the current stream and
counts the launch; it
never computes on the CPU (``ops.paged_append_attention`` sends CPU
tensors to ``ref.paged_append_reference``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build, counts
from .decode_attention import DTYPES
from .paged_decode_attention import check_lengths, check_pages
from .tile_plan import ROWS, card_occupancy, split_plan

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib():
    lib = build.load("paged_append_attention")
    fn = lib.paged_append_attention_launch
    fn.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                   _I, _I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_longlong),
                   _P]
    fn.restype = _I
    return lib


def paged_append_attention(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           ctx_lens: torch.Tensor,
                           span_lens: torch.Tensor) -> torch.Tensor:
    """q: (B, T, H, hd) span queries; k_new/v_new: (B, T, K, hd) the span's
    fresh K/V; k_pages/v_pages: (P, K, bs, hd); block_tables: (B, nb)
    int32; ctx_lens/span_lens: (B,) int32 (ctx_len at most nb * bs).  Any
    strides with a unit stride over hd, any H / K.  Returns (B, T, H, hd)
    in q's dtype; a row's outputs at or past its span_len are unspecified
    (the kernel writes 0).  float32 or bfloat16 in, fp32-accurate
    arithmetic (3xTF32 tensor-core products for fp32 operands)."""
    if not q.is_cuda:
        raise ValueError("paged_append_attention launches a CUDA kernel; "
                         f"got a tensor on {q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, T, H, hd); got {tuple(q.shape)}")
    b, t, h, hd = q.shape
    check_pages(q, k_pages, v_pages, block_tables, b, h, hd)
    _, kh, bs, _ = k_pages.shape
    if k_new.shape != (b, t, kh, hd) or v_new.shape != k_new.shape:
        raise ValueError(f"k_new/v_new must be (B, T, K, hd) = "
                         f"{(b, t, kh, hd)}; got {tuple(k_new.shape)}, "
                         f"{tuple(v_new.shape)}")
    for x in (k_new, v_new):
        if x.dtype != q.dtype or x.device != q.device or x.stride(-1) != 1:
            raise ValueError("k_new/v_new need q's dtype and device and a "
                             "unit stride over hd")
    check_lengths(ctx_lens, b, "ctx_lens", q.device)
    check_lengths(span_lens, b, "span_lens", q.device)
    nb = block_tables.shape[1]

    out = torch.empty((b, t, h, hd), dtype=q.dtype, device=q.device)
    slots, _ = card_occupancy("paged_append_attention", DTYPES[q.dtype], hd,
                              min(ROWS, t * (h // kh)), q.device.index)
    n_split, split_keys = split_plan(b, t, h, kh, nb * bs, slots)
    part = (torch.empty((b, t, h, n_split, hd + 2), dtype=torch.float32,
                        device=q.device) if n_split > 1 else out)
    strides = (ctypes.c_longlong * 19)(
        *q.stride()[:3], *k_new.stride()[:3], *v_new.stride()[:3],
        *k_pages.stride()[:3], *v_pages.stride()[:3], block_tables.stride(0),
        *out.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib().paged_append_attention_launch(
            DTYPES[q.dtype], q.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), ctx_lens.data_ptr(),
            span_lens.data_ptr(), out.data_ptr(), part.data_ptr(), b, t, h,
            kh, nb, bs, hd, n_split, split_keys, strides, stream)
    if rc != 0:
        raise RuntimeError(f"paged_append_attention kernel launch failed: "
                           f"CUDA error {rc}")
    counts.launched(paged_append_attention)
    return out


paged_append_attention.launches = 0
