"""Paged flash-decode on the card: wrapper around
``csrc/paged_decode_attention.cu``.

The port of the JAX package's Pallas kernel
``kernels/paged_decode_attention.py`` (one query token per row over a
global page pool read through per-row block tables; the G query heads of
a kv head as one tile; pages past a row's length skipped, the tail page
masked), for any G = H / K.  This wrapper checks its arguments, plans
the split over keys against the blocks the card runs at once
(``tile_plan.decode_split``, from the table's nb * bs slots), launches
the CUDA kernel on the current stream and counts the launch; it never
computes on the CPU (``ops.paged_decode_attention`` sends CPU tensors to
``ref.paged_decode_reference``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build, counts
from . import tile_plan
from .decode_attention import DTYPES, MAX_HEAD_DIM

_P, _I = ctypes.c_void_p, ctypes.c_int
_STRIDES = ctypes.c_longlong * 11


@functools.cache
def _entry():
    fn = build.load("paged_decode_attention").paged_decode_attention_launch
    fn.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   _I, _I, ctypes.POINTER(ctypes.c_longlong), _P]
    fn.restype = _I
    return fn


def _strides(q, k_pages, v_pages, block_tables, out) -> ctypes.Array:
    return _STRIDES(q.stride(0), q.stride(1), *k_pages.stride()[:3],
                    *v_pages.stride()[:3], block_tables.stride(0),
                    out.stride(0), out.stride(1))


def plan(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
         block_tables: torch.Tensor) -> dict:
    """``tile_plan.decode_plan`` of a launch on these CUDA tensors."""
    return tile_plan.decode_plan(
        "paged_decode_attention", DTYPES[q.dtype], q, k_pages, v_pages,
        block_tables.shape[1] * k_pages.shape[2],
        list(_strides(q, k_pages, v_pages, block_tables, q)))


def check_pages(q: torch.Tensor, k_pages: torch.Tensor,
                v_pages: torch.Tensor, block_tables: torch.Tensor,
                b: int, h: int, hd: int) -> None:
    """The argument checks the two paged wrappers share: the page pool,
    the block tables, dtypes, devices and unit strides over hd."""
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"k/v pages must be (P, K, bs, hd) and alike; got "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    _, kh, bs, khd = k_pages.shape
    if khd != hd or kh <= 0 or h % kh:
        raise ValueError(f"shapes q {tuple(q.shape)} / pages "
                         f"{tuple(k_pages.shape)}: need matching hd and "
                         "H % K == 0")
    if not 0 < hd <= MAX_HEAD_DIM or bs <= 0:
        raise ValueError(f"head_dim {hd} must be in 1..{MAX_HEAD_DIM} and "
                         "the pages non-empty")
    if q.dtype not in DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k_pages.dtype}/"
                         f"{v_pages.dtype}: need one of float32, bfloat16 "
                         "for all three")
    if q.stride(-1) != 1 or k_pages.stride(-1) != 1 \
            or v_pages.stride(-1) != 1:
        raise ValueError("q and the pages need a unit stride over hd")
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or block_tables.shape[1] == 0 \
            or block_tables.dtype != torch.int32 \
            or block_tables.stride(1) != 1:
        raise ValueError("block_tables must be a (B, nb) int32 tensor with "
                         "nb > 0 and a unit stride over nb")
    for t in (k_pages, v_pages, block_tables):
        if t.device != q.device:
            raise ValueError(f"all tensors must be on {q.device}")


def check_lengths(t: torch.Tensor, b: int, name: str,
                  device: torch.device) -> None:
    if t.shape != (b,) or t.dtype != torch.int32 or not t.is_contiguous() \
            or t.device != device:
        raise ValueError(f"{name} must be a contiguous (B,) int32 tensor "
                         f"on {device}")


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, hd); k_pages/v_pages: (P, K, bs, hd), any strides with a
    unit stride over hd (one layer of the port's (L, P, K, bs, hd) store
    is fine); block_tables: (B, nb) int32 page ids; lengths: (B,) int32,
    the valid tokens per row (at most nb * bs).  Returns (B, H, hd) in q's
    dtype.  float32 or bfloat16 in, fp32 arithmetic."""
    if not q.is_cuda:
        raise ValueError("paged_decode_attention launches a CUDA kernel; "
                         f"got a tensor on {q.device}")
    if q.dim() != 3:
        raise ValueError(f"q must be (B, H, hd); got {tuple(q.shape)}")
    b, h, hd = q.shape
    check_pages(q, k_pages, v_pages, block_tables, b, h, hd)
    check_lengths(lengths, b, "lengths", q.device)
    _, kh, bs, _ = k_pages.shape
    nb = block_tables.shape[1]

    out = torch.empty((b, h, hd), dtype=q.dtype, device=q.device)
    n_split, split_keys = tile_plan.decode_split(
        "paged_decode_attention", DTYPES[q.dtype], b, h, kh, hd, nb * bs,
        q.device.index)
    part = (torch.empty((b, h, n_split, hd + 2), dtype=torch.float32,
                        device=q.device) if n_split > 1 else out)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _entry()(
            DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), part.data_ptr(), b, h, kh, nb, bs, hd, n_split,
            split_keys, _strides(q, k_pages, v_pages, block_tables, out),
            stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"CUDA error {rc}")
    counts.launched(paged_decode_attention)
    return out


paged_decode_attention.launches = 0
