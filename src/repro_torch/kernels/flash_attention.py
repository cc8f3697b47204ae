"""Causal GQA flash attention on the card: wrapper around
``csrc/flash_attention.cu``.

The port of the JAX package's Pallas kernel ``kernels/flash_attention.py``
(query head h reads kv head h // G, online softmax over key tiles, tiles
above the diagonal skipped), extended with the arguments the port's
prefill needs: ``q_offset`` (absolute position of query 0), ``kv_len``
(keys j >= kv_len are invisible) and a sliding ``window``.  The kernel
computes on the tensor cores (3xTF32 for fp32 operands) over (position,
head) rows, so a K/V tile serves the G query heads of its kv head.  This
wrapper checks its arguments, picks the split over keys against the
blocks the card runs at once (asked of the kernel's occupancy once per
shape class), launches the CUDA kernel on the current stream and counts
the launch; it never computes on the CPU (``ops.flash_attention`` sends
CPU tensors to ``ref.mha_reference``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import build
from . import tile_plan

MAX_HEAD_DIM = 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 32           # keys per shared-memory tile (the kernel's kKT)

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                   _I, _I, _I, _I, ctypes.POINTER(ctypes.c_longlong), _P]
    fn.restype = _I
    return lib


def split_plan(b: int, s: int, h: int, kh: int, q_offset: int, kv_len: int,
               causal: bool, window: int, slots: int) -> Tuple[int, int, int]:
    """(n_split, split_keys, key_lo): split i covers the keys [key_lo + i *
    split_keys, key_lo + (i + 1) * split_keys), key_lo the first key some
    query sees rounded down to a whole tile.  The launch's blocks of ROWS
    (position, head) rows are planned as paged span attention's are
    (``tile_plan.split_plan``) over the keys the launch sees:
    a split only where the blocks fill less than the ``slots`` the card
    runs at once, at most ceil(keys / SPLIT_KEYS) splits."""
    hi = min(kv_len, q_offset + s) if causal else kv_len
    lo = max(0, q_offset - window + 1) if causal and window else 0
    lo = lo // TILE * TILE
    n_split, split_keys = tile_plan.split_plan(b, s, h, kh, max(0, hi - lo),
                                            slots)
    return n_split, split_keys, lo


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0,
                    kv_len: Optional[int] = None,
                    window: int = 0) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, K, Skv, hd) with H % K == 0; any
    strides with a unit stride over hd.  Query i is at absolute position
    ``q_offset + i`` and sees key j iff j < kv_len (default Skv) and, when
    causal, j <= q_offset + i and (window > 0) j > q_offset + i - window;
    a query that sees no key gives 0.  Returns (B, H, S, hd) in q's dtype,
    laid out like q.  float32 or bfloat16 in, fp32-accurate arithmetic
    (3xTF32 tensor-core products for fp32 operands)."""
    if not q.is_cuda:
        raise ValueError("flash_attention launches a CUDA kernel; got a "
                         f"tensor on {q.device}")
    b, h, s, hd = q.shape
    if k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"k/v must be (B, K, Skv, hd) and alike; got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    kb, kh, skv, khd = k.shape
    if kb != b or khd != hd or kh <= 0 or h % kh:
        raise ValueError(f"shapes q {tuple(q.shape)} / kv {tuple(k.shape)}: "
                         "need matching B and hd and H % K == 0")
    if not 0 < hd <= MAX_HEAD_DIM or s <= 0 or skv <= 0:
        raise ValueError(f"head_dim {hd} must be in 1..{MAX_HEAD_DIM} and "
                         "S, Skv positive")
    kv_len = skv if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= skv or q_offset < 0 or window < 0:
        raise ValueError(f"need 0 <= kv_len ({kv_len}) <= Skv ({skv}), "
                         f"q_offset ({q_offset}) >= 0, window ({window}) >= 0")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one "
                         "of float32, bfloat16 for all three")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("q, k and v need a unit stride over hd")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"all tensors must be on {q.device}")

    out = torch.empty_like(q)   # keeps q's layout (dense strides)
    slots, _ = tile_plan.card_occupancy(
        "flash_attention", DTYPES[q.dtype], hd,
        min(tile_plan.ROWS, s * (h // kh)), q.device.index)
    n_split, split_keys, key_lo = split_plan(b, s, h, kh, int(q_offset),
                                             kv_len, causal, int(window),
                                             slots)
    part = (torch.empty((b, s, h, n_split, hd + 2), dtype=torch.float32,
                        device=q.device) if n_split > 1 else out)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib().flash_attention_launch(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), part.data_ptr(), b, h, kh, s, hd, int(q_offset),
            kv_len, int(window), int(causal), n_split, split_keys, key_lo,
            strides, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
