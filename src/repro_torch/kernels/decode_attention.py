"""Flash-decode on the card: wrapper around ``csrc/decode_attention.cu``.

The port of the JAX package's Pallas kernel ``kernels/decode_attention.py``
(one query token per row against a dense KV cache, the G query heads of
a kv head as one tile, per-row ``lengths``), for any G = H / K, with
one addition: a sliding ``window`` (the JAX package masks a windowed
decode in XLA; its Pallas kernel has none).  This
wrapper checks its arguments, plans the split over keys against the
blocks the card runs at once (``tile_plan.decode_split``, from the
cache's capacity), launches the CUDA kernel on the current stream and
counts the launch; it never computes on the CPU
(``ops.decode_attention`` sends CPU tensors to ``ref.decode_reference``).

The split depends on the capacity (with a window, on ``min(capacity,
window)``, the keys a row can read) and never on ``lengths``, so a
launch
can be recorded into a CUDA graph (the fused decode loop,
``serving/engine.py``); ``counts`` says how a recorded launch is
counted.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build, counts
from . import tile_plan

MAX_HEAD_DIM = 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_STRIDES = ctypes.c_longlong * 10


@functools.cache
def _entry():
    fn = build.load("decode_attention").decode_attention_launch
    fn.argtypes = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   _I, ctypes.POINTER(ctypes.c_longlong), _P]
    fn.restype = _I
    return fn


def _strides(q, k_cache, v_cache, out) -> ctypes.Array:
    return _STRIDES(q.stride(0), q.stride(1), *k_cache.stride()[:3],
                    *v_cache.stride()[:3], out.stride(0), out.stride(1))


def window_keys(capacity: int, window: int) -> int:
    """The keys a row can read, over which the split is planned."""
    return min(capacity, window) if window else capacity


def check_window(window) -> None:
    """A window is a host int >= 0 (0: none): it plans the split."""
    if isinstance(window, bool) or not isinstance(window, int) \
            or window < 0:
        raise ValueError(f"window must be an int >= 0; got {window!r}")


def plan(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
         window: int = 0) -> dict:
    """``tile_plan.decode_plan`` of a launch on these CUDA tensors."""
    return tile_plan.decode_plan("decode_attention", DTYPES[q.dtype], q,
                                 k_cache, v_cache,
                                 window_keys(k_cache.shape[2], window),
                                 list(_strides(q, k_cache, v_cache, q)))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor, window: int = 0) -> torch.Tensor:
    """q: (B, H, hd); k_cache/v_cache: (B, K, S, hd), any strides with a
    unit stride over hd (a permuted view of a (B, S, K, hd) cache is
    fine); lengths: (B,) int32, the number of valid cache entries per
    row; window: 0, or a sliding window: row b attends over the keys
    ``lengths[b] - window <= j < lengths[b]`` only.  Returns (B, H, hd)
    in q's dtype.  float32 or bfloat16 in, fp32 arithmetic."""
    if not q.is_cuda:
        raise ValueError("decode_attention launches a CUDA kernel; "
                         f"got a tensor on {q.device}")
    b, h, hd = q.shape
    if k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"k/v caches must be (B, K, S, hd) and alike; got "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    kb, kh, s, khd = k_cache.shape
    if kb != b or khd != hd or kh <= 0 or h % kh:
        raise ValueError(f"shapes q {tuple(q.shape)} / cache "
                         f"{tuple(k_cache.shape)}: need matching B and hd "
                         "and H % K == 0")
    if not 0 < hd <= MAX_HEAD_DIM or s <= 0:
        raise ValueError(f"head_dim {hd} must be in 1..{MAX_HEAD_DIM} and "
                         f"the cache non-empty")
    if q.dtype not in DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k_cache.dtype}/{v_cache.dtype}:"
                         " need one of float32, bfloat16 for all three")
    if q.stride(-1) != 1 or k_cache.stride(-1) != 1 \
            or v_cache.stride(-1) != 1:
        raise ValueError("q, k_cache and v_cache need a unit stride over hd")
    if lengths.shape != (b,) or lengths.dtype != torch.int32 \
            or not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous (B,) int32 tensor")
    check_window(window)
    for t in (k_cache, v_cache, lengths):
        if t.device != q.device:
            raise ValueError(f"all tensors must be on {q.device}")

    out = torch.empty((b, h, hd), dtype=q.dtype, device=q.device)
    n_split, split_keys = tile_plan.decode_split(
        "decode_attention", DTYPES[q.dtype], b, h, kh, hd,
        window_keys(s, window), q.device.index)
    part = (torch.empty((b, h, n_split, hd + 2), dtype=torch.float32,
                        device=q.device) if n_split > 1 else out)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _entry()(
            DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part.data_ptr(), b, h, kh, s, hd, n_split, split_keys, window,
            _strides(q, k_cache, v_cache, out), stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {rc}")
    counts.launched(decode_attention)
    return out


decode_attention.launches = 0
