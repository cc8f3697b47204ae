"""Mamba2 chunked SSD scan on the card: wrapper around
``csrc/ssd_scan.cu``.

The port of the JAX package's Pallas kernel ``kernels/ssd_scan.py``
(``ssd_scan``): the intra-chunk quadratic term with the exp(segsum(a dt))
decay matrix plus the inter-chunk state recurrence, emitting y and the
final state.  This wrapper checks its arguments, launches the CUDA kernel
on the current stream and counts the launch; it never computes on the CPU
(``ops.ssd`` sends CPU tensors to ``models.mamba2.ssd_chunked``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import build

MAX_CHUNK = 128
MAX_STATE = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _entry():
    fn = build.load("ssd_scan").ssd_scan_launch
    fn.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                   _I, _I, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                   _P]
    fn.restype = _I
    return fn


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, H, P) float32 or bfloat16 with a unit stride over P;
    dt: (B, L, H) float32, any strides; a: (H,) float32; b, c:
    (B, L, G, N) in x's dtype with a unit stride over N, H % G == 0;
    init_state: (B, H, P, N) float32 (zeros when None).  L must be a
    multiple of ``chunk`` (1..128), N at most 256.  Returns (y (B, L, H, P)
    in x's dtype, final state (B, H, P, N) float32); fp32 arithmetic."""
    if not x.is_cuda:
        raise ValueError("ssd_scan launches a CUDA kernel; got a tensor on "
                         f"{x.device}")
    if x.dim() != 4 or b.dim() != 4 or c.shape != b.shape:
        raise ValueError(f"x must be (B, L, H, P) and b, c (B, L, G, N) "
                         f"alike; got {tuple(x.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if b.shape[:2] != (bsz, l) or g <= 0 or h % g:
        raise ValueError(f"shapes x {tuple(x.shape)} / b {tuple(b.shape)}: "
                         "need matching B and L and H % G == 0")
    if tuple(dt.shape) != (bsz, l, h) or tuple(a.shape) != (h,):
        raise ValueError(f"dt must be (B, L, H) and a (H,); got "
                         f"{tuple(dt.shape)}, {tuple(a.shape)}")
    if not 1 <= chunk <= MAX_CHUNK or l % chunk or not 1 <= n <= MAX_STATE:
        raise ValueError(f"chunk {chunk} must be in 1..{MAX_CHUNK} and "
                         f"divide L ({l}); N ({n}) in 1..{MAX_STATE}")
    if x.dtype not in DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"dtypes x {x.dtype} / b {b.dtype} / c {c.dtype}: "
                         "need one of float32, bfloat16 for all three")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"dt ({dt.dtype}) and a ({a.dtype}) must be "
                         "float32")
    if x.stride(-1) != 1 or b.stride(-1) != 1 or c.stride(-1) != 1:
        raise ValueError("x, b and c need a unit stride over their last "
                         "axis")
    if init_state is None:
        init_state = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                                 device=x.device)
    if tuple(init_state.shape) != (bsz, h, p, n) \
            or init_state.dtype != torch.float32 \
            or not init_state.is_contiguous():
        raise ValueError(f"init_state must be a contiguous float32 "
                         f"{(bsz, h, p, n)}; got {init_state.dtype} "
                         f"{tuple(init_state.shape)}")
    for t in (dt, a, b, c, init_state):
        if t.device != x.device:
            raise ValueError(f"all tensors must be on {x.device}")
    a = a.contiguous()

    y = torch.empty((bsz, l, h, p), dtype=x.dtype, device=x.device)
    final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _entry()(DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(),
                      a.data_ptr(), b.data_ptr(), c.data_ptr(),
                      init_state.data_ptr(), y.data_ptr(), final.data_ptr(),
                      bsz, l, h, p, g, n, int(chunk),
                      x.stride(0), x.stride(1), x.stride(2),
                      dt.stride(0), dt.stride(1), dt.stride(2),
                      b.stride(0), b.stride(1), b.stride(2),
                      c.stride(0), c.stride(1), c.stride(2), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    ssd_scan.launches += 1
    return y, final


ssd_scan.launches = 0
