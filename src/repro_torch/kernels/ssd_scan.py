"""Mamba2 chunked SSD scan on the card: wrapper around
``csrc/ssd_scan.cu``.

The port of the JAX package's Pallas kernel ``kernels/ssd_scan.py``
(``ssd_scan``): the intra-chunk quadratic term with the exp(segsum(a dt))
decay matrix plus the inter-chunk state recurrence, emitting y and the
final state.  The kernels follow ``models.mamba2.ssd_chunked``'s steps
with the chunks spread over blocks and every product on the tensor cores
(3xTF32 ``mma.sync`` for fp32 operands): a chunk launch (each chunk's
cumulative decay and state contribution, and C.B^T once per group), a
pass over the chunks' states (skipped with one chunk), and a scan launch
that writes y.  This wrapper checks its arguments, allocates the scratch
those launches share (one float32 buffer, ``tile_plan.ssd_scratch``),
launches them on the current stream and counts one scan a call; it never
computes on the CPU (``ops.ssd`` sends CPU tensors to
``models.mamba2.ssd_chunked``).  ``plan`` reports how a call runs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import build
from . import tile_plan

MAX_CHUNK = 128
MAX_STATE = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _entry():
    fn = build.load("ssd_scan").ssd_scan_launch
    fn.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                   _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                   _L, _L, _L, _P, ctypes.POINTER(_L)]
    fn.restype = _I
    return fn


def _check(x, dt, a, b, c, chunk, init_state):
    """Raises ValueError on arguments the kernels do not take."""
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
    if init_state is not None and (
            tuple(init_state.shape) != (bsz, h, p, n)
            or init_state.dtype != torch.float32
            or not init_state.is_contiguous()):
        raise ValueError(f"init_state must be a contiguous float32 "
                         f"{(bsz, h, p, n)}; got {init_state.dtype} "
                         f"{tuple(init_state.shape)}")
    for t in (dt, a, b, c) + (() if init_state is None else (init_state,)):
        if t.device != x.device:
            raise ValueError(f"all tensors must be on {x.device}")


def _call(x, dt, a, b, c, chunk, init_state, plan_out=None):
    """Checks the arguments, allocates y, the final state and the scratch
    and calls the C entry: a launch, or with ``plan_out`` (19 longs) the
    plan of this very call.  Returns (y, final state)."""
    _check(x, dt, a, b, c, chunk, init_state)
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    a = a.contiguous()
    y = torch.empty((bsz, l, h, p), dtype=x.dtype, device=x.device)
    final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    n_cum, n_cb, n_st = tile_plan.ssd_scratch(bsz, l, h, p, g, n, chunk)
    scratch = torch.empty(n_cum + n_cb + n_st, dtype=torch.float32,
                          device=x.device)
    cum = scratch.data_ptr()
    cb = cum + 4 * n_cum
    st = cb + 4 * n_cb if n_st else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _entry()(
            DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a.data_ptr(),
            b.data_ptr(), c.data_ptr(),
            None if init_state is None else init_state.data_ptr(),
            y.data_ptr(), final.data_ptr(), cum, cb, st,
            bsz, l, h, p, g, n, int(chunk),
            x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2),
            b.stride(0), b.stride(1), b.stride(2),
            c.stride(0), c.stride(1), c.stride(2), stream, plan_out)
    if rc != 0:
        what = "plan query" if plan_out is not None else "kernel launch"
        raise RuntimeError(f"ssd_scan {what} failed: CUDA error {rc}")
    return y, final


def plan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
         b: torch.Tensor, c: torch.Tensor, chunk: int,
         init_state: Optional[torch.Tensor] = None) -> dict:
    """How ``ssd_scan`` on these arguments runs on x's card, launching
    nothing: ``tile_plan.ssd_plan`` (route, chunks, scratch) with each
    launch's grid blocks, threads and dynamic shared memory as the C entry
    reports them for this call, and its registers, blocks an SM runs at
    once and spill bytes; ``copies``: ``"16-byte"`` (cp.async) or
    ``"element"``, as the call's bases and strides allow; ``mirror`` is
    ``tile_plan.ssd_plan``'s own numbers."""
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    mirror = tile_plan.ssd_plan(bsz, l, h, p, g, n, chunk)
    out = (_L * 19)()
    _call(x, dt, a, b, c, chunk, init_state, out)
    launches = [dict(name=m["name"], blocks=out[6 * k],
                     threads=out[6 * k + 1], registers=out[6 * k + 2],
                     smem_bytes=out[6 * k + 3], blocks_per_sm=out[6 * k + 4],
                     spill_bytes=out[6 * k + 5])
                for k, m in enumerate(mirror["launches"])]
    return {**mirror, "launches": launches,
            "copies": "16-byte" if out[18] else "element", "mirror": mirror}


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, H, P) float32 or bfloat16 with a unit stride over P;
    dt: (B, L, H) float32, any strides; a: (H,) float32; b, c:
    (B, L, G, N) in x's dtype with a unit stride over N, H % G == 0;
    init_state: (B, H, P, N) float32 (zeros when None).  L must be a
    multiple of ``chunk`` (1..128), N at most 256.  Returns (y (B, L, H, P)
    in x's dtype, final state (B, H, P, N) float32); fp32-accurate
    arithmetic (3xTF32 tensor-core products, fp32 accumulation)."""
    y, final = _call(x, dt, a, b, c, chunk, init_state)
    ssd_scan.launches += 1
    return y, final


ssd_scan.launches = 0
