"""The backward of causal GQA attention on the card: wrapper around
``csrc/flash_attention_bwd.cu``.

The gradient of kernel #2 (``flash_attention``) on the training forward:
given q, k, v, #2's output o and the output's gradient do, up to three
launches (dQ, the row logsumexp and D = rowsum(do * o) a query tile; dK
and dV a key tile of one query head, both with their products on the
tensor cores; with G > 1 the G heads' partials summed) write dq, dk and
dv, deterministically (no atomics).  The launches' grids, threads and
shared memory come from ``tile_plan.bwd_launch``, which the C entry checks
against its kernels and launches; the scratch (``scratch``) from
``tile_plan.bwd_scratch``.  The JAX
package has no such kernel: it differentiates XLA attention.  Its
contract is the training forward's case, ``check_contract``: causal from
position 0 over S keys, no window, float32, head_dim up to 128.
``ops.flash_attention`` checks it once, before kernel #2's forward
launches; this wrapper checks only what it alone sees (o and do),
launches the kernels on the current stream and counts one launch a
call (the C entry also rejects head_dim > 128 and H % K != 0); it
never computes on the CPU (the CPU path differentiates ``ref.mha_reference`` with torch
autograd, and ``ref.mha_backward_reference`` is the plain version of this
kernel).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import build, counts, tile_plan

MAX_HEAD_DIM = 128

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib():
    lib = build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = [_P] * 11 + [_I] * 5 + [ctypes.POINTER(ctypes.c_longlong),
                                          ctypes.POINTER(_I), _P]
    fn.restype = _I
    return lib


def check_contract(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, q_offset: int = 0,
                   kv_len: Optional[int] = None, window: int = 0) -> None:
    """Raise unless attention over these arguments is the case the
    backward kernel takes: q (B, H, S, hd), k and v (B, K, S, hd), H % K
    == 0, hd <= 128, float32, causal from position 0 over all S keys, no
    window."""
    b, h, s, hd = q.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != b \
            or k.shape[2] != s or k.shape[3] != hd or h % k.shape[1]:
        raise ValueError(f"backward kernel: need q (B, H, S, hd) and k, v "
                         f"(B, K, S, hd) with H % K == 0; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"backward kernel: head_dim {hd} must be in "
                         f"1..{MAX_HEAD_DIM}")
    if not causal or q_offset != 0 or window != 0 \
            or (kv_len is not None and kv_len != s):
        raise ValueError(
            "the attention backward kernel takes the training forward's "
            "case only: causal from position 0 over all S keys, no window "
            f"(got causal={causal}, q_offset={q_offset}, kv_len={kv_len}, "
            f"window={window})")
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise ValueError(f"backward kernel: float32 only; got {q.dtype}/"
                         f"{k.dtype}/{v.dtype}")


def scratch(b: int, h: int, kh: int, s: int, hd: int,
            device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernels' float32 scratch, one allocation: (lse (b, h, s), D (b,
    h, s), dK and dV partials (2 * b * h * s * hd floats with G > 1, else
    empty)), sized by ``tile_plan.bwd_scratch``."""
    n_stats, n_part = tile_plan.bwd_scratch(b, h, kh, s, hd)
    buf = torch.empty(n_stats + n_part, dtype=torch.float32, device=device)
    stats = buf[:n_stats].view(2, b, h, s)
    return stats[0], stats[1], buf[n_stats:]


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of o = causal softmax(q k^T / sqrt(hd)) v with GQA
    (query head h reads kv head h // G): q, o, do (B, H, S, hd); k, v
    (B, K, S, hd); float32 CUDA tensors, any strides with a unit stride
    over hd (do is copied if it has none).  q, k and v must meet
    ``check_contract``, which the caller has checked.  dk and dv sum over
    the G query heads of each kv head.  Returns tensors laid out like q,
    k and v."""
    if not q.is_cuda:
        raise ValueError("flash_attention_bwd launches a CUDA kernel; got a "
                         f"tensor on {q.device}")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"be shaped like q {tuple(q.shape)}")
    if o.dtype != torch.float32 or do.dtype != torch.float32:
        raise ValueError(f"o and do must be float32; got {o.dtype}, "
                         f"{do.dtype}")
    if o.device != q.device or do.device != q.device:
        raise ValueError(f"o and do must be on {q.device}")
    if do.stride(-1) != 1:
        do = do.contiguous()
    if any(t.stride(-1) != 1 for t in (q, k, v, o)):
        raise ValueError("q, k, v and o need a unit stride over hd")
    b, h, s, hd = q.shape
    kh = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    lse, dsum, part = scratch(b, h, kh, s, hd, q.device)
    tensors = (q, k, v, o, do, dq, dk, dv)
    strides = (ctypes.c_longlong * 24)(*(x for t in tensors
                                         for x in t.stride()[:3]))
    plan = (_I * 6)(*tile_plan.bwd_launch(b, h, kh, s, hd))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib().flash_attention_bwd_launch(
            *(t.data_ptr() for t in tensors), lse.data_ptr(),
            dsum.data_ptr(), part.data_ptr() if part.numel() else None, b,
            h, kh, s, hd, strides, plan, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {rc}")
    counts.launched(flash_attention_bwd)
    return dq, dk, dv


flash_attention_bwd.launches = 0
