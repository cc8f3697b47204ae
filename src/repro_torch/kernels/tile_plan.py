"""Block plan shared by the attention kernels: the two that multiply on
the tensor cores (``csrc/paged_append_attention.cu``,
``csrc/flash_attention.cu``) and the two flash-decode kernels
(``csrc/decode_attention.cu``, ``csrc/paged_decode_attention.cu``); and
the SSD scan's launches and scratch (``csrc/ssd_scan.cu``, ``ssd_plan``).

The tensor-core kernels give a block ROWS (position, head) rows, the
decode kernels GROUP query heads of one kv head; when those blocks fill
less than the card runs at once, the keys are split over more blocks.
``card_occupancy`` asks a kernel's C entry ``<name>_slots`` how many
blocks that is; ``split_plan`` picks the split against it, and
``decode_split`` does both for a decode launch.  ``vector_bytes`` mirrors
the decode kernels' choice of copy width.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from . import build

ROWS = 64           # (position, head) rows per block (the kernels' kRows)
GROUP = 16          # query heads per decode block, at most (kGroup)
SPLIT_KEYS = 256    # at most ceil(keys / SPLIT_KEYS) splits
# the cost of one more split, as a share of a whole row's keys (a block's Q
# staging and epilogue, the merge's reads)
SPLIT_COST = 1 / 32


@functools.cache
def card_occupancy(name: str, dtype: int, hd: int, rows: int,
                   device: int) -> Tuple[int, int]:
    """(blocks the card runs at once, dynamic shared memory bytes of one
    block) of kernel ``name`` for this dtype, hd and rows = queries x G
    (the tensor-core kernels: only ``min(ROWS, rows)`` changes the block's
    shared memory; the decode kernels: G, whose bucket sets the
    registers)."""
    fn = getattr(build.load(name), f"{name}_slots")
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    out, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = fn(dtype, hd, rows, ctypes.byref(out), ctypes.byref(smem))
    if rc != 0 or out.value <= 0:
        raise RuntimeError(f"{name} occupancy query failed: CUDA error {rc}, "
                           f"{out.value} blocks")
    return out.value, smem.value


def split_plan(b: int, t: int, h: int, kh: int, keys: int,
               slots: int, rows: int = ROWS) -> Tuple[int, int]:
    """(n_split, split_keys): when the launch's blocks of ``rows``
    (position, head) rows (b rows of t queries over h heads, kh kv heads)
    fill less than the ``slots`` blocks the card runs at once, split the
    ``keys`` over more blocks, at most ceil(keys / SPLIT_KEYS) of them.  Of
    the splits that fill at least one wave, take the one with the least
    modelled time: waves x (1 / n_split + SPLIT_COST)."""
    base = b * kh * -(-t * (h // kh) // rows)
    n_max = max(1, -(-keys // SPLIT_KEYS))
    n_split = 1
    if base < slots:
        n_min = min(n_max, -(-slots // base))
        n_split = min(range(n_min, n_max + 1), key=lambda n: (
            -(-base * n // slots) * (1 / n + SPLIT_COST), n))
    split_keys = -(-keys // n_split)
    split_keys = -(-split_keys // 32) * 32
    return n_split, split_keys


@functools.lru_cache(maxsize=1024)
def decode_split(name: str, dtype: int, b: int, h: int, kh: int, hd: int,
                 keys: int, device: int) -> Tuple[int, int]:
    """(n_split, split_keys) of a decode launch of kernel ``name``: b rows
    of h query heads over kh kv heads, a cache of ``keys`` slots (the
    capacity the host knows, never the device's lengths), blocks of GROUP
    query heads planned against the card's occupancy."""
    slots, _ = card_occupancy(name, dtype, hd, h // kh, device)
    return split_plan(b, 1, h, kh, keys, slots, rows=GROUP)


def decode_plan(name: str, dtype: int, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, keys: int, strides: Sequence[int]) -> dict:
    """How decode kernel ``name`` runs on q (B, H, hd) over K/V ``k``,
    ``v`` (dim 1 the kv heads) of ``keys`` slots a row, with the element
    strides its launch passes (K's and V's at [2:8]): the split over keys
    (``n_split``, ``split_keys``), the blocks the card runs at once and
    the dynamic shared memory of one (``slots``, ``smem_bytes``), and the
    copy width in bytes the C entry picks (``vector_bytes``) beside this
    module's mirror of its rule (``vector_bytes_mirror``).  CUDA tensors
    only; the launches do not call it."""
    b, h, hd = q.shape
    kh = k.shape[1]
    n_split, split_keys = decode_split(name, dtype, b, h, kh, hd, keys,
                                       q.device.index)
    slots, smem = card_occupancy(name, dtype, hd, h // kh, q.device.index)
    fn = getattr(build.load(name), f"{name}_vector_bytes")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    ptrs = (k.data_ptr(), v.data_ptr())
    with torch.cuda.device(q.device):
        width = fn(dtype, hd, *ptrs,
                   (ctypes.c_longlong * len(strides))(*strides))
    return dict(n_split=n_split, split_keys=split_keys, slots=slots,
                smem_bytes=smem, vector_bytes=width,
                vector_bytes_mirror=vector_bytes(q.element_size(), hd, ptrs,
                                                 strides[2:8]))


def vector_bytes(esize: int, hd: int, ptrs: Sequence[int],
                 strides: Sequence[int]) -> int:
    """The decode kernels' copy width in bytes (``vector_bytes`` in
    ``csrc/decode_core.cuh``): the wider of 16 and 4 that divides the
    row's hd * esize bytes, every K/V base address and every element
    stride between rows times esize; else esize (element by element)."""
    for vb in (16, 4):
        if hd * esize % vb == 0 and all(p % vb == 0 for p in ptrs) \
                and all(s * esize % vb == 0 for s in strides):
            return vb
    return esize


# the SSD scan's blocks (csrc/ssd_scan.cu): SSD_PT P columns a block, k
# slices of SSD_KS, state rows in passes of SSD_NR, 8 warps
SSD_THREADS = 256
SSD_PT = 64
SSD_KS = 32
SSD_NR = 128
SSD_MAX_Q = 128


def _ssd_smem() -> Tuple[int, int]:
    """Dynamic shared memory bytes of a chunk and a scan block: a ring of
    two raw stages, the converted tiles, the per-position arrays."""
    ks, pt, nr, q = SSD_KS, SSD_PT, SSD_NR, SSD_MAX_Q
    ring = 2 * (4 * max(q * (ks + 4), ks * (nr + 8), q * ks)
                + 4 * max(ks * pt, q * ks))
    vec = 3 * q * 4 + SSD_THREADS // 32 * 4
    chunk = max(ks // 2 * (pt + 2) * 16,
                16 * (ks + 4) * 4 + q * (ks + 4) * 4)
    scan = max(q * (ks + 4) * 4 + max(ks // 2 * (pt + 2),
                                      pt * (ks // 2 + 4)) * 16,
               q * (pt + 8) * 4)
    return ring + chunk + vec, ring + scan + vec


@functools.lru_cache(maxsize=1024)
def ssd_scratch(b: int, l: int, h: int, p: int, g: int, n: int,
                q: int) -> Tuple[int, int, int]:
    """Float32 scratch of a scan, each part a whole number of 16-byte
    steps: (cum (b, h, nc, q), cb (b, g, nc, q, q rounded up to 4), st (b,
    h, nc, p n rounded up to 4), 0 with one chunk)."""
    nc = l // q
    return (_whole4(b * h * nc * q), _whole4(b * g * nc * q * _whole4(q)),
            b * h * nc * _whole4(p * n) if nc > 1 else 0)


def _whole4(floats: int) -> int:
    return -(-floats // 4) * 4


def ssd_plan(b: int, l: int, h: int, p: int, g: int, n: int,
             q: int) -> dict:
    """The mirror of ``csrc/ssd_scan.cu``'s plan for x (b, l, h, p), B/C
    (b, l, g, n) and chunks of q: the route (``one chunk``: the chunk
    launch writes the final state and the pass is skipped; else
    ``chunks``), each launch's grid blocks, threads and dynamic shared
    memory bytes (chunk, pass, scan), and the float32 scratch the wrapper
    allocates (``ssd_scratch``)."""
    nc = l // q
    npt = -(-p // SSD_PT)
    nrf = -(-q // 16)
    chunk_smem, scan_smem = _ssd_smem()
    launches = [
        dict(name="ssd_chunk_kernel", blocks=(b * h * npt + b * g * nrf) * nc,
             threads=SSD_THREADS, smem_bytes=chunk_smem),
        dict(name="ssd_pass_kernel",
             blocks=b * h * -(-(_whole4(p * n) // 4) // SSD_THREADS)
             if nc > 1 else 0, threads=SSD_THREADS, smem_bytes=0),
        dict(name="ssd_scan_kernel", blocks=b * h * npt * nc,
             threads=SSD_THREADS, smem_bytes=scan_smem)]

    scratch = dict(zip(("cum", "cb", "st"), ssd_scratch(b, l, h, p, g, n, q)))
    return dict(route="one chunk" if nc == 1 else "chunks", chunks=nc,
                launches=launches, scratch_floats=scratch,
                scratch_bytes=4 * sum(scratch.values()))
