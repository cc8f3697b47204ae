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
the decode kernels' choice of copy width.  ``bwd_launch`` is the
attention backward's launch plan (``csrc/flash_attention_bwd.cu``), which
its wrapper passes the C entry and the C entry checks and launches;
``bwd_plan`` adds each block's tile steps and the scratch.
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


# the attention backward's blocks (csrc/flash_attention_bwd.cu, whose
# launch refuses any other plan): BWD_ROWS query rows a dq block and keys a
# dkv block (16 a warp), streamed tiles of BWD_STEP rows, BWD_THREADS
# threads; the G-partial sum in blocks of BWD_SUM_THREADS, at most
# BWD_SUM_BLOCKS of them (any count covers every element)
BWD_ROWS = 64
BWD_STEP = 32
BWD_THREADS = 128
BWD_SUM_THREADS = 256
BWD_SUM_BLOCKS = 4096


def bwd_smem(hd: int) -> Tuple[int, int]:
    """Dynamic shared memory bytes of a dq and a dkv block at this
    head_dim (padded to 32, 64 or 128): resident rows at a stride of HD +
    8 floats, streamed rows read down their columns at HD + 4."""
    pad = 32 if hd <= 32 else 64 if hd <= 64 else 128
    la, lb = pad + 8, pad + 4
    dq = 4 * (2 * BWD_ROWS * la + BWD_STEP * lb + BWD_STEP * la + BWD_ROWS)
    dkv = 4 * (2 * BWD_ROWS * la + 2 * BWD_STEP * lb + 2 * BWD_STEP)
    return dq, dkv


def bwd_scratch(b: int, h: int, kh: int, s: int, hd: int) -> Tuple[int, int]:
    """Float32 scratch of a backward call: (lse and D, b * h * s each; the
    dK and dV partials of the G query heads of each kv head, 2 * b * h * s
    * hd, or 0 when G = 1)."""
    return 2 * b * h * s, 2 * b * h * s * hd if h > kh else 0


@functools.lru_cache(maxsize=1024)
def bwd_launch(b: int, h: int, kh: int, s: int,
               hd: int) -> Tuple[int, int, int, int, int, int]:
    """The plan the wrapper passes ``flash_attention_bwd_launch`` for q (b,
    h, s, hd) over k, v (b, kh, s, hd): (tiles of BWD_ROWS rows, the z
    extent of the dq and dkv grids (h, b, tiles); their threads; the dq
    and the dkv block's dynamic shared memory bytes; sum_kernel's blocks,
    0 when G = 1; its threads)."""
    dq_smem, dkv_smem = bwd_smem(hd)
    n = b * kh * s * hd
    sum_blocks = min(-(-n // BWD_SUM_THREADS), BWD_SUM_BLOCKS) \
        if h > kh else 0
    return (-(-s // BWD_ROWS), BWD_THREADS, dq_smem, dkv_smem, sum_blocks,
            BWD_SUM_THREADS)


def bwd_plan(b: int, h: int, kh: int, s: int, hd: int) -> dict:
    """``bwd_launch`` as launches (dq_kernel, dkv_kernel, and sum_kernel
    when G > 1: each one's grid, threads and dynamic shared memory), with
    the tile steps of each block in launch order (a dq block walks the key
    tiles at or before its rows once, from the last query tile; a dkv
    block walks the query tiles of one head at or after its keys, from
    the first key tile), the longest and mean dkv walk against ``n_tiles``
    = ceil(s / BWD_STEP), and the scratch floats."""
    tiles, threads, dq_smem, dkv_smem, sum_blocks, sum_threads = \
        bwd_launch(b, h, kh, s, hd)
    launches = [
        dict(name="dq_kernel", grid=(h, b, tiles), threads=threads,
             smem_bytes=dq_smem),
        dict(name="dkv_kernel", grid=(h, b, tiles), threads=threads,
             smem_bytes=dkv_smem)]
    if sum_blocks:
        launches.append(dict(name="sum_kernel", grid=(sum_blocks, 1, 1),
                             threads=sum_threads, smem_bytes=0))
    dq_steps = [-(-min(s, BWD_ROWS * (t + 1)) // BWD_STEP)
                for t in reversed(range(tiles))]
    dkv_steps = [-(-(s - BWD_ROWS * t) // BWD_STEP) for t in range(tiles)]
    n_stats, n_part = bwd_scratch(b, h, kh, s, hd)
    return dict(launches=launches, n_tiles=-(-s // BWD_STEP),
                dq_steps=dq_steps, dkv_steps=dkv_steps,
                dkv_longest=max(dkv_steps),
                dkv_mean=sum(dkv_steps) / len(dkv_steps),
                scratch_floats=dict(stats=n_stats, partials=n_part),
                scratch_bytes=4 * (n_stats + n_part))
