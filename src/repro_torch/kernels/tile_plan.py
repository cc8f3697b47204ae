"""Block plan shared by the attention kernels that multiply on the tensor
cores (``csrc/paged_append_attention.cu`` and ``csrc/flash_attention.cu``).

Both kernels give a block ROWS (position, head) rows and, when those
blocks fill less than the card runs at once, split the keys over more
blocks.  ``card_occupancy`` asks a kernel's C entry ``<name>_slots`` how
many blocks that is; ``split_plan`` picks the split against it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build

ROWS = 64           # (position, head) rows per block (the kernels' kRows)
SPLIT_KEYS = 256    # keys per split, at the least
# the cost of one more split, as a share of a whole row's keys (a block's Q
# staging and epilogue, the merge's reads)
SPLIT_COST = 1 / 32


@functools.cache
def card_occupancy(name: str, dtype: int, hd: int, rows: int,
                   device: int) -> Tuple[int, int]:
    """(blocks the card runs at once, dynamic shared memory bytes of one
    block) of kernel ``name`` for this dtype, hd and rows = queries x G
    (only ``min(ROWS, rows)`` changes the block's shared memory)."""
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
               slots: int) -> Tuple[int, int]:
    """(n_split, split_keys): when the launch's blocks of ROWS (position,
    head) rows (b rows of t queries over h heads, kh kv heads) fill less
    than the ``slots`` blocks the card runs at once, split the ``keys``
    over more blocks, never below SPLIT_KEYS keys a split.  Of the splits
    that fill at least one wave, take the one with the least modelled
    time: waves x (1 / n_split + SPLIT_COST)."""
    base = b * kh * -(-t * (h // kh) // ROWS)
    n_max = max(1, -(-keys // SPLIT_KEYS))
    n_split = 1
    if base < slots:
        n_min = min(n_max, -(-slots // base))
        n_split = min(range(n_min, n_max + 1), key=lambda n: (
            -(-base * n // slots) * (1 / n + SPLIT_COST), n))
    split_keys = -(-keys // n_split)
    split_keys = -(-split_keys // 32) * 32
    return n_split, split_keys
