"""The exact tensor-parallel parameter table: which dim of each dense
parameter a rank slices, or None for a parameter every rank holds
whole.  The port of the JAX package's ``EXACT_TP_RULES``
(``models/layers.py``) with ``exact_tp_activation_rules``
(``models/sharding.py``), as its ``serving/tp.py`` documents them.

Only the output dims of the first GEMM of each pair are sliced: the
q/k/v projections on their heads, the MLP's up projections on the ffn
hidden dim.  Every operand of a contraction that follows is whole: the
output projection ``wo`` and the down projection, the norms, the
embedding and the unembedding.  The ranks all-gather the heads before
``wo`` and the hidden before the down projection
(``serving.tp.TPContext``), so each contraction runs on whole operands
in tp=1's order and a column slice of a GEMM is the only split.

The JAX package's ``EXACT_TP_RULES`` also shard ``wo`` (on heads) and
``w_down`` (on the hidden dim), which its own design rules out; the port
follows the design.  Dims count from the end, so the table reads a
layer's tensors and the stacked (L, ...) ones alike.  There is no
ambient rules context: callers pass the rank and the degree.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

EXACT_TP: Dict[str, Optional[int]] = {
    "wq": -2, "wk": -2, "wv": -2,           # (d, heads, hd): the heads
    "w_gate": -1, "w_up": -1,               # (d, ff): the ffn hidden
    "w_in": -1, "b_in": -1,                 # gelu MLP: (d, ff), (ff,)
    "wo": None, "w_down": None,             # contractions after a gather
    "w_out": None, "b_out": None,
    "scale": None, "bias": None,            # norms
    "tok_embed": None, "unembed": None,
}


def sliced_dim(key: str) -> Optional[int]:
    """The sliced dim (negative) of the parameter at '/'-key ``key``, or
    None; raises for a parameter the table does not hold (the dense
    family's only)."""
    leaf = key.rsplit("/", 1)[-1]
    if leaf not in EXACT_TP:
        raise KeyError(f"{key}: no exact-TP rule (the table holds the "
                       "dense family's parameters)")
    return EXACT_TP[leaf]


def local_shape(key: str, shape: Tuple[int, ...],
                tp_size: int) -> Tuple[int, ...]:
    """The shape of one rank's slice of the parameter ``key``."""
    dim = sliced_dim(key)
    if dim is None:
        return tuple(shape)
    out = list(shape)
    if out[dim] % tp_size:
        raise ValueError(f"tp_size={tp_size} must divide dim {dim} of "
                         f"{key} {tuple(shape)}")
    out[dim] //= tp_size
    return tuple(out)


def shard_params(params: Dict, rank: int, tp_size: int,
                 prefix: str = "") -> Dict:
    """Rank ``rank``'s shard of a nested parameter tree: each sliced
    tensor as a contiguous copy of its rank-th contiguous slice, each
    whole one as the same tensor."""
    out = {}
    for k, v in params.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out[k] = shard_params(v, rank, tp_size, key + "/")
            continue
        dim = sliced_dim(key)
        if dim is None:
            out[k] = v
            continue
        n = local_shape(key, v.shape, tp_size)[dim]
        out[k] = torch.narrow(v, dim, rank * n, n).contiguous()
    return out
