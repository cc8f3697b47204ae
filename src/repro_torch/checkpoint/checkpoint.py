"""Flat-npz checkpoints, in the JAX package's format.

Keys are '/'-joined paths into the nested params dict
(``layers/attn/wq``), arrays keep the stacked-over-layers layout, and
metadata rides along as ``<path>.meta.json``.  The JAX package reads
what ``save_checkpoint`` writes and the port reads what the JAX package
writes.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .. import device as devices
from ..models.model import flatten, unflatten


def params_from_numpy(flat: Mapping[str, np.ndarray],
                      device="cuda") -> Dict:
    """Flat '/'-keyed numpy arrays (an npz's contents, or the JAX
    package's params flattened the same way) -> the port's nested params
    dict of tensors on ``device``."""
    dev = devices.resolve(device)
    return unflatten({k: torch.tensor(np.asarray(a), device=dev)
                      for k, a in flat.items()})


def params_to_numpy(params: Dict) -> Dict[str, np.ndarray]:
    return {k: t.detach().cpu().numpy() for k, t in flatten(params).items()}


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, params: Dict,
                    meta: Optional[Dict] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **params_to_numpy(params))
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f, indent=2, default=str)


def load_checkpoint(path: str, device="cuda",
                    expect: Optional[Mapping[str, tuple]] = None) -> Dict:
    """Read an npz checkpoint onto ``device``.  ``expect`` maps each
    required key to its shape (``{k: s.shape for k, s in
    Model(cfg).spec().items()}``); a missing key or a wrong shape
    raises."""
    with np.load(_npz_path(path)) as data:
        flat = {k: data[k] for k in data.files}
    for key, shape in (expect or {}).items():
        if key not in flat:
            raise KeyError(f"checkpoint {path} missing param {key}")
        if tuple(flat[key].shape) != tuple(shape):
            raise ValueError(f"checkpoint {path}: {key} has shape "
                             f"{flat[key].shape}, expected {tuple(shape)}")
    return params_from_numpy(flat, device)


def load_meta(path: str) -> Dict:
    with open(path + ".meta.json") as f:
        return json.load(f)
