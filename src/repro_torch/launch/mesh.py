"""Tensor-parallel process groups: the TP part of the JAX package's
``launch/mesh.py`` (``make_tp_mesh``), on ``torch.distributed``.

The JAX package builds a 1-D ``("model",)`` mesh over the devices of one
process.  The port runs SPMD instead: one process a rank, each computing
on its own device (``rank_device``) and joined by a process group
(``make_tp_group``).  ``serving/tp.py`` builds its ``TPContext`` on the
group and starts the rank processes.

The backend follows from where the ranks sit: ``nccl`` when every rank
has a GPU of its own, ``gloo`` when the ranks share one card or run on
the CPU (gloo stages CUDA tensors through the host inside its
collectives).  The choice is printed and never changed after a failure:
a backend that does not start raises.
"""

from __future__ import annotations

import datetime
from typing import List, Tuple

import torch
import torch.distributed as dist

from .. import device as devices

# a collective that waits longer raises (a rank died or drifted)
GROUP_TIMEOUT_S = 120.0


def rank_device(rank: int, tp_size: int, device="cuda") -> torch.device:
    """The device rank ``rank`` of ``tp_size`` computes on: the CPU, card
    ``rank`` when the host has a card a rank, else card 0 (the ranks
    share it).  Raises when CUDA is asked for and absent."""
    dev = devices.resolve(device)
    if dev.type == "cpu":
        return dev
    n = torch.cuda.device_count()
    return torch.device("cuda", rank if n >= tp_size else 0)


def tp_backend(tp_size: int, device: torch.device) -> Tuple[str, str]:
    """(backend, why) for ranks on ``device``'s kind."""
    if device.type == "cpu":
        return "gloo", "the ranks run on the CPU"
    n = torch.cuda.device_count()
    if n >= tp_size:
        return "nccl", f"a card a rank ({n} cards)"
    return "gloo", (f"{tp_size} ranks share {n} card(s); gloo stages the "
                    "collectives through the host")


def make_tp_group(tp_size: int, rank: int, init_method: str,
                  device: torch.device) -> Tuple[str, List[str]]:
    """Join rank ``rank`` of ``tp_size`` to the default process group at
    ``init_method`` (``file://...`` or ``tcp://host:port``) with the
    backend ``tp_backend`` picks, a collective that waits longer than
    GROUP_TIMEOUT_S raising.  Returns (backend, every rank's device in
    rank order)."""
    if tp_size < 1:
        raise ValueError(f"tp_size must be >= 1, got {tp_size}")
    if not 0 <= rank < tp_size:
        raise ValueError(f"rank {rank} outside 0..{tp_size - 1}")
    backend, why = tp_backend(tp_size, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if rank == 0:
        print(f"[tp] backend {backend}: {why}", flush=True)
    dist.init_process_group(
        backend, init_method=init_method, world_size=tp_size, rank=rank,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    names: List[str] = [""] * tp_size
    dist.all_gather_object(names, str(device))
    return backend, names
