"""Capture and look-ahead replay of the fused decode loops
(``Engine.generate_fused`` and ``BatchEngine.generate_rows_fused``).

A fused loop is a body of k masked one-token steps over static buffers.
On the card the body is captured once per key into a CUDA graph
(``capture``) and replayed chunk by chunk (``replay``): each chunk's
status counters go to one of two pinned host slots, and the host reads a
chunk's slot while the next chunk runs, so a call waits on the card at
most ceil(budget / k) + 1 times and runs at most 2k - 1 masked steps.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Sequence, Tuple

import torch

from ..kernels import counts

# Stop-id vectors are padded to a multiple of this, so that the number of
# stop ids adds no capture key.
STOP_SLOTS = 4
# one-token steps in a body of a fused loop (one graph replay)
FUSED_CHUNK = 8


def decode_buf(max_tokens: int) -> int:
    """Token-buffer size of a fused loop: the next power of two, at least
    8, so that budgets share a few capture keys."""
    b = 8
    while b < max_tokens:
        b *= 2
    return b


def stop_slots(n_stop: int) -> int:
    """Length of a padded stop-id vector of ``n_stop`` ids."""
    return -(-max(n_stop, 1) // STOP_SLOTS) * STOP_SLOTS


def chunk_steps(budget: int) -> int:
    """Steps a body, k: FUSED_CHUNK, or the budget's power of two when
    smaller."""
    return min(FUSED_CHUNK, 1 << (budget - 1).bit_length())


def capture(device: torch.device, steps: Callable[[int], None], k: int,
            generators: Sequence[torch.Generator]
            ) -> Tuple[torch.cuda.CUDAGraph, Counter]:
    """Capture ``steps(k)`` into a CUDA graph with ``generators``
    registered.  A warm-up ``steps(1)`` first runs on a side stream (the
    caller's buffers mask every step), which builds the kernels and
    fills the plans' caches; the capture runs in torch's ``global`` mode,
    so a host sync in the body raises.  Nothing catches a failure.
    Returns the graph and the kernel launches a replay runs
    (``kernels.counts``)."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        steps(1)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    with counts.capturing() as tally, torch.cuda.graph(graph):
        steps(k)
    return graph, tally


def replay(device: torch.device, graph: torch.cuda.CUDAGraph,
           launches: Counter, ctl: torch.Tensor, status: torch.Tensor,
           max_chunks: int, done: Callable[[torch.Tensor], bool],
           finals: Sequence[Tuple[torch.Tensor, torch.Tensor]]
           ) -> Tuple[int, int]:
    """Replay ``graph`` until ``done`` holds for a chunk's status or
    ``max_chunks`` ran.  After each replay ``ctl`` (the device counters)
    goes to slot ``chunk % 2`` of the pinned ``status``; the host reads
    a chunk's slot while the next chunk runs.  Then the ``finals``
    (pinned host destination, device source) are copied and one wait
    reads them.  Returns (chunks replayed, host waits)."""
    stream = torch.cuda.current_stream(device)
    events = []
    waits = 0
    while True:
        graph.replay()
        counts.replayed(launches)
        status[len(events) % 2].copy_(ctl, non_blocking=True)
        events.append(torch.cuda.Event())
        events[-1].record(stream)
        chunks = len(events)
        if chunks == max_chunks:
            break
        if chunks >= 2:
            events[chunks - 2].synchronize()
            waits += 1
            if done(status[chunks % 2]):
                break
    for dst, src in finals:
        dst.copy_(src, non_blocking=True)
    stream.synchronize()
    return chunks, waits + 1
