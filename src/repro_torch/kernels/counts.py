"""Launch counts of the kernel wrappers, aware of CUDA graph capture.

Every wrapper calls ``launched(wrapper)`` where it launches its kernel,
which adds one to ``wrapper.launches``.  A launch recorded into a CUDA
graph runs on each replay and not at capture: while the current stream
captures inside ``capturing()``, the launch goes to that capture's tally
instead, and the graph's owner passes the tally to ``replayed`` after
every replay.  A capture outside ``capturing()`` counts nothing.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from typing import Iterator, Optional

import torch

_tally: Optional[Counter] = None


def launched(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel (or record it into the
    open capture's tally)."""
    if torch.cuda.is_current_stream_capturing():
        if _tally is not None:
            _tally[wrapper] += 1
    else:
        wrapper.launches += 1


@contextlib.contextmanager
def capturing() -> Iterator[Counter]:
    """A tally of the launches recorded while the block captures a graph:
    wrapper -> launches a replay runs."""
    global _tally
    outer, _tally = _tally, Counter()
    try:
        yield _tally
    finally:
        _tally = outer


def replayed(tally: Counter) -> None:
    """Count the launches of one replay of a graph captured with
    ``tally``."""
    for wrapper, n in tally.items():
        wrapper.launches += n
