"""The failure-model vocabulary the continuous scheduler's core tick
reads, from the JAX package's ``serving/resilience.py``: the terminal
status constants, ``RequestError``, ``TickConfig``, and an inert
``ResilienceConfig`` / ``OverloadController``.

Deadlines, shedding and the degradation ladder are not ported yet
(ROADMAP queue 1, item 6): a ``ResilienceConfig`` that asks for any of
them raises ``NotImplementedError``, and the controller always answers
the full configuration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# terminal request outcomes (scheduler.Request.status)
STATUS_OK = "ok"
STATUS_TIMEOUT = "timeout"
STATUS_SHED = "shed"
STATUS_FAILED = "failed"
TERMINAL_STATUSES = (STATUS_OK, STATUS_TIMEOUT, STATUS_SHED, STATUS_FAILED)


@dataclasses.dataclass(frozen=True)
class RequestError:
    """Structured terminal error carried by a failed/timed-out/shed
    request: a stable machine-readable ``code``, a human line, and the
    scheduler tick it was stamped at."""
    code: str          # "deadline" | "shed_infeasible" | "shed_overload"
    #                  # | "nan_logits" | "engine_error" | ...
    message: str
    tick: int = 0

    def __str__(self) -> str:
        return f"[{self.code}@tick{self.tick}] {self.message}"


@dataclasses.dataclass(frozen=True)
class TickConfig:
    """The degradable per-tick knobs the scheduler consults: effective
    spec gamma, whether hierarchical spec decode runs at all, the
    chunked-prefill token budget, and whether freshly prefilled blocks
    are inserted into the prefix cache."""
    gamma: int
    spec_decode: bool
    max_prefill_tokens: int
    cache_insert: bool


@dataclasses.dataclass
class ResilienceConfig:
    """The JAX package's overload-control knobs at their inert defaults.
    Anything else raises: the policies are not ported."""
    slo_tpot_s: Optional[float] = None
    slo_ttft_s: Optional[float] = None
    shed_policy: str = "none"
    max_queue: Optional[int] = None
    degrade: bool = False

    def __post_init__(self) -> None:
        if (self.slo_tpot_s, self.slo_ttft_s, self.shed_policy,
                self.max_queue, self.degrade) != (None, None, "none", None,
                                                  False):
            raise NotImplementedError(
                "SLOs, shedding and the degradation ladder are not ported "
                "yet (ROADMAP queue 1, item 6)")


class OverloadController:
    """Inert: always answers the base tick configuration (the ladder that
    would degrade it is not ported)."""

    def __init__(self, cfg: ResilienceConfig, base: TickConfig):
        self.cfg = cfg
        self.base = base
        self.level = 0

    def tick_config(self) -> TickConfig:
        return self.base
