"""Overload resilience for the continuous scheduler: SLO tracking and a
graceful speculation-degradation ladder.  The port of the JAX package's
``serving/resilience.py``; pure Python, held to it tick for tick
(tests/test_torch_resilience.py).

SpecReason's step-level structure gives the serving stack a degradation
axis no token-exact server has: reasoning is approximation-tolerant, so
under pressure the scheduler can shed *speculation depth* — hierarchical
spec decode, prefill aggressiveness, cache-insertion work — before it
sheds users.  This module holds the policy half of that story; the
mechanism (cancellation, quarantine, shedding) lives in
``serving.scheduler``.

:class:`OverloadController` watches per-tick signals — pool occupancy,
busy rows, queue depth — plus per-finish EWMAs of TTFT/TPOT/service time
and folds them into a scalar *pressure* in [0, 1].  Pressure drives two
decisions:

* **admission throttle** — when pressure sits above the high water mark
  and finished requests are missing their TPOT SLO, new admissions pause
  so in-flight requests can clear (the queue keeps absorbing arrivals;
  deadline/shed policy decides their fate);
* **degradation ladder** — the tick config steps DOWN one level after
  ``patience`` consecutive hot ticks and back UP after ``cooldown``
  consecutive cool ones (hysteresis — a single hot tick never thrashes
  the config):

      L0  full config (hierarchical spec at the configured gamma)
      L1  shrink gamma to half (cheaper verification rounds)
      L2  disable hierarchical spec entirely (plain SpecReason decode)
      L3  shrink the per-tick chunked-prefill budget (protect TPOT
          over TTFT)
      L4  disable prefix-cache *insertion* (stop spending slots and
          export dispatches on caching; lookups still serve hits)

  Greedy outputs are invariant across every rung: token-level spec
  decode is bit-identical to plain decode (tested), and neither the
  prefill budget nor cache insertion changes any request's tokens — the
  ladder trades latency headroom, not answers.

The controller never mutates the scheduler; the scheduler reads
:meth:`tick_config` each tick and applies it.  The speculation-quality
monitors that feed ``observe_tick``'s ``extra_pressure`` are not ported
yet (ROADMAP queue 1, item 6: monitors, admin and device plane); the
scheduler passes 0.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

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
    """Policy knobs for overload control.  The default construction is
    fully inert (no SLOs, no shedding, no ladder) so a scheduler built
    without resilience keeps its exact pre-resilience behaviour."""
    # SLOs: per-output-token latency and time-to-first-token targets the
    # goodput definition and the admission throttle key off (None = unset)
    slo_tpot_s: Optional[float] = None
    slo_ttft_s: Optional[float] = None
    # shed policy: "priority" sheds lowest-priority first (ties prefer
    # best-of-N sibling samples whose group retains >= min_group_survivors
    # other members — vote over survivors), "none" never sheds
    shed_policy: str = "none"
    max_queue: Optional[int] = None      # shed beyond this queue depth
    min_group_survivors: int = 1
    # feasibility shedding: drop a queued request once its remaining
    # deadline budget cannot cover the EWMA execution time (admission ->
    # finish, queue wait excluded) times this safety factor (0 disables
    # prediction; hard timeouts still apply)
    feasibility_factor: float = 1.0
    # degradation ladder + hysteresis
    degrade: bool = False
    high_water: float = 0.85             # pressure to start stepping down
    low_water: float = 0.5               # pressure to start stepping up
    patience: int = 2                    # consecutive hot ticks per step
    cooldown: int = 4                    # consecutive cool ticks per step
    # quarantine: faulted rows retry this many times (speculation
    # disabled) before terminal ``failed``
    max_retries: int = 1
    ewma_alpha: float = 0.3

    def __post_init__(self) -> None:
        if self.shed_policy not in ("none", "priority"):
            raise ValueError(f"unknown shed_policy {self.shed_policy!r}")
        if not (0.0 <= self.low_water <= self.high_water <= 1.0):
            raise ValueError("need 0 <= low_water <= high_water <= 1")
        if self.patience < 1 or self.cooldown < 1:
            raise ValueError("patience/cooldown must be >= 1")


class _Ewma:
    """Scalar EWMA; ``value`` is None until the first observation."""

    def __init__(self, alpha: float):
        self.alpha = alpha
        self.value: Optional[float] = None

    def observe(self, x: float) -> float:
        self.value = x if self.value is None else \
            self.alpha * x + (1 - self.alpha) * self.value
        return self.value


# ladder depth: L0 (full) .. L4 (max degradation) — see module docstring
MAX_LEVEL = 4


class OverloadController:
    """Folds per-tick and per-finish signals into a pressure scalar and
    walks the degradation ladder with hysteresis.  Stateless toward the
    scheduler: it only *answers* (tick_config / admit_quota /
    infeasible); the scheduler applies the answers."""

    def __init__(self, cfg: ResilienceConfig, base: TickConfig):
        self.cfg = cfg
        self.base = base
        self.level = 0
        self.pressure = 0.0
        self.transitions: List[str] = []     # "tick N: L0 -> L1 (...)"
        self._hot = 0
        self._cool = 0
        self.ewma_tpot = _Ewma(cfg.ewma_alpha)
        self.ewma_ttft = _Ewma(cfg.ewma_alpha)
        self.ewma_service = _Ewma(cfg.ewma_alpha)

    # ------------------------------------------------------------ signals
    def observe_finish(self, ttft_s: Optional[float],
                       tpot_s: Optional[float],
                       service_s: Optional[float]) -> None:
        """Fold one finished request's latencies into the EWMAs (called
        by the scheduler as each request completes)."""
        if ttft_s is not None:
            self.ewma_ttft.observe(ttft_s)
        if tpot_s is not None:
            self.ewma_tpot.observe(tpot_s)
        if service_s is not None:
            self.ewma_service.observe(service_s)

    def _slo_strained(self) -> bool:
        c = self.cfg
        if c.slo_tpot_s is not None and self.ewma_tpot.value is not None \
                and self.ewma_tpot.value > c.slo_tpot_s:
            return True
        if c.slo_ttft_s is not None and self.ewma_ttft.value is not None \
                and self.ewma_ttft.value > c.slo_ttft_s:
            return True
        return False

    def observe_tick(self, tick: int, occupancy: float, rows_busy: float,
                     queue_len: int, extra_pressure: float = 0.0
                     ) -> List[str]:
        """Update pressure from this tick's signals and advance the
        ladder (hysteresis).  Returns human-readable transition events
        for the tick (empty almost always)."""
        # Pressure: the binding resource.  Pool occupancy is always a
        # pressure floor; a full row budget only counts as pressure while
        # arrivals are actually waiting on it; an external pressure input
        # (the speculation-quality monitors while an alarm fires) raises
        # the floor the same way; an SLO miss pins pressure to 1 (the
        # ladder exists exactly to relieve it).
        p = occupancy
        if queue_len > 0:
            p = max(p, rows_busy)
        p = max(p, min(1.0, max(0.0, extra_pressure)))
        if self._slo_strained():
            p = 1.0
        self.pressure = p
        events: List[str] = []
        if not self.cfg.degrade:
            return events
        if p >= self.cfg.high_water:
            self._hot += 1
            self._cool = 0
            if self._hot >= self.cfg.patience and self.level < MAX_LEVEL:
                self._hot = 0
                self.level += 1
                events.append(self._transition(tick, self.level - 1,
                                               self.level))
        elif p <= self.cfg.low_water:
            self._cool += 1
            self._hot = 0
            if self._cool >= self.cfg.cooldown and self.level > 0:
                self._cool = 0
                self.level -= 1
                events.append(self._transition(tick, self.level + 1,
                                               self.level))
        else:
            # hysteresis dead band: neither counter advances
            self._hot = self._cool = 0
        return events

    def _transition(self, tick: int, frm: int, to: int) -> str:
        ev = (f"tick {tick}: degradation L{frm} -> L{to} "
              f"(pressure={self.pressure:.2f}) [{self._describe(to)}]")
        self.transitions.append(ev)
        return ev

    @staticmethod
    def _describe(level: int) -> str:
        return ("full config", "gamma halved", "hierarchical spec off",
                "prefill budget shrunk", "cache insertion off")[level]

    # ------------------------------------------------------------ answers
    def tick_config(self) -> TickConfig:
        """The effective knobs at the current ladder level.  Each rung
        keeps every degradation below it (L3 also has spec off, etc.)."""
        b = self.base
        gamma = b.gamma
        spec = b.spec_decode
        mpt = b.max_prefill_tokens
        insert = b.cache_insert
        if self.level >= 1:
            gamma = max(1, b.gamma // 2)
        if self.level >= 2:
            spec = False
        if self.level >= 3:
            mpt = max(1, b.max_prefill_tokens // 4)
        if self.level >= 4:
            insert = False
        return TickConfig(gamma=gamma, spec_decode=spec,
                          max_prefill_tokens=mpt, cache_insert=insert)

    def admit_quota(self, n_active: int) -> Optional[int]:
        """Admissions allowed this tick: None = unlimited.  0 only while
        requests are in flight (an idle scheduler always admits — the
        throttle must never starve an empty batch)."""
        if n_active > 0 and self.pressure >= self.cfg.high_water \
                and self._slo_strained():
            return 0
        return None

    def infeasible(self, remaining_s: float) -> bool:
        """True when a queued request's remaining deadline budget cannot
        cover the EWMA execution time, admission -> finish (feasibility
        shedding: drop it before it wastes capacity it cannot convert to
        goodput).  The estimate deliberately EXCLUDES queue wait — it
        answers "could this request make it if admitted now?", and an
        e2e-based estimate would feed back on itself under overload
        (each slow finisher inflates the estimate that sheds the next
        waiter)."""
        if self.cfg.feasibility_factor <= 0:
            return False
        est = self.ewma_service.value
        if est is None:
            return False
        return remaining_s < est * self.cfg.feasibility_factor

    def as_dict(self) -> dict:
        return {
            "level": self.level,
            "pressure": round(self.pressure, 4),
            "transitions": len(self.transitions),
            "ewma_tpot_s": round(self.ewma_tpot.value, 5)
            if self.ewma_tpot.value is not None else None,
            "ewma_ttft_s": round(self.ewma_ttft.value, 5)
            if self.ewma_ttft.value is not None else None,
            "ewma_service_s": round(self.ewma_service.value, 4)
            if self.ewma_service.value is not None else None,
        }
