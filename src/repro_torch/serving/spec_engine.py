"""Hierarchical speculation in serving: batched token-level speculative
decoding over the continuous-batching engines (SpecReason+Decode, §4.2).

The port of the JAX package's ``serving/spec_engine.py``.  One round, for
every in-flight row at once:

  1. draft proposal: one ``generate_rows`` on the draft engine proposes
     up to gamma tokens per row and collects their proposal
     distributions;
  2. verification: one base ``extend_rows`` over every row's
     ``[pending] + chunk`` gives gamma + 1 usable distributions per row;
     its attention is ``kernels.paged_append_attention`` (span queries
     over the row's committed pages plus the chunk's own K/V);
  3. acceptance: ``core.spec_decode.acceptance_step``, the rule the
     sequential routine runs, each row drawing from its own generator;
  4. reconcile: rejected suffixes roll back by a row truncate plus a
     block-table truncate through the ledger, then one draft
     ``feed_rows`` re-decodes each row's final suffix token.

Rows finish at different rounds and drop out; a row that finishes
commits its pending token with one batched base ``feed_rows``.

Block accounting stays with the caller through a :class:`SpecLedger`.
Unlike the JAX package's dense rows, the port writes K/V into pages, so
the ledger *reserves* each call's worst case before the call (``reserve``
may preempt rows, which the engine observes through ``alive``) and
shrinks the tables to the real length after it (``truncate``).  The
default ledger does nothing: standalone engines own their pools and grow
their tables themselves.  The ledger's ``alive`` is also where the
scheduler cancels a row whose deadline passed: between rounds, never
inside a call.

``decode_rows(gamma=)`` shrinks the draft length for one call (the
degradation ladder's first rung); ``on_round`` receives each round's
``(round, t0, t1, [(item, proposed, accepted), ...])`` for the
scheduler's ``spec_round`` spans and metrics; with the base engine's
tracer on, the acceptance is an ``accept_prog`` span on its
``engine:<name>`` track.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..core.spec_decode import SpecDecodeStats, acceptance_step
from ..sampling.sample import SamplingParams
from .batch_engine import BatchEngine
from .telemetry import engine_track


@dataclasses.dataclass
class SpecRow:
    """One row's work order: engine rows, token budget, stop set and the
    request's generator."""
    base_row: int
    draft_row: int
    budget: int
    stop_ids: Sequence[int]
    generator: torch.Generator


class SpecLedger:
    """Block-table callbacks of the caller; item ``i`` is ``items[i]``,
    ``which`` is "base" or "draft".  ``reserve`` makes the item's table
    cover ``end`` tokens before a call writes them (it may preempt
    items); ``truncate`` shrinks it to ``length`` after a rollback."""

    def alive(self, i: int) -> bool:
        return True

    def reserve(self, i: int, which: str, end: int) -> None:
        pass

    def truncate(self, i: int, which: str, length: int) -> None:
        pass


class BatchSpecEngine:
    """Batched token-level speculative decoding across BatchEngine rows.
    Each row's emitted tokens are the sequential ``spec_decode``'s with
    the same generator; the engine owns both engines' rows for the call
    and keeps the draft context token-synchronized with the base."""

    def __init__(self, base_be: BatchEngine, draft_be: BatchEngine,
                 gamma: int = 4):
        if gamma < 1:
            raise ValueError("gamma must be >= 1")
        if base_be.tp is not draft_be.tp:
            # a round's draft feeds its verification: both engines must
            # run on the same ranks (and a half-sharded pair would break
            # the per-row identity with the sequential routine)
            raise ValueError(
                "base and draft engines must share one TPContext "
                "(both None, or the same object)")
        self.base_be = base_be
        self.draft_be = draft_be
        self.gamma = gamma

    @property
    def tp_size(self) -> int:
        """Tensor-parallel degree of the engine pair (1 = unsharded)."""
        return 1 if self.base_be.tp is None else self.base_be.tp.tp_size

    def decode_rows(self, items: Sequence[SpecRow], params: SamplingParams,
                    ledger: Optional[SpecLedger] = None,
                    gamma: Optional[int] = None,
                    on_round: Optional[
                        Callable[[int, float, float,
                                  List[Tuple[int, int, int]]], None]] = None
                    ) -> Tuple[List[List[int]], List[SpecDecodeStats]]:
        """Run rounds until every row hits its stop or budget.  Returns
        (emitted ids per row, per-row SpecDecodeStats).  Rows the ledger
        preempts keep their partial output (the caller requeues them).
        ``gamma`` overrides the configured draft length for this call (at
        most it: the admission headroom covers the configured one;
        greedy tokens do not depend on it).  ``on_round`` observes each
        round that judged rows: ``(round, t0, t1, infos)`` with one
        ``(item, proposed, accepted)`` per judged row (perf_counter
        seconds; it must not touch engine state)."""
        ledger = ledger or SpecLedger()
        gam = self.gamma if gamma is None else gamma
        if gam < 1:
            raise ValueError("gamma must be >= 1")
        if gam > self.gamma:
            raise ValueError("per-call gamma above the configured gamma "
                             "would exceed the admission headroom")
        rounds = 0
        base, draft = self.base_be, self.draft_be
        tr = base.tracer
        n = len(items)
        assert n <= base.batch
        out: List[List[int]] = [[] for _ in items]
        stats = [SpecDecodeStats() for _ in items]
        done = [False] * n
        # deferred feed: each round's final suffix token stays pending, its
        # base logits ride the next round's verification extend
        pending: List[Optional[int]] = [None] * n

        while True:
            t_round0 = time.perf_counter() if on_round is not None else 0.0
            round_info: List[Tuple[int, int, int]] = []
            active = [i for i in range(n)
                      if not done[i] and ledger.alive(i)
                      and items[i].budget > len(out[i])]
            if not active and not any(
                    pending[i] is not None and ledger.alive(i)
                    for i in range(n)):
                break
            g_want = {i: min(gam, items[i].budget - len(out[i]))
                      for i in active}
            b_pos = {i: int(base.pos[items[i].base_row]) for i in active}
            d_pos = {i: int(draft.pos[items[i].draft_row]) for i in active}

            # -- 1) one draft proposal for every active row
            for i in active:
                ledger.reserve(i, "draft", d_pos[i] + g_want[i])
            active = [i for i in active if ledger.alive(i)]
            chunks, probs = {}, {}
            if active:
                douts, dprobs = draft.generate_rows(
                    [items[i].draft_row for i in active],
                    [g_want[i] for i in active], [], params,
                    [items[i].generator for i in active],
                    stop_ids_rows=[[] for _ in active], collect_probs=True)
                chunks = dict(zip(active, douts))
                probs = dict(zip(active, dprobs))
            for i in active:
                if not chunks[i]:
                    done[i] = True        # capacity exhausted: stop clean
            verify = [i for i in active if chunks[i]]

            # -- 2) one base verification extend: [pending] + chunk
            ext = {i: ([pending[i]] if pending[i] is not None else [])
                   + chunks[i] for i in verify}
            for i in verify:
                ledger.reserve(i, "base", b_pos[i] + len(ext[i]))
            verify = [i for i in verify if ledger.alive(i)]
            prev = {i: base.last_logits[items[i].base_row].clone()
                    for i in verify if pending[i] is None}
            all_l = base.extend_rows([items[i].base_row for i in verify],
                                     [ext[i] for i in verify],
                                     want_logits=True) if verify else []
            chunk_l = dict(zip(verify, all_l))

            # -- 3) the acceptance rule, every row from its own generator
            logits, bonus = [], []
            for i in verify:
                ga = len(chunks[i])
                if pending[i] is not None:
                    logits.append(chunk_l[i][:ga])
                else:
                    logits.append(torch.cat([prev[i][None],
                                             chunk_l[i][:ga - 1]]))
                bonus.append(chunk_l[i][len(ext[i]) - 1])
            t_a0 = time.perf_counter() if tr is not None else 0.0
            verdicts = acceptance_step(
                [chunks[i] for i in verify], [probs[i] for i in verify],
                logits, bonus, [items[i].stop_ids for i in verify], params,
                [items[i].generator for i in verify])
            if tr is not None and verify:
                # acceptance_step returns host verdicts: the span holds
                # its launches and the wait for them
                tr.span(engine_track(base.name), "accept_prog", t_a0,
                        time.perf_counter(), {"rows": len(verify),
                                              "gamma": gam})

            # -- 4) reconcile: truncate both rows and their tables; the
            # final suffix token becomes the base's pending token and is
            # fed to the draft now
            dfeed: List[Tuple[int, int]] = []
            for i, (sfx, n_acc, hit_stop) in zip(verify, verdicts):
                if not ledger.alive(i):
                    continue
                ga, m = len(chunks[i]), len(sfx)
                p = 1 if pending[i] is not None else 0
                out[i] += sfx
                stats[i].proposed += ga
                stats[i].accepted += n_acc
                stats[i].rounds += 1
                if on_round is not None:
                    round_info.append((i, ga, n_acc))
                base.meter.spec_rounds += 1
                base.meter.spec_proposed += ga
                base.meter.spec_accepted += n_acc
                new_pos = b_pos[i] + p + m - 1
                base.truncate_row(items[i].base_row, new_pos)
                ledger.truncate(i, "base", new_pos)
                pending[i] = sfx[-1]
                draft.truncate_row(items[i].draft_row, d_pos[i] + m - 1)
                ledger.truncate(i, "draft", d_pos[i] + m - 1)
                ledger.reserve(i, "draft", d_pos[i] + m)
                if hit_stop or len(out[i]) >= items[i].budget:
                    done[i] = True
                dfeed.append((i, sfx[-1]))
            dfeed = [(i, t) for i, t in dfeed if ledger.alive(i)]
            if dfeed:
                draft.feed_rows([items[i].draft_row for i, _ in dfeed],
                                [t for _, t in dfeed])

            # -- 5) finish-feed: rows that just finished commit their
            # pending token with one batched base decode
            fin = [i for i in range(n)
                   if done[i] and pending[i] is not None and ledger.alive(i)]
            for i in fin:
                ledger.reserve(i, "base",
                               int(base.pos[items[i].base_row]) + 1)
            fin = [i for i in fin if ledger.alive(i)]
            if fin:
                base.feed_rows([items[i].base_row for i in fin],
                               [pending[i] for i in fin])
                for i in fin:
                    pending[i] = None
            if on_round is not None and round_info:
                on_round(rounds, t_round0, time.perf_counter(), round_info)
            rounds += 1
        return out, stats
