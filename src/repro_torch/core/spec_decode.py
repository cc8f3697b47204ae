"""Token-level speculative decoding (Leviathan et al., 2023), the exact
acceleration SpecReason composes with hierarchically (paper §4.2).

The draft (small) model proposes ``gamma`` tokens; the base model
verifies them with one extend (gamma + 1 usable distributions thanks to
the session's last logits).  Greedy rows accept the longest
argmax-matching prefix; sampled rows run the standard rejection rule,
which preserves the base model's distribution.

One acceptance rule, :func:`accept_row`, serves both callers: the
sequential :func:`spec_decode` here and the batched
``serving.spec_engine.BatchSpecEngine``; :func:`acceptance_step` runs it
over rows, each drawing from its own request's generator, so a batched
row takes the tokens the sequential routine takes.

Random draws differ from the JAX package's key splits: a sampled row
draws, per round, its g draft tokens' Gumbel noise (in the draft's
decode), then g uniforms and one Gumbel vector (for the replacement or
bonus token) from its generator.  ``accept_row`` takes those numbers as
arguments, so the tests hold the rule to the JAX package's by handing
both the same uniforms and noise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..sampling.sample import SamplingParams, gumbel, probs_from_logits
from ..serving.engine import Engine, Session


@dataclasses.dataclass
class SpecDecodeStats:
    proposed: int = 0
    accepted: int = 0
    rounds: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.proposed, 1)

    @property
    def mean_accepted_len(self) -> float:
        """Mean accepted draft tokens per verification round (excludes the
        replacement/bonus token, which is never speculative)."""
        return self.accepted / max(self.rounds, 1)

    def merge(self, other: "SpecDecodeStats") -> None:
        self.proposed += other.proposed
        self.accepted += other.accepted
        self.rounds += other.rounds

    def as_dict(self) -> Dict[str, float]:
        return {"proposed": self.proposed, "accepted": self.accepted,
                "rounds": self.rounds,
                "acceptance_rate": round(self.acceptance_rate, 4),
                "mean_accepted_len": round(self.mean_accepted_len, 4)}


def accept_row(toks: Sequence[int], qprobs: torch.Tensor,
               logits: torch.Tensor, bonus_logits: torch.Tensor,
               stop_ids: Sequence[int], sp: SamplingParams,
               uniforms: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None
               ) -> Tuple[List[int], int, bool]:
    """The acceptance rule for one row's round.

    toks: the g proposed tokens; qprobs (g, V): the draft's proposal
    distributions; logits (g, V): base logits predicting each proposed
    token; bonus_logits (V,): base logits after the whole chunk.  Sampled
    rows (``sp.temperature > 0``) take ``uniforms`` (g,) for the
    rejection tests and ``noise`` (V,) Gumbel for the replacement or
    bonus draw; greedy rows take none.

    Returns (suffix: the accepted prefix plus the replacement or bonus
    token unless a stop id was accepted, n_acc, hit_stop)."""
    g = len(toks)
    stop = set(int(s) for s in stop_ids)
    greedy = sp.temperature <= 0.0
    if g == 0:
        return [], 0, False
    p = None if greedy else probs_from_logits(logits, sp)
    n_acc, stopped = 0, False
    for i, tok in enumerate(toks):
        if greedy:
            ok = int(torch.argmax(logits[i])) == tok
        else:
            ratio = p[i, tok] / torch.clamp(qprobs[i, tok], min=1e-30)
            ok = bool(uniforms[i] < torch.clamp(ratio, max=1.0))
        if not ok:
            break
        n_acc += 1
        if tok in stop:
            stopped = True
            break
    if stopped:
        return list(toks[:n_acc]), n_acc, True
    rejected = n_acc < g
    if greedy:
        extra = int(torch.argmax(logits[n_acc] if rejected
                                 else bonus_logits))
    else:
        if rejected:
            p_row = p[n_acc]
            resid = torch.clamp(p_row - qprobs[n_acc], min=0.0)
            z = float(resid.sum())
            dist = resid / z if z > 1e-12 else p_row / p_row.sum()
        else:
            dist = probs_from_logits(bonus_logits, sp)
        extra = int(torch.argmax(torch.log(torch.clamp(dist, min=1e-30))
                                 + noise))
    return list(toks[:n_acc]) + [extra], n_acc, extra in stop


def acceptance_step(draft_toks: Sequence[Sequence[int]],
                    draft_probs: Sequence[torch.Tensor],
                    all_logits: Sequence[torch.Tensor],
                    bonus_logits: Sequence[torch.Tensor],
                    stop_sets: Sequence[Sequence[int]], sp: SamplingParams,
                    generators: Sequence[torch.Generator]
                    ) -> List[Tuple[List[int], int, bool]]:
    """:func:`accept_row` over rows: a sampled row with g > 0 draws g
    uniforms, then one Gumbel vector, from its generator."""
    out = []
    for toks, q, lg, bonus, stop, gen in zip(draft_toks, draft_probs,
                                             all_logits, bonus_logits,
                                             stop_sets, generators):
        u = noise = None
        if sp.temperature > 0.0 and toks:
            dev = lg.device
            u = torch.rand(len(toks), generator=gen, device=dev)
            noise = gumbel((lg.shape[-1],), gen, dev)
        out.append(accept_row(toks, q, lg, bonus, stop, sp, u, noise))
    return out


def spec_decode(base: Engine, draft: Engine, base_sess: Session,
                draft_sess: Session, max_tokens: int,
                stop_ids: Sequence[int], params: SamplingParams,
                generator: torch.Generator, gamma: int = 4,
                stats: Optional[SpecDecodeStats] = None
                ) -> Tuple[List[int], Session, Session]:
    """Generate up to ``max_tokens`` tokens of the base model's
    distribution, accelerated by the draft model.  Both sessions start
    at the same context.  Returns (generated ids incl. stop token, base
    session, draft session).

    Deferred-feed layout, as in the JAX package: each round's final
    suffix token stays pending, its base logits come out of the next
    round's verification extend (``[pending] + draft``), and one base
    decode commits the last pending token when the routine finishes.  The
    draft context reconciles every round: truncate, then decode the final
    suffix token.  An engine that cannot truncate (SSM state) restores
    the round's snapshot and replays the kept tokens instead."""
    out: List[int] = []
    stats = stats if stats is not None else SpecDecodeStats()
    pending: Optional[int] = None
    while len(out) < max_tokens:
        g = min(gamma, max_tokens - len(out))
        d_snap = draft_sess.snapshot()
        draft_ids, draft_sess, dprobs = draft.generate(
            draft_sess, g, (), params, generator, collect_probs=True)
        if not draft_ids:
            break
        stats.proposed += len(draft_ids)
        stats.rounds += 1
        base.meter.spec_rounds += 1
        base.meter.spec_proposed += len(draft_ids)

        b_snap = base_sess.snapshot()
        p = 1 if pending is not None else 0
        chunk = ([pending] if p else []) + list(draft_ids)
        chunk_logits, base_ext = base.extend_logits(base_sess, chunk)
        n = len(draft_ids)
        logits = chunk_logits[:n] if p else torch.cat(
            [b_snap.last_logits.reshape(1, -1), chunk_logits[:n - 1]])
        (suffix, n_acc, hit_stop), = acceptance_step(
            [draft_ids],
            [torch.from_numpy(np.stack(dprobs)).to(chunk_logits.device)],
            [logits], [chunk_logits[p + n - 1]], [stop_ids], params,
            [generator])
        stats.accepted += n_acc
        base.meter.spec_accepted += n_acc
        out += suffix
        m = len(suffix)
        if base.can_truncate:
            base_sess = base.truncate(base_ext, b_snap.pos + p + m - 1,
                                      b_snap.last_logits)  # stale; unread
        else:
            base_sess = base.rollback(base_ext, b_snap,
                                      replay=chunk[:p + m - 1])
        pending = suffix[-1]
        draft_sess = _reconcile(draft, draft_sess, d_snap, suffix)
        if hit_stop:
            break
    if pending is not None:
        base_sess = base.decode_one(base_sess, pending)
    return out, base_sess, draft_sess


def _reconcile(engine: Engine, sess_with_cache: Session, snap: Session,
               suffix: List[int]) -> Session:
    """Place ``snap + suffix`` as the engine's context, reusing the cached
    speculative entries when the engine can truncate."""
    if engine.can_truncate:
        keep = engine.truncate(sess_with_cache, snap.pos + len(suffix) - 1,
                               snap.last_logits)          # stale; unread
        return engine.decode_one(keep, suffix[-1])
    return engine.rollback(sess_with_cache, snap, replay=suffix)
