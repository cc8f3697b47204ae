"""Single-model inference engine: bucketed prefill/extend, per-token
decode, sessions, rollback and metering.

The substrate the SpecReason controller drives, one engine per model of
the pair.  As in the JAX package:

  * ``extend`` pads to a small set of sequence buckets; the Meter counts
    the padded bucket.  Trailing pads are harmless: queries attend only
    to positions <= their own and the next extend overwrites the padded
    slots.  An ssm model's recurrent state would take the pads in, so
    its extends run at their exact length (``exact_lengths``).
  * every Session keeps ``last_logits``, the logits after its last token.
  * ``truncate`` rolls an attention cache back by resetting the
    position (``can_truncate``; SSM state refuses it); ``rollback``
    restores a snapshot (and may replay tokens), for every family.

Differences from the JAX package:

  * Caches are written in place and a snapshot shares them
    (``models/kvcache.py`` says why that is safe for linear caches).
  * ``generate`` is the per-token loop of the JAX package's
    ``generate_eager``: one decode call, one host sync and one sample per
    token, metered per token.  The JAX package's default fused loop (one
    jitted ``while_loop`` per call) has no counterpart yet; a CUDA-graph
    loop is later work.
  * Sampling draws from a ``torch.Generator`` (``sampling/sample.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.kvcache import DecodeState
from ..models.model import Model
from ..sampling.sample import SamplingParams, probs_from_logits, sample

DEFAULT_BUCKETS = (4, 8, 16, 32, 64, 128, 256)


@dataclasses.dataclass
class Session:
    """One request's generation state on one engine."""
    state: DecodeState
    last_logits: Optional[torch.Tensor]    # (B, V) logits after last token
    pos: int                               # == state.pos

    def snapshot(self) -> "Session":
        return Session(self.state.snapshot(), self.last_logits, self.pos)


@dataclasses.dataclass
class Meter:
    prefill_tokens: int = 0      # padded bucket sizes
    prefill_calls: int = 0
    prefill_time: float = 0.0
    decode_tokens: int = 0
    decode_calls: int = 0
    decode_time: float = 0.0
    # one-token forward passes (a batched generate call runs one per
    # token; a sequential decode call is one): each launches the decode
    # attention kernel once per layer
    decode_steps: int = 0
    # token-level speculation (core.spec_decode / serving.spec_engine):
    # verification rounds run on THIS engine as the verifier, draft tokens
    # proposed to it and how many it accepted
    spec_rounds: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, type(getattr(self, f.name))())


class Engine:
    def __init__(self, model: Model, params, max_len: int = 1024,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, name: str = "",
                 pad_id: int = 0):
        self.model = model
        self.params = params
        self.device = params["tok_embed"].device
        self.max_len = max_len
        self.buckets = tuple(sorted(b for b in buckets if b <= max_len))
        self.name = name or model.cfg.name
        self.pad_id = pad_id
        # trailing pads are invisible to attention caches (position-masked)
        # but would enter an SSM's recurrent state: exact-length extends
        self.exact_lengths = model.cfg.has_ssm
        self.meter = Meter()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ api
    def new_session(self, batch: int = 1,
                    capacity: Optional[int] = None) -> Session:
        st = self.model.init_state(batch, capacity or self.max_len,
                                   self.device)
        return Session(st, None, 0)

    def _bucket(self, n: int) -> int:
        if self.exact_lengths:
            return n
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"extend of {n} tokens exceeds bucket max "
                         f"{self.buckets[-1]}")

    def _prefill_padded(self, session: Session, ids: Sequence[int]
                        ) -> Tuple[torch.Tensor, DecodeState]:
        """Bucket-pad, prefill, meter.  Returns the (B, bucket, V) logits
        and the new state with pos at the unpadded length."""
        n = len(ids)
        # SSM-only states have no positional capacity (constant size)
        if session.state.k is not None and \
                session.pos + n > session.state.capacity:
            raise ValueError(f"context overflow: {session.pos}+{n} > "
                             f"{session.state.capacity}")
        b = self._bucket(n)
        toks = torch.tensor([list(ids) + [self.pad_id] * (b - n)],
                            dtype=torch.long, device=self.device)
        t0 = time.perf_counter()
        logits, new_state = self.model.prefill(self.params, toks,
                                               session.state)
        self._sync()
        self.meter.prefill_time += time.perf_counter() - t0
        self.meter.prefill_tokens += b
        self.meter.prefill_calls += 1
        return logits, dataclasses.replace(new_state, pos=session.pos + n)

    def extend(self, session: Session, ids: Sequence[int]) -> Session:
        """Append tokens to the context (chunked prefill).  Returns a new
        Session whose last_logits follow the final real token."""
        n = len(ids)
        if n == 0:
            return session
        logits, new_state = self._prefill_padded(session, ids)
        return Session(new_state, logits[:, n - 1, :], session.pos + n)

    def extend_logits(self, session: Session, ids: Sequence[int]
                      ) -> Tuple[torch.Tensor, Session]:
        """Like extend, but also returns the (n, V) logits at every
        position of ``ids``."""
        n = len(ids)
        logits, new_state = self._prefill_padded(session, ids)
        return logits[0, :n, :], Session(new_state, logits[:, n - 1, :],
                                         session.pos + n)

    def decode_one(self, session: Session, token: int) -> Session:
        """Feed one token, get next-token logits."""
        toks = torch.tensor([[token]], dtype=torch.long, device=self.device)
        t0 = time.perf_counter()
        logits, new_state = self.model.decode_step(self.params,
                                                   session.state, toks)
        self._sync()
        self.meter.decode_time += time.perf_counter() - t0
        self.meter.decode_tokens += 1
        self.meter.decode_calls += 1
        self.meter.decode_steps += 1
        return Session(new_state, logits, session.pos + 1)

    # ------------------------------------------------------------ generate
    def generate(self, session: Session, max_tokens: int,
                 stop_ids: Sequence[int], params: SamplingParams,
                 generator: torch.Generator, collect_probs: bool = False
                 ) -> Tuple[List[int], Session, List[np.ndarray]]:
        """Sample from last_logits until a stop id or the budget; generated
        ids (stop id included if hit) are fed back into the context.
        Returns (ids, session, per-step probs if requested)."""
        if session.last_logits is None:
            raise ValueError("prefill before generate")
        out: List[int] = []
        probs_list: List[np.ndarray] = []
        stop = set(int(s) for s in stop_ids)
        for _ in range(max_tokens):
            logits = session.last_logits[0]
            tok = int(sample(logits, params, generator))
            if collect_probs:
                probs_list.append(probs_from_logits(logits, params)
                                  .cpu().numpy())
            out.append(tok)
            session = self.decode_one(session, tok)
            if tok in stop:
                break
        return out, session, probs_list

    # ---------------------------------------------------------------- util
    def rollback(self, session: Session, to: Session,
                 replay: Sequence[int] = ()) -> Session:
        """Return the context to snapshot ``to`` and optionally replay
        tokens on top."""
        s = to.snapshot()
        if replay:
            s = self.extend(s, list(replay))
        return s

    @property
    def can_truncate(self) -> bool:
        """Attention-only models can roll back by resetting the position
        (stale cache entries are masked); SSM state cannot."""
        return not self.model.cfg.has_ssm

    def truncate(self, session: Session, to_pos: int,
                 last_logits: torch.Tensor) -> Session:
        """O(1) rollback: keep the cache, reset the position, restore the
        logits at the new last token (which the caller has from the
        verification pass).  Refused for SSM state: restore a snapshot
        with ``rollback`` instead."""
        if not self.can_truncate:
            raise ValueError(f"{self.name}: SSM state cannot be truncated; "
                             "restore a snapshot with rollback()")
        if to_pos > session.pos:
            raise ValueError(f"truncate forward: {to_pos} > {session.pos}")
        ll = last_logits if last_logits.dim() == 2 else last_logits[None]
        return Session(session.state.truncate(to_pos), ll, to_pos)
