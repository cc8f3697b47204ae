"""Single-model inference engine: bucketed prefill/extend, decode loops,
sessions, rollback and metering.

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
  * ``generate`` dispatches to the fused loop (``generate_fused``) or to
    the per-token loop (``generate_eager``), by the call's ``fused`` or
    the engine's default.

Differences from the JAX package:

  * Caches are written in place and a snapshot shares them
    (``models/kvcache.py`` says why that is safe for linear caches).
  * ``generate_fused`` is the JAX package's one ``while_loop`` a call,
    rebuilt for a CUDA graph.  One body of k one-token steps (sample,
    record, stop check, decode the token), each masked by ``active = (i
    < n_max) & ~done``, reads and writes static buffers: the position,
    counters, last logits, token and probability buffers and the
    session's KV caches.  On the card it is captured once per key and
    replayed chunk by chunk (``serving/graph_loop.py``); the host reads
    ``i`` and ``done`` one chunk behind, through a pinned copy, so a
    call waits on the card
    at most ceil(budget / k) + 1 times and runs at most 2k - 1 masked
    steps.  On the CPU the same body runs eagerly.  A failed capture or
    replay raises; nothing falls back to the per-token loop.
  * The fused loop is the default for the dense family only.  An ssm
    call builds new state tensors (``models/kvcache.py``), so a graph
    over it would copy about 103 MB in and out per call at mamba2-1.3b,
    or need another snapshot rule (ROADMAP queue 1, item 1): ssm engines
    decode with ``generate_eager``, and ask for ``fused=True`` raises.
  * ``generate_eager`` is the JAX package's: one decode call, one host
    sync and one sample per token, metered per token.
  * Sampling draws from a ``torch.Generator`` (``sampling/sample.py``).
    The fused loop leaves the generator where the per-token loop would,
    so both loops draw the same tokens from the same generator.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.kvcache import DecodeState
from ..models.model import Model
from ..sampling.sample import SamplingParams, gumbel, probs_from_logits, \
    sample
from . import graph_loop

DEFAULT_BUCKETS = (4, 8, 16, 32, 64, 128, 256)

_SSM_FUSED = ("the fused decode loop does not take SSM state yet (ROADMAP "
              "queue 1, item 1): a CUDA graph needs static buffers and an "
              "ssm call builds new ones; decode with fused=False")


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
    # token; a sequential decode call is one; a fused generate call runs
    # its chunks' steps, masked ones included, and a capture's masked
    # warm-up step): each launches the decode attention kernel once per
    # layer
    decode_steps: int = 0
    # host waits on the card inside fused generate calls (status reads
    # and the final read)
    decode_syncs: int = 0
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


class _Lease:
    """Held by every state over one pooled KV pair (``new_session``)."""
    __slots__ = ("__weakref__",)


@dataclasses.dataclass
class _FusedLoop:
    """The static buffers of one capture key and, on the card, the graph
    that reads and writes them."""
    state: DecodeState     # the KV caches (no lease), pos a view of ctl
    sp: SamplingParams
    k: int                 # one-token steps a body
    ctl: torch.Tensor      # int64 (4,): i, done, n_max, pos
    logits: torch.Tensor   # (1, V) logits after the last decoded token
    toks: torch.Tensor     # int64 (buf,), -1 past the last token
    stop: torch.Tensor     # int64 (n_slots,), -1 pads
    probs: Optional[torch.Tensor]   # float32 (buf, V) with collect_probs
    inp: torch.Tensor      # host staging of ctl and stop (pinned on CUDA)
    # pinned host buffers of the card: two slots of ctl (look-ahead), the
    # tokens and the probabilities
    status: Optional[torch.Tensor] = None
    toks_host: Optional[torch.Tensor] = None
    probs_host: Optional[torch.Tensor] = None
    graph: Optional[torch.cuda.CUDAGraph] = None
    # kernel launches a replay runs (``kernels.counts``)
    launches: Optional[Counter] = None


class Engine:
    def __init__(self, model: Model, params, max_len: int = 1024,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, name: str = "",
                 pad_id: int = 0, fused: Optional[bool] = None):
        """``fused``: the default decode loop of ``generate``.  None means
        fused for the dense family and per-token for ssm, whose state a
        graph cannot hold in place (module docstring), and for a sliding
        window, which the device position does not take; True on an ssm
        model raises."""
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
        if fused and model.cfg.has_ssm:
            raise NotImplementedError(_SSM_FUSED)
        self.fused = (not model.cfg.has_ssm and not model.cfg.sliding_window
                      if fused is None else fused)
        self.meter = Meter()
        # (batch, capacity) -> [(state over a KV pair, weakref to the
        # lease of the states that hold it)]
        self._kv_pool: Dict[Tuple[int, int], list] = {}
        self._loops: Dict[tuple, _FusedLoop] = {}
        self._graph_gen: Optional[torch.Generator] = None
        self.captures = 0          # CUDA graphs captured
        self.capture_time = 0.0    # seconds spent capturing them

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ api
    def new_session(self, batch: int = 1,
                    capacity: Optional[int] = None) -> Session:
        """An empty context.  A dense engine hands out a KV pair of this
        (batch, capacity) again, zeroed, once no live state holds it, so
        a fused loop's graph keyed by the pair's addresses is replayed
        across requests; it allocates a pair only while every pooled one
        is held."""
        cap = capacity or self.max_len
        if self.model.cfg.has_ssm:
            return Session(self.model.init_state(batch, cap, self.device),
                           None, 0)
        pairs = self._kv_pool.setdefault((batch, cap), [])
        lease = _Lease()
        for n, (st, held) in enumerate(pairs):
            if held() is None:
                st.k.zero_()
                st.v.zero_()
                pairs[n] = (st, weakref.ref(lease))
                return Session(dataclasses.replace(st, lease=lease), None, 0)
        st = self.model.init_state(batch, cap, self.device)
        pairs.append((st, weakref.ref(lease)))
        return Session(dataclasses.replace(st, lease=lease), None, 0)

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
                 generator: torch.Generator, collect_probs: bool = False,
                 fused: Optional[bool] = None
                 ) -> Tuple[List[int], Session, List[np.ndarray]]:
        """Sample from last_logits until a stop id or the budget; generated
        ids (stop id included if hit) are fed back into the context.
        Returns (ids, session, per-step probs if requested).  ``fused``
        picks the loop (None: the engine's default)."""
        use_fused = self.fused if fused is None else fused
        loop = self.generate_fused if use_fused else self.generate_eager
        return loop(session, max_tokens, stop_ids, params, generator,
                    collect_probs)

    def generate_eager(self, session: Session, max_tokens: int,
                       stop_ids: Sequence[int], params: SamplingParams,
                       generator: torch.Generator,
                       collect_probs: bool = False
                       ) -> Tuple[List[int], Session, List[np.ndarray]]:
        """The per-token loop: one decode call, one host sync and one
        sample per token, metered per token.  The specification of
        ``generate_fused``."""
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

    def generate_fused(self, session: Session, max_tokens: int,
                       stop_ids: Sequence[int], params: SamplingParams,
                       generator: torch.Generator,
                       collect_probs: bool = False
                       ) -> Tuple[List[int], Session, List[np.ndarray]]:
        """The fused loop (module docstring): the tokens, session and
        probabilities ``generate_eager`` gives, from chunks of masked
        one-token steps over static buffers, replayed as a CUDA graph on
        the card.  The budget is clamped to the cache's free slots.
        Metered as one decode call of n tokens; ``decode_steps`` counts
        every step run, masked ones included."""
        if self.model.cfg.has_ssm:
            raise NotImplementedError(_SSM_FUSED)
        if session.last_logits is None:
            raise ValueError("prefill before generate")
        state = session.state
        if state.k.shape[1] != 1:
            raise ValueError("the fused loop decodes one row")
        n_budget = min(max_tokens, state.capacity - session.pos)
        if n_budget <= 0:
            return [], session, []
        stop = sorted(set(int(s) for s in stop_ids))
        n_slots = graph_loop.stop_slots(len(stop))
        k = graph_loop.chunk_steps(n_budget)
        t0 = time.perf_counter()
        loop = self._fused_loop(state, params, collect_probs,
                                graph_loop.decode_buf(n_budget), n_slots, k)
        loop.inp[:4] = torch.tensor([0, 0, n_budget, session.pos])
        loop.inp[4:] = torch.tensor(stop + [-1] * (n_slots - len(stop)))
        loop.ctl.copy_(loop.inp[:4], non_blocking=True)
        loop.stop.copy_(loop.inp[4:], non_blocking=True)
        loop.logits.copy_(session.last_logits)
        loop.toks.fill_(-1)
        sampled = params.temperature > 0.0
        if loop.graph is None:         # the CPU: the body, eagerly
            saved = generator.get_state() if sampled else None
            chunks = 0
            while True:
                self._fused_steps(loop, generator, k)
                chunks += 1
                i, done = loop.ctl[:2].tolist()
                if done or i >= n_budget:
                    break
            n = i
            toks, probs = loop.toks, loop.probs
            if sampled:
                # the masked steps drew noise the per-token loop does not
                generator.set_state(saved)
                for _ in range(n):
                    gumbel(loop.logits.shape[-1:], generator, "cpu")
        else:
            start = generator.get_offset() if sampled else 0
            if sampled:
                self._graph_gen.manual_seed(generator.initial_seed())
                self._graph_gen.set_offset(start)
            chunks, toks, probs = self._replay(loop, n_budget)
            n = int(loop.status[0, 0])
            if sampled:
                per_step = (self._graph_gen.get_offset() - start) \
                    // (chunks * k)
                generator.set_offset(start + n * per_step)
        self.meter.decode_time += time.perf_counter() - t0
        self.meter.decode_tokens += n
        self.meter.decode_calls += 1
        self.meter.decode_steps += chunks * k
        out = toks[:n].tolist()
        probs_list = [] if probs is None else list(probs[:n].numpy().copy())
        new_state = dataclasses.replace(state, pos=session.pos + n)
        return out, Session(new_state, loop.logits.clone(),
                            session.pos + n), probs_list

    def _fused_loop(self, state: DecodeState, sp: SamplingParams,
                    collect_probs: bool, buf: int, n_slots: int,
                    k: int) -> _FusedLoop:
        """The static buffers (and on the card the captured graph) of one
        key.  A graph holds the addresses it was captured on, so the key
        includes the KV pair's; ``new_session`` hands pairs out again."""
        key = (state.k.data_ptr(), state.v.data_ptr(), state.k.shape, sp,
               collect_probs, buf, n_slots, k)
        loop = self._loops.get(key)
        if loop is not None:
            return loop
        dev, vocab = self.device, self.model.cfg.vocab_size
        cuda = dev.type == "cuda"
        ctl = torch.zeros(4, dtype=torch.long, device=dev)
        loop = _FusedLoop(
            state=DecodeState(state.k, state.v, pos=ctl[3]), sp=sp, k=k,
            ctl=ctl, logits=torch.zeros((1, vocab), device=dev,
                                        dtype=self.params["tok_embed"].dtype),
            toks=torch.full((buf,), -1, dtype=torch.long, device=dev),
            stop=torch.full((n_slots,), -1, dtype=torch.long, device=dev),
            probs=torch.zeros((buf, vocab), device=dev)
            if collect_probs else None,
            inp=torch.zeros(4 + n_slots, dtype=torch.long, pin_memory=cuda))
        if cuda:
            self._capture(loop)
        self._loops[key] = loop
        return loop

    def _fused_steps(self, loop: _FusedLoop, generator: torch.Generator,
                     steps: int) -> None:
        """``steps`` one-token steps over the loop's buffers, each masked
        by ``active = (i < n_max) & ~done``: sample from the last logits,
        record the token (and its probabilities), set done on a stop id,
        then decode the token (a stop token joins the context).  Reads
        nothing back to the host: the graph records exactly this."""
        i, done, n_max, pos = loop.ctl
        last = loop.toks.shape[0] - 1
        for _ in range(steps):
            active = (i < n_max) & (done == 0)
            row = loop.logits[0]
            tok = sample(row, loop.sp, generator)
            slot = i.clamp(max=last).reshape(1)
            if loop.probs is not None:
                p = probs_from_logits(row, loop.sp)[None]
                loop.probs.index_copy_(0, slot, torch.where(
                    active, p, loop.probs.index_select(0, slot)))
            loop.toks.index_copy_(0, slot, torch.where(
                active, tok, loop.toks.index_select(0, slot)))
            done.bitwise_or_(active & (tok == loop.stop).any())
            logits, st = self.model.decode_step(
                self.params, loop.state, tok.reshape(1, 1), active=active)
            loop.logits.copy_(torch.where(active, logits, loop.logits))
            pos.copy_(st.pos)
            i.add_(active)

    def _capture(self, loop: _FusedLoop) -> None:
        """Capture a body of ``loop.k`` steps (``graph_loop.capture``);
        its masked warm-up step runs on the zero buffers (n_max = 0)."""
        t0 = time.perf_counter()
        if self._graph_gen is None:
            self._graph_gen = torch.Generator(device=self.device)
        loop.graph, loop.launches = graph_loop.capture(
            self.device, lambda n: self._fused_steps(loop, self._graph_gen,
                                                     n),
            loop.k, [self._graph_gen])
        self.meter.decode_steps += 1
        loop.status = torch.zeros((2, 4), dtype=torch.long, pin_memory=True)
        loop.toks_host = torch.empty_like(loop.toks, device="cpu",
                                          pin_memory=True)
        if loop.probs is not None:
            loop.probs_host = torch.empty_like(loop.probs, device="cpu",
                                               pin_memory=True)
        self.captures += 1
        self.capture_time += time.perf_counter() - t0

    def _replay(self, loop: _FusedLoop, n_budget: int
                ) -> Tuple[int, torch.Tensor, Optional[torch.Tensor]]:
        """Replay chunks until one reports done or the budget is spent
        (``graph_loop.replay``).  Returns (chunks replayed, tokens,
        probabilities) on the host, with the final counters in
        ``loop.status[0]``."""
        finals = [(loop.toks_host, loop.toks), (loop.status[0], loop.ctl)]
        if loop.probs is not None:
            finals.append((loop.probs_host, loop.probs))
        chunks, waits = graph_loop.replay(
            self.device, loop.graph, loop.launches, loop.ctl, loop.status,
            -(-n_budget // loop.k), lambda st: bool(st[1]), finals)
        self.meter.decode_syncs += waits
        return chunks, loop.toks_host, loop.probs_host

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
