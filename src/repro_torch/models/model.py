"""Model assembly for the dense, moe, ssm and hybrid families.

Functions over a params dict, as in the JAX package: parameters are
nested dicts of tensors stacked over layers (``params["layers"]["attn"]
["wq"]`` is (L, d, H, hd)), and the layers run as a Python loop over
that stacked dimension.  A dense layer is pre-norm attention plus an MLP;
an ssm layer is a pre-norm mamba2 mixer (``layers/mixer/*``) and no MLP;
a hybrid layer (hymba) runs attention (``layers/attn/*``, with the
config's sliding window) and a mamba2 mixer (``layers/mamba/*``) side by
side on the same normed input, adds their mean, then an MLP; a moe
layer (granite-moe) is a dense layer whose MLP is a mixture of experts
(``layers/moe/*``, ``models/moe.py``), in every forward below.  Other
families (encdec, vlm) raise ``NotImplementedError``.

Public surface:
  Model.init         -- random parameters from a seed, on a device
  Model.forward      -- full-sequence causal forward -> logits (B, S, V),
                        differentiable (the training path; each layer
                        checkpointed when ``cfg.remat``)
  Model.forward_aux  -- the same, also returning the moe family's aux
                        terms averaged over the layers
  Model.prefill      -- chunked prefill / extend from state.pos
                        -> (logits (B, S, V), new state)
  Model.decode_step  -- one-token decode -> (logits (B, V), new state),
                        from a host or a device position
  Model.init_state   -- an empty KV cache
  Model.prefill_rows -- batched extend of B rows over a paged KV store,
                        each row at its own position -> logits (B, T, V)
                        (attention-only families)
  Model.decode_rows  -- batched one-token decode over a paged KV store
                        -> logits (B, V) (attention-only families)

The two rows forwards also run one rank of exact tensor parallelism:
with a ``tp`` context on the rows view the parameters are the rank's
shard (``models/sharding.py``), attention runs the rank's heads, the
heads and the ffn hidden are gathered before the contractions that
follow them, and the logits come out whole on every rank (the
unembedding is whole).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import device as devices
from . import attention as attn
from . import mamba2, moe
from .config import ModelConfig
from .kvcache import DecodeState, PagedRows, make_decode_state
from .layers import (ParamSpec, apply_mlp, apply_norm, embed_spec,
                     init_params, mlp_spec, norm_spec, sinusoidal_positions,
                     unembed_spec)

Params = Dict[str, object]


def flatten(tree: Dict, prefix: str = "") -> Dict[str, object]:
    """Nested dict -> flat dict with '/'-joined keys (the checkpoint keys)."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(flatten(v, key + "/"))
        else:
            flat[key] = v
    return flat


def unflatten(flat: Dict[str, object]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _layer(stacked: Dict, i: int) -> Dict:
    """Layer i's parameters as views into the stacked tensors."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg.validate()
        if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP queue 1 "
                "item 7: encdec and vlm); the port runs the dense, moe, ssm "
                "and hybrid families")

    # ------------------------------------------------------------- params --
    def spec(self) -> Dict[str, ParamSpec]:
        """Flat '/'-keyed parameter specs, the JAX package's keys and
        layouts."""
        cfg = self.cfg
        d, nt = cfg.d_model, cfg.norm_type
        if cfg.family == "ssm":
            layer = {"ln1": norm_spec(d, nt), "mixer": mamba2.mamba_spec(cfg)}
        else:
            layer = {"ln1": norm_spec(d, nt), "attn": attn.attn_spec(cfg)}
            if cfg.family == "hybrid":
                layer["mamba"] = mamba2.mamba_spec(cfg)
            layer["ln2"] = norm_spec(d, nt)
            if cfg.family == "moe":
                layer["moe"] = moe.moe_spec(cfg)
            else:
                layer["mlp"] = mlp_spec(d, cfg.d_ff, cfg.act)
        tree = {"tok_embed": embed_spec(cfg.vocab_size, d),
                "final_norm": norm_spec(d, nt),
                "layers": {k: s.stacked(cfg.n_layers)
                           for k, s in flatten(layer).items()}}
        if not cfg.tie_embeddings:
            tree["unembed"] = unembed_spec(d, cfg.vocab_size)
        return flatten(tree)

    def init(self, seed: int = 0, device="cuda",
             dtype=torch.float32) -> Params:
        """Random parameters drawn on the CPU from ``seed`` (the same on
        every device), moved to ``device``: leaf tensors, so a trainer
        may set ``requires_grad`` on them."""
        dev = devices.resolve(device)
        gen = torch.Generator().manual_seed(seed)
        return unflatten(init_params(self.spec(), gen, dev, dtype))

    def init_state(self, batch: int, capacity: int, device="cuda",
                   dtype=torch.float32, ring: bool = False) -> DecodeState:
        return make_decode_state(self.cfg, batch, capacity,
                                 devices.resolve(device), dtype, ring)

    # ---------------------------------------------------------- embeddings --
    def _embed(self, params, tokens: torch.Tensor, start
               ) -> torch.Tensor:
        """``start``: the first token's position, or a tensor of every
        token's position, (B, S) or 0-d for one token (the fused decode
        loop's device position)."""
        cfg = self.cfg
        x = params["tok_embed"][tokens]
        if not cfg.use_rope:
            pos = start if isinstance(start, torch.Tensor) else \
                start + torch.arange(tokens.shape[1], device=x.device)
            x = x + sinusoidal_positions(pos, cfg.d_model).to(x.dtype)
        return x

    def _unembed(self, params, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return x @ params["tok_embed"].T
        return x @ params["unembed"]

    def _final(self, params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = apply_norm(x, params["final_norm"], cfg.norm_type,
                       cfg.rmsnorm_eps)
        return self._unembed(params, x)

    def _mlp_block(self, x, lp, tp=None) -> torch.Tensor:
        return self._ffn(x, lp, tp)[0]

    def _ffn(self, x, lp, tp=None
             ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        """The layer's second half: x + MLP(norm(x)), or for the moe
        family x + MoE(norm(x)) and its aux terms (None otherwise)."""
        cfg = self.cfg
        h = apply_norm(x, lp["ln2"], cfg.norm_type, cfg.rmsnorm_eps)
        if cfg.family == "moe":
            y, aux = moe.apply_moe(h, lp["moe"], cfg)
            return x + y, aux
        return x + apply_mlp(h, lp["mlp"], cfg.act, tp), None

    # -------------------------------------------------------------- forward --
    def forward(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence causal forward from position 0 (the training
        path).  tokens: (B, S) int; returns logits (B, S, V)."""
        return self.forward_aux(params, tokens)[0]

    def forward_aux(self, params, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``forward`` and the aux terms of the JAX package's forward:
        the moe family's ``load_balance``, ``router_z`` and
        ``dropped_frac``, each the mean over the layers (empty for the
        other families).

        Under autograd with ``cfg.remat`` each layer is checkpointed, as
        the JAX package wraps each layer in ``jax.checkpoint``: its
        backward recomputes the layer's forward instead of keeping its
        internals."""
        cfg = self.cfg
        x = self._embed(params, tokens, 0)
        positions = torch.arange(tokens.shape[1], device=x.device)
        remat = cfg.remat and torch.is_grad_enabled()
        auxs = []
        for i in range(cfg.n_layers):
            if remat:
                x, aux = checkpoint(self._block, x, params["layers"], i,
                                    positions, use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = self._block(x, params["layers"], i, positions)
            if aux is not None:
                auxs.append(aux)
        mean = {k: torch.stack([a[k] for a in auxs]).mean()
                for k in (auxs[0] if auxs else ())}
        return self._final(params, x), mean

    def _block(self, x: torch.Tensor, layers: Dict, i: int,
               positions: torch.Tensor
               ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        """Layer i of the full-sequence forward, and its moe aux terms
        (None for the other families)."""
        cfg = self.cfg
        lp = _layer(layers, i)
        h = apply_norm(x, lp["ln1"], cfg.norm_type, cfg.rmsnorm_eps)
        if cfg.family == "ssm":
            return x + mamba2.apply_mamba(h, lp["mixer"], cfg), None
        a = attn.self_attention(h, lp["attn"], cfg, positions,
                                window=cfg.sliding_window)
        if cfg.family == "hybrid":
            x = x + 0.5 * (a + mamba2.apply_mamba(h, lp["mamba"], cfg))
        else:
            x = x + a
        return self._ffn(x, lp)

    # ----------------------------------------------------- prefill / extend --
    def prefill(self, params, tokens: torch.Tensor, state: DecodeState
                ) -> Tuple[torch.Tensor, DecodeState]:
        """Process S tokens starting at ``state.pos``: writes their keys and
        values into the state's caches in place (an ssm or hybrid model
        resumes from the state's conv and ssm tensors and returns new
        ones) and returns (logits (B, S, V), the state advanced by S).
        Prompts, step extends and SpecReason verification passes all come
        through here."""
        cfg = self.cfg
        start = state.pos
        x = self._embed(params, tokens, start)
        if cfg.family == "ssm":
            return self._ssm_layers(params, x, state, decode=False)
        convs, ssms = [], []
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            h = apply_norm(x, lp["ln1"], cfg.norm_type, cfg.rmsnorm_eps)
            a = attn.prefill_self_attention(
                h, lp["attn"], cfg, state.k[i], state.v[i], start,
                cfg.sliding_window)
            if cfg.family == "hybrid":
                m, (conv, ssm) = mamba2.apply_mamba(
                    h, lp["mamba"], cfg, (state.conv[i], state.ssm[i]),
                    return_state=True)
                convs.append(conv)
                ssms.append(ssm)
                x = x + 0.5 * (a + m)
            else:
                x = x + a
            x = self._mlp_block(x, lp)
        new_state = dataclasses.replace(state, pos=start + tokens.shape[1])
        if convs:
            new_state = dataclasses.replace(new_state,
                                            conv=torch.stack(convs),
                                            ssm=torch.stack(ssms))
        return self._final(params, x), new_state

    # --------------------------------------------------------------- decode --
    def decode_step(self, params, state: DecodeState, tokens: torch.Tensor,
                    active: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, DecodeState]:
        """One-token decode.  tokens: (B, 1).  Returns (logits (B, V), the
        state advanced by one).

        ``state.pos`` is a host int, or (the fused decode loop) a 0-d
        integer tensor on the device: then the positions, ``lengths`` and
        the cache slot are built on the device with no host read, and a
        0-d bool ``active`` may mask the step: the returned position
        advances by ``active``; a dense step's K/V write puts back what
        the slot held; an ssm step writes its conv and ssm states into
        ``state``'s tensors in place, a masked one leaving them as they
        were (without ``active`` it returns new tensors).  A hybrid step
        does both."""
        cfg = self.cfg
        pos = state.pos
        x = self._embed(params, tokens, pos)
        if isinstance(pos, torch.Tensor):
            new_pos = pos + (1 if active is None else active.to(pos.dtype))
        else:
            new_pos = pos + 1
        if cfg.family == "ssm":
            logits, new_state = self._ssm_layers(params, x, state,
                                                 decode=True, active=active)
            return logits[:, 0, :], dataclasses.replace(new_state,
                                                        pos=new_pos)
        b = tokens.shape[0]
        if isinstance(pos, torch.Tensor):
            lengths = (pos + 1).clamp(max=state.capacity).to(
                torch.int32).reshape(1).expand(b).contiguous()
        else:
            lengths = torch.full((b,), min(pos + 1, state.capacity),
                                 dtype=torch.int32, device=x.device)
        convs, ssms = [], []
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            h = apply_norm(x, lp["ln1"], cfg.norm_type, cfg.rmsnorm_eps)
            a = attn.decode_self_attention(
                h, lp["attn"], cfg, state.k[i], state.v[i], pos, lengths,
                ring=state.ring, active=active)
            if cfg.family == "hybrid":
                m, (conv, ssm) = mamba2.apply_mamba_decode(
                    h, lp["mamba"], cfg, (state.conv[i], state.ssm[i]),
                    active)
                convs.append(conv)
                ssms.append(ssm)
                x = x + 0.5 * (a + m)
            else:
                x = x + a
            x = self._mlp_block(x, lp)
        logits = self._final(params, x)[:, 0, :]
        new_state = dataclasses.replace(state, pos=new_pos)
        if convs and active is None:
            new_state = dataclasses.replace(new_state,
                                            conv=torch.stack(convs),
                                            ssm=torch.stack(ssms))
        return logits, new_state

    def _ssm_layers(self, params, x: torch.Tensor, state: DecodeState,
                    decode: bool, active: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, DecodeState]:
        """The mixer stack over the (B, S, d) embedded tokens from
        ``state``: the chunked scan for an extend, the recurrent step for
        a decoded token.  The conv and ssm states come back as new
        tensors (``models/kvcache.py`` says why), except in the fused
        decode loop's step (``active`` given), which writes them into
        ``state``'s tensors, masked by ``active``."""
        cfg = self.cfg
        convs, ssms = [], []
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            h = apply_norm(x, lp["ln1"], cfg.norm_type, cfg.rmsnorm_eps)
            st = (state.conv[i], state.ssm[i])
            if decode:
                y, (conv, ssm) = mamba2.apply_mamba_decode(
                    h, lp["mixer"], cfg, st, active)
            else:
                y, (conv, ssm) = mamba2.apply_mamba(h, lp["mixer"], cfg, st,
                                                    return_state=True)
            x = x + y
            convs.append(conv)
            ssms.append(ssm)
        if active is None:
            state = dataclasses.replace(
                state, conv=torch.stack(convs), ssm=torch.stack(ssms),
                pos=state.pos + x.shape[1])
        return self._final(params, x), state

    # ------------------------------------------------------- paged rows --
    def prefill_rows(self, params, tokens: torch.Tensor,
                     rows: PagedRows) -> torch.Tensor:
        """Batched extend over a paged store: tokens (B, T), row b's first
        ``rows.span_lens[b]`` real; their K/V land in the row's pages.
        Returns logits (B, T, V) (pads' logits unspecified)."""
        cfg = self.cfg
        x = self._embed(params, tokens, rows.positions)
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            h = apply_norm(x, lp["ln1"], cfg.norm_type, cfg.rmsnorm_eps)
            x = x + attn.extend_rows_attention(h, lp["attn"], cfg, i, rows)
            x = self._mlp_block(x, lp, rows.tp)
        return self._final(params, x)

    def decode_rows(self, params, tokens: torch.Tensor,
                    rows: PagedRows) -> torch.Tensor:
        """Batched one-token decode over a paged store: tokens (B, 1) at
        positions ``rows.positions`` (a ``kvcache.slot_rows`` view, or a
        ``kvcache.paged_rows`` view of width 1), row b attending over
        ``rows.ctx_lens[b] + 1`` keys.  Returns logits (B, V)."""
        cfg = self.cfg
        x = self._embed(params, tokens, rows.positions)
        lengths = rows.ctx_lens + 1
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            h = apply_norm(x, lp["ln1"], cfg.norm_type, cfg.rmsnorm_eps)
            x = x + attn.decode_rows_attention(h, lp["attn"], cfg, i, rows,
                                               lengths)
            x = self._mlp_block(x, lp, rows.tp)
        return self._final(params, x)[:, 0, :]
