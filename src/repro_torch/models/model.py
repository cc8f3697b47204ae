"""Model assembly for the dense and ssm families.

Functions over a params dict, as in the JAX package: parameters are
nested dicts of tensors stacked over layers (``params["layers"]["attn"]
["wq"]`` is (L, d, H, hd)), and the layers run as a Python loop over
that stacked dimension.  A dense layer is pre-norm attention plus an MLP;
an ssm layer is a pre-norm mamba2 mixer (``layers/mixer/*``) and no MLP.
Other families raise ``NotImplementedError``.

Public surface:
  Model.init         -- random parameters from a seed, on a device
  Model.forward      -- full-sequence causal forward -> logits (B, S, V)
  Model.prefill      -- chunked prefill / extend from state.pos
                        -> (logits (B, S, V), new state)
  Model.decode_step  -- one-token decode -> (logits (B, V), new state),
                        from a host or a device position
  Model.init_state   -- an empty KV cache
  Model.prefill_rows -- batched extend of B rows over a paged KV store,
                        each row at its own position -> logits (B, T, V)
                        (dense family)
  Model.decode_rows  -- batched one-token decode over a paged KV store
                        -> logits (B, V) (dense family)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from .. import device as devices
from . import attention as attn
from . import mamba2
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
        if cfg.family not in ("dense", "ssm"):
            raise NotImplementedError(f"family {cfg.family!r} is not ported "
                                      "yet; the port runs the dense and ssm "
                                      "families")

    # ------------------------------------------------------------- params --
    def spec(self) -> Dict[str, ParamSpec]:
        """Flat '/'-keyed parameter specs, the JAX package's keys and
        layouts."""
        cfg = self.cfg
        d, nt = cfg.d_model, cfg.norm_type
        if cfg.family == "ssm":
            layer = {"ln1": norm_spec(d, nt), "mixer": mamba2.mamba_spec(cfg)}
        else:
            layer = {"ln1": norm_spec(d, nt), "attn": attn.attn_spec(cfg),
                     "ln2": norm_spec(d, nt),
                     "mlp": mlp_spec(d, cfg.d_ff, cfg.act)}
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
        every device), moved to ``device``."""
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

    def _mlp_block(self, x, lp) -> torch.Tensor:
        cfg = self.cfg
        h = apply_norm(x, lp["ln2"], cfg.norm_type, cfg.rmsnorm_eps)
        return x + apply_mlp(h, lp["mlp"], cfg.act)

    # -------------------------------------------------------------- forward --
    def forward(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence causal forward from position 0.  tokens: (B, S)
        int; returns logits (B, S, V)."""
        cfg = self.cfg
        x = self._embed(params, tokens, 0)
        positions = torch.arange(tokens.shape[1], device=x.device)
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            h = apply_norm(x, lp["ln1"], cfg.norm_type, cfg.rmsnorm_eps)
            if cfg.family == "ssm":
                x = x + mamba2.apply_mamba(h, lp["mixer"], cfg)
                continue
            x = x + attn.self_attention(h, lp["attn"], cfg, positions,
                                        window=cfg.sliding_window)
            x = self._mlp_block(x, lp)
        return self._final(params, x)

    # ----------------------------------------------------- prefill / extend --
    def prefill(self, params, tokens: torch.Tensor, state: DecodeState
                ) -> Tuple[torch.Tensor, DecodeState]:
        """Process S tokens starting at ``state.pos``: writes their keys and
        values into the state's caches in place (an ssm model resumes
        from the state's conv and ssm tensors and returns new ones) and
        returns (logits (B, S, V), the state advanced by S).  Prompts,
        step extends and SpecReason verification passes all come through
        here."""
        cfg = self.cfg
        start = state.pos
        x = self._embed(params, tokens, start)
        if cfg.family == "ssm":
            return self._ssm_layers(params, x, state, decode=False)
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            h = apply_norm(x, lp["ln1"], cfg.norm_type, cfg.rmsnorm_eps)
            x = x + attn.prefill_self_attention(
                h, lp["attn"], cfg, state.k[i], state.v[i], start,
                cfg.sliding_window)
            x = self._mlp_block(x, lp)
        new_state = dataclasses.replace(state, pos=start + tokens.shape[1])
        return self._final(params, x), new_state

    # --------------------------------------------------------------- decode --
    def decode_step(self, params, state: DecodeState, tokens: torch.Tensor,
                    active: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, DecodeState]:
        """One-token decode.  tokens: (B, 1).  Returns (logits (B, V), the
        state advanced by one).

        ``state.pos`` is a host int, or (dense family, the fused decode
        loop) a 0-d integer tensor on the device: then the rope positions,
        ``lengths`` and the cache slot are built on the device with no
        host read, and a 0-d bool ``active`` may mask the step (its K/V
        write puts back what the slot held, and the returned position
        advances by ``active``)."""
        cfg = self.cfg
        pos = state.pos
        x = self._embed(params, tokens, pos)
        if cfg.family == "ssm":
            logits, new_state = self._ssm_layers(params, x, state,
                                                 decode=True)
            return logits[:, 0, :], new_state
        b = tokens.shape[0]
        if isinstance(pos, torch.Tensor):
            lengths = (pos + 1).clamp(max=state.capacity).to(
                torch.int32).reshape(1).expand(b).contiguous()
            new_pos = pos + (1 if active is None else active.to(pos.dtype))
        else:
            lengths = torch.full((b,), min(pos + 1, state.capacity),
                                 dtype=torch.int32, device=x.device)
            new_pos = pos + 1
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            h = apply_norm(x, lp["ln1"], cfg.norm_type, cfg.rmsnorm_eps)
            x = x + attn.decode_self_attention(
                h, lp["attn"], cfg, state.k[i], state.v[i], pos, lengths,
                ring=state.ring, active=active)
            x = self._mlp_block(x, lp)
        logits = self._final(params, x)[:, 0, :]
        return logits, dataclasses.replace(state, pos=new_pos)

    def _ssm_layers(self, params, x: torch.Tensor, state: DecodeState,
                    decode: bool) -> Tuple[torch.Tensor, DecodeState]:
        """The mixer stack over the (B, S, d) embedded tokens from
        ``state``: the chunked scan for an extend, the recurrent step for
        a decoded token.  The conv and ssm states come back as new
        tensors (``models/kvcache.py`` says why)."""
        cfg = self.cfg
        convs, ssms = [], []
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            h = apply_norm(x, lp["ln1"], cfg.norm_type, cfg.rmsnorm_eps)
            st = (state.conv[i], state.ssm[i])
            if decode:
                y, (conv, ssm) = mamba2.apply_mamba_decode(h, lp["mixer"],
                                                           cfg, st)
            else:
                y, (conv, ssm) = mamba2.apply_mamba(h, lp["mixer"], cfg, st,
                                                    return_state=True)
            x = x + y
            convs.append(conv)
            ssms.append(ssm)
        new_state = dataclasses.replace(
            state, conv=torch.stack(convs), ssm=torch.stack(ssms),
            pos=state.pos + x.shape[1])
        return self._final(params, x), new_state

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
            x = self._mlp_block(x, lp)
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
            x = self._mlp_block(x, lp)
        return self._final(params, x)[:, 0, :]
