"""Model assembly for the six families: dense, moe, ssm, hybrid, encdec
and vlm.

Functions over a params dict, as in the JAX package: parameters are
nested dicts of tensors stacked over layers (``params["layers"]["attn"]
["wq"]`` is (L, d, H, hd)), and the layers run as a Python loop over
that stacked dimension.  A dense layer is pre-norm attention plus an MLP;
an ssm layer is a pre-norm mamba2 mixer (``layers/mixer/*``) and no MLP;
a hybrid layer (hymba) runs attention (``layers/attn/*``, with the
config's sliding window) and a mamba2 mixer (``layers/mamba/*``) side by
side on the same normed input, adds their mean, then an MLP; a moe
layer (granite-moe) is a dense layer whose MLP is a mixture of experts
(``layers/moe/*``, ``models/moe.py``), in every forward below.

The cross-attention families attend to a source their front end would
make, which the JAX package stubs with precomputed embeddings.  An
encdec model (whisper) encodes the source frames (``encode``: a
bidirectional encoder, ``encoder/*``) and every decoder layer adds a
cross-attention to them between its self-attention and its MLP
(``layers/{ln2,cross,ln3,mlp}``).  A vlm model (llama-3.2-vision) runs
groups of ``cross_attn_every - 1`` dense layers (``layers/*`` stacked
(groups, per group, ...)), each group followed by a gated
cross-attention layer over the patch embeddings (``cross_layers/*``:
tanh(``gate_attn``) scales its attention, tanh(``gate_mlp``) its MLP;
both gates start at zero, as in the JAX package).  ``prep_cross``
caches every cross layer's K/V of the source in the decode state once a
session; ``prefill`` and ``decode_step`` read them.

Public surface:
  Model.init         -- random parameters from a seed, on a device
  Model.forward      -- full-sequence causal forward -> logits (B, S, V)
                        (with ``image_embeds`` or ``encoder_embeds``
                        for the cross-attention families),
                        differentiable (the training path; each layer
                        checkpointed when ``cfg.remat``)
  Model.forward_aux  -- the same, also returning the moe family's aux
                        terms averaged over the layers
  Model.prefill      -- chunked prefill / extend from state.pos
                        -> (logits (B, S, V), new state)
  Model.decode_step  -- one-token decode -> (logits (B, V), new state),
                        from a host or a device position
  Model.init_state   -- an empty KV cache (with a cross pair of
                        ``n_cross_src`` source tokens)
  Model.encode       -- the encdec encoder over frame embeddings
  Model.prep_cross   -- cache the cross layers' K/V of a source
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
from typing import Callable, Dict, Iterator, Optional, Tuple

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
# a cross-attention over a source: (normed x, the layer's "cross"
# parameters, the cross layer's index) -> the attention's output
Cross = Callable[[torch.Tensor, Dict[str, torch.Tensor], int],
                 torch.Tensor]


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

    # ------------------------------------------------------------- params --
    def _layer_spec(self) -> Dict[str, object]:
        """One (decoder) layer's specs; a vlm model's self layers are
        dense ones."""
        cfg = self.cfg
        d, nt = cfg.d_model, cfg.norm_type
        if cfg.family == "ssm":
            return {"ln1": norm_spec(d, nt), "mixer": mamba2.mamba_spec(cfg)}
        layer = {"ln1": norm_spec(d, nt), "attn": attn.attn_spec(cfg)}
        if cfg.family == "hybrid":
            layer["mamba"] = mamba2.mamba_spec(cfg)
        layer["ln2"] = norm_spec(d, nt)
        if cfg.family == "moe":
            layer["moe"] = moe.moe_spec(cfg)
            return layer
        if cfg.family == "encdec":
            layer["cross"] = attn.attn_spec(cfg)
            layer["ln3"] = norm_spec(d, nt)
        layer["mlp"] = mlp_spec(d, cfg.d_ff, cfg.act)
        return layer

    def _cross_layer_spec(self) -> Dict[str, object]:
        """A vlm model's gated cross-attention layer."""
        cfg = self.cfg
        d, nt = cfg.d_model, cfg.norm_type
        return {"ln1": norm_spec(d, nt), "cross": attn.attn_spec(cfg),
                "ln2": norm_spec(d, nt),
                "mlp": mlp_spec(d, cfg.d_ff, cfg.act),
                "gate_attn": ParamSpec((1,), "zeros"),
                "gate_mlp": ParamSpec((1,), "zeros")}

    def spec(self) -> Dict[str, ParamSpec]:
        """Flat '/'-keyed parameter specs, the JAX package's keys and
        layouts."""
        cfg = self.cfg
        d, nt = cfg.d_model, cfg.norm_type
        layer = flatten(self._layer_spec())
        tree = {"tok_embed": embed_spec(cfg.vocab_size, d),
                "final_norm": norm_spec(d, nt)}
        if cfg.family == "vlm":
            ng, pg = cfg.n_cross_layers, cfg.cross_attn_every - 1
            tree["layers"] = {k: s.stacked(pg).stacked(ng)
                              for k, s in layer.items()}
            tree["cross_layers"] = {
                k: s.stacked(ng)
                for k, s in flatten(self._cross_layer_spec()).items()}
        else:
            tree["layers"] = {k: s.stacked(cfg.n_layers)
                              for k, s in layer.items()}
        if cfg.family == "encdec":
            enc = {"ln1": norm_spec(d, nt), "attn": attn.attn_spec(cfg),
                   "ln2": norm_spec(d, nt),
                   "mlp": mlp_spec(d, cfg.d_ff, cfg.act)}
            tree["encoder"] = {
                "layers": {k: s.stacked(cfg.n_encoder_layers)
                           for k, s in flatten(enc).items()},
                "final_norm": norm_spec(d, nt)}
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
                   dtype=torch.float32, ring: bool = False,
                   n_cross_src: int = 0) -> DecodeState:
        return make_decode_state(self.cfg, batch, capacity,
                                 devices.resolve(device), dtype, ring,
                                 n_cross_src)

    def _layers(self, params) -> Iterator[Tuple[str, int, Dict]]:
        """The layers in the order they run, as (kind, i, parameters):
        ("self", i, lp) for decoder layer i, i also its index into the
        self-attention caches; a vlm model's ("cross", g, cp) after
        group g's self layers."""
        cfg = self.cfg
        if cfg.family != "vlm":
            for i in range(cfg.n_layers):
                yield "self", i, _layer(params["layers"], i)
            return
        pg = cfg.cross_attn_every - 1
        for g in range(cfg.n_cross_layers):
            group = _layer(params["layers"], g)
            for j in range(pg):
                yield "self", g * pg + j, _layer(group, j)
            yield "cross", g, _layer(params["cross_layers"], g)

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

    def _mlp_block(self, x, lp, tp=None, cross: Optional[Cross] = None,
                   i: int = 0) -> torch.Tensor:
        return self._ffn(x, lp, tp, cross, i)[0]

    def _ffn(self, x, lp, tp=None, cross: Optional[Cross] = None,
             i: int = 0
             ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        """The layer's second half: x + MLP(norm(x)), or for the moe
        family x + MoE(norm(x)) and its aux terms (None otherwise).  An
        encdec layer first adds its cross-attention to the source,
        ``cross(norm(x), lp["cross"], i)``, and its MLP then takes
        ``ln3``."""
        cfg = self.cfg
        norm = "ln2"
        if cfg.family == "encdec":
            h = apply_norm(x, lp["ln2"], cfg.norm_type, cfg.rmsnorm_eps)
            x = x + cross(h, lp["cross"], i)
            norm = "ln3"
        h = apply_norm(x, lp[norm], cfg.norm_type, cfg.rmsnorm_eps)
        if cfg.family == "moe":
            y, aux = moe.apply_moe(h, lp["moe"], cfg)
            return x + y, aux
        return x + apply_mlp(h, lp["mlp"], cfg.act, tp), None

    def _cross_layer(self, x, cp, g: int, positions, cross: Cross
                     ) -> Tuple[torch.Tensor, None]:
        """A vlm model's gated cross-attention layer g (``positions``
        unused: the layer has no RoPE; the signature is ``_block``'s)."""
        cfg = self.cfg
        h = apply_norm(x, cp["ln1"], cfg.norm_type, cfg.rmsnorm_eps)
        x = x + torch.tanh(cp["gate_attn"]) * cross(h, cp["cross"], g)
        h = apply_norm(x, cp["ln2"], cfg.norm_type, cfg.rmsnorm_eps)
        return x + torch.tanh(cp["gate_mlp"]) * apply_mlp(h, cp["mlp"],
                                                          cfg.act), None

    # ------------------------------------------------------ cross sources --
    def encode(self, params, encoder_embeds: torch.Tensor) -> torch.Tensor:
        """The encdec encoder over precomputed frame embeddings (B, S, d)
        (the JAX package stubs the conv front end the same way):
        sinusoidal positions, pre-norm layers of bidirectional
        self-attention and an MLP, a final norm."""
        cfg = self.cfg
        enc = params["encoder"]
        s = encoder_embeds.shape[1]
        x = encoder_embeds + sinusoidal_positions(
            torch.arange(s, device=encoder_embeds.device),
            cfg.d_model).to(encoder_embeds.dtype)
        for i in range(cfg.n_encoder_layers):
            lp = _layer(enc["layers"], i)
            h = apply_norm(x, lp["ln1"], cfg.norm_type, cfg.rmsnorm_eps)
            x = x + attn.encoder_self_attention(h, lp["attn"])
            h = apply_norm(x, lp["ln2"], cfg.norm_type, cfg.rmsnorm_eps)
            x = x + apply_mlp(h, lp["mlp"], cfg.act)
        return apply_norm(x, enc["final_norm"], cfg.norm_type,
                          cfg.rmsnorm_eps)

    def prep_cross(self, params, state: DecodeState, src: torch.Tensor
                   ) -> DecodeState:
        """Write every cross layer's K/V of ``src`` (B, S_src, d: the
        encoded frames, or the patch embeddings) into the state's cross
        pair in place, once a session (the fused loop's graphs read the
        pair at its address), and return the state."""
        cfg = self.cfg
        held = 0 if state.cross_k is None else state.cross_k.shape[2]
        if held != src.shape[1]:
            raise ValueError(f"the state's cross pair holds {held} source "
                             f"tokens; the source has {src.shape[1]}")
        layers = params["cross_layers" if cfg.family == "vlm"
                        else "layers"]["cross"]
        for i in range(cfg.n_cross_layers):
            k, v = attn.cross_kv(src, {n: t[i] for n, t in layers.items()})
            state.cross_k[i].copy_(k)
            state.cross_v[i].copy_(v)
        return state

    def _source_cross(self, params, image_embeds, encoder_embeds
                      ) -> Optional[Cross]:
        """The full-sequence forward's cross-attention: over the encoded
        ``encoder_embeds`` (encdec) or ``image_embeds`` (vlm), their K/V
        made in every layer as the JAX package's forward makes them."""
        cfg = self.cfg
        if cfg.family not in ("encdec", "vlm"):
            return None
        src = image_embeds if cfg.family == "vlm" else encoder_embeds
        if src is None:
            raise ValueError(f"a {cfg.family} forward needs "
                             + ("image_embeds" if cfg.family == "vlm"
                                else "encoder_embeds"))
        if cfg.family == "encdec":
            src = self.encode(params, src)
        return lambda h, p, i: attn.cross_attention(h, src, p, cfg)

    def _cached_cross(self, state: DecodeState, decode: bool
                      ) -> Optional[Cross]:
        """The cross-attention of ``prefill`` and ``decode_step`` over
        the state's cached pair (``prep_cross``); a decoded token's
        through flash-decode with the pair's ``cross_len``."""
        cfg = self.cfg
        if cfg.family not in ("encdec", "vlm"):
            return None
        if state.cross_k is None:
            raise ValueError(f"a {cfg.family} state needs its cross source:"
                             " Engine.new_session(cross_src=...), or "
                             "init_state(n_cross_src=...) and prep_cross")
        lengths = state.cross_len if decode else None
        return lambda h, p, i: attn.cross_attention(
            h, None, p, cfg, cached_kv=(state.cross_k[i], state.cross_v[i]),
            lengths=lengths)

    # -------------------------------------------------------------- forward --
    def forward(self, params, tokens: torch.Tensor,
                image_embeds: Optional[torch.Tensor] = None,
                encoder_embeds: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Full-sequence causal forward from position 0 (the training
        path).  tokens: (B, S) int; returns logits (B, S, V).  A vlm
        model takes ``image_embeds`` (B, S_src, d), an encdec model
        ``encoder_embeds`` (B, S_src, d), which it encodes."""
        return self.forward_aux(params, tokens, image_embeds,
                                encoder_embeds)[0]

    def forward_aux(self, params, tokens: torch.Tensor,
                    image_embeds: Optional[torch.Tensor] = None,
                    encoder_embeds: Optional[torch.Tensor] = None
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
        cross = self._source_cross(params, image_embeds, encoder_embeds)
        remat = cfg.remat and torch.is_grad_enabled()
        auxs = []
        for kind, i, lp in self._layers(params):
            fn = self._cross_layer if kind == "cross" else self._block
            if remat:
                x, aux = checkpoint(fn, x, lp, i, positions, cross,
                                    use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = fn(x, lp, i, positions, cross)
            if aux is not None:
                auxs.append(aux)
        mean = {k: torch.stack([a[k] for a in auxs]).mean()
                for k in (auxs[0] if auxs else ())}
        return self._final(params, x), mean

    def _block(self, x: torch.Tensor, lp: Dict, i: int,
               positions: torch.Tensor, cross: Optional[Cross] = None
               ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        """Decoder layer i of the full-sequence forward, and its moe aux
        terms (None for the other families)."""
        cfg = self.cfg
        h = apply_norm(x, lp["ln1"], cfg.norm_type, cfg.rmsnorm_eps)
        if cfg.family == "ssm":
            return x + mamba2.apply_mamba(h, lp["mixer"], cfg), None
        a = attn.self_attention(h, lp["attn"], cfg, positions,
                                window=cfg.sliding_window)
        if cfg.family == "hybrid":
            x = x + 0.5 * (a + mamba2.apply_mamba(h, lp["mamba"], cfg))
        else:
            x = x + a
        return self._ffn(x, lp, cross=cross, i=i)

    # ----------------------------------------------------- prefill / extend --
    def prefill(self, params, tokens: torch.Tensor, state: DecodeState
                ) -> Tuple[torch.Tensor, DecodeState]:
        """Process S tokens starting at ``state.pos``: writes their keys and
        values into the state's caches in place (an ssm or hybrid model
        resumes from the state's conv and ssm tensors and returns new
        ones) and returns (logits (B, S, V), the state advanced by S).
        Prompts, step extends and SpecReason verification passes all come
        through here.  The cross-attention families read the state's
        cached cross pair."""
        cfg = self.cfg
        start = state.pos
        x = self._embed(params, tokens, start)
        if cfg.family == "ssm":
            return self._ssm_layers(params, x, state, decode=False)
        cross = self._cached_cross(state, decode=False)
        convs, ssms = [], []
        for kind, i, lp in self._layers(params):
            if kind == "cross":
                x = self._cross_layer(x, lp, i, None, cross)[0]
                continue
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
            x = self._mlp_block(x, lp, cross=cross, i=i)
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
        does both.  A cross-attention step reads the cached cross pair
        and writes nothing into it."""
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
        cross = self._cached_cross(state, decode=True)
        convs, ssms = [], []
        for kind, i, lp in self._layers(params):
            if kind == "cross":
                x = self._cross_layer(x, lp, i, None, cross)[0]
                continue
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
            x = self._mlp_block(x, lp, cross=cross, i=i)
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
