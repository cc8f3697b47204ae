"""Mixture-of-Experts: top-k router and capacity-bounded GShard dispatch.

The port of the JAX package's ``models/moe.py``, which has no Pallas
kernel: its products are XLA einsums, and here they are batched matrix
products.  The rules are the reference's, step for step:

  * tokens are flattened batch-major and cut into groups of
    ``moe_group_size`` tokens (fewer when the call has fewer; halved until
    the group size divides the token count);
  * the router takes a softmax in float32 and its top-k, on equal
    probabilities the lower expert first (``jax.lax.top_k``'s order: a
    stable descending sort; ``torch.topk`` does not promise it), and the
    k gates are normalised;
  * each (token, choice) takes a buffer position in its expert,
    choice-major (every token's first choice before any second choice),
    token order within a choice; a position at or past the group's
    capacity (``group_capacity``) is dropped;
  * the experts run as one SwiGLU over (E, G * C, d) buffers, and each
    token's output is the gate-weighted sum of its kept choices.

Where the reference moves tokens by one-hot einsums over (G, S, E, C)
tensors, this moves them by index: a scatter of each kept (token,
choice) into its expert's buffer slot and a gather back.  The same
tokens are kept and dropped.  Every shape comes from the call's shape,
nothing is read back to the host and no tensor is indexed by a boolean
mask, so the layer runs inside the fused loops' CUDA graphs.  Dropped
choices and empty slots go through one spare row of zeros.

So a token's output depends on the other tokens of its group, the
bucket pads and other rows of a batched call included: a capacity-bound
model couples the rows of a call.  The serving engines carry the tokens
the JAX package's engines carry, for that reason.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import ParamSpec


def moe_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((d, e), "scaled", 1.0, 0),
        "w_gate": ParamSpec((e, d, ff), "scaled", 1.0, 1),
        "w_up": ParamSpec((e, d, ff), "scaled", 1.0, 1),
        "w_down": ParamSpec((e, ff, d), "scaled", 1.0, 1),
    }


def group_capacity(group_size: int, cfg: ModelConfig) -> int:
    """Buffer slots an expert has in a group: ``int(capacity_factor *
    S * k / E)``, at least k, at most S * k."""
    cap = int(cfg.capacity_factor * group_size * cfg.top_k / cfg.n_experts)
    cap = max(cap, cfg.top_k, 1)
    return min(cap, group_size * cfg.top_k)


def group_size(tokens: int, cfg: ModelConfig) -> int:
    """Tokens a dispatch group holds for a call of ``tokens`` tokens."""
    g = min(cfg.moe_group_size, tokens)
    while tokens % g:
        g //= 2
    return g


def route(logits: torch.Tensor, cfg: ModelConfig, capacity: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                     torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-group routing of router logits (G, S, E).

    Returns (experts (G,S,k) int64, buffer positions (G,S,k) int64, keep
    (G,S,k) bool, gates (G,S,k) float32 normalised over k, aux terms
    ``load_balance``, ``router_z`` and ``dropped_frac``)."""
    g, s, e = logits.shape
    k = cfg.top_k
    lf = logits.float()
    probs = torch.softmax(lf, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = vals[..., :k], idx[..., :k]
    gates = gates / gates.sum(-1, keepdim=True)

    # choice-major priority: (G, k*S) in the order (choice, token); the
    # one-hot by comparison (F.one_hot may read the indices back to check
    # them)
    oh = (experts[..., None] == torch.arange(e, device=logits.device)
          ).long()                                              # (G,S,k,E)
    flat = oh.transpose(1, 2).reshape(g, k * s, e)
    before = torch.cumsum(flat, dim=1) - flat
    pos = (before * flat).sum(-1).reshape(g, k, s).transpose(1, 2)
    keep = pos < capacity

    me = probs.mean(dim=(0, 1))
    ce = oh[:, :, 0, :].float().mean(dim=(0, 1))                # top-1 share
    aux = {
        "load_balance": e * torch.sum(me * ce),
        "router_z": torch.mean(torch.logsumexp(lf, dim=-1) ** 2),
        "dropped_frac": 1.0 - keep.float().mean(),
    }
    return experts, pos, keep, gates, aux


def apply_moe(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) -> (y (B, S, d), aux terms), the reference's
    ``apply_moe``."""
    b, s, d = x.shape
    t = b * s
    gsize = group_size(t, cfg)
    g = t // gsize
    c = group_capacity(gsize, cfg)
    e, k = cfg.n_experts, cfg.top_k
    xg = x.reshape(g, gsize, d)
    experts, pos, keep, gates, aux = route(xg @ p["router"], cfg, c)

    # buffer slot of each (token, choice) in the (E, G*C) buffers; a
    # dropped choice goes to the spare slot E*G*C, which reads zeros
    grp = torch.arange(g, device=x.device)[:, None, None]
    slot = (experts * g + grp) * c + pos
    spare = e * g * c
    slot = torch.where(keep, slot, spare).reshape(t * k)
    xk = x.reshape(t, 1, d).expand(t, k, d).reshape(t * k, d)
    buf = x.new_zeros(spare + 1, d).index_put((slot,), xk)[:spare]
    buf = buf.reshape(e, g * c, d)
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out = torch.bmm(h, p["w_down"]).reshape(spare, d)
    out = torch.cat([out, out.new_zeros(1, d)])
    y = (out[slot].reshape(t, k, d)
         * gates.reshape(t, k, 1).to(out.dtype)).sum(1)
    return y.reshape(b, s, d), aux


def aux_loss(aux: Dict[str, torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    return (cfg.router_aux_coef * aux["load_balance"]
            + cfg.router_z_coef * aux["router_z"])
