"""Parameter specs and the elementary layers of the dense family.

Parameters are plain nested dicts of tensors stacked over layers, with
the JAX package's key paths and layouts (``layers/attn/wq`` is
(L, d, H, hd)), so either package reads the other's checkpoints.  A spec
here is (shape, init rule, stddev); ``init_params`` draws them from one
``torch.Generator`` on the CPU and moves them to the device, so the same
seed gives the same weights on every device.  (The draws are not the JAX
package's: its ``init`` uses ``jax.random``.)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"   # normal | zeros | ones | scaled
    scale: float = 1.0     # stddev for normal; multiplier for scaled
    fan_in_axis: int = 0   # for "scaled": stddev = scale / sqrt(shape[axis])

    def stacked(self, n: int) -> "ParamSpec":
        return ParamSpec((n,) + self.shape, self.init, self.scale,
                         self.fan_in_axis + 1)


def init_params(specs: Dict[str, ParamSpec], generator: torch.Generator,
                device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Flat '/'-keyed specs -> flat tensors, drawn in sorted key order."""
    out = {}
    for key in sorted(specs):
        s = specs[key]
        if s.init == "zeros":
            t = torch.zeros(s.shape)
        elif s.init == "ones":
            t = torch.ones(s.shape)
        else:
            std = s.scale
            if s.init == "scaled":
                std = s.scale / math.sqrt(max(s.shape[s.fan_in_axis], 1))
            t = torch.randn(s.shape, generator=generator) * std
        out[key] = t.to(device=device, dtype=dtype)
    return out


# ---------------------------------------------------------------------------
# Elementary layers
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dt)


def apply_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], norm_type: str,
               eps: float) -> torch.Tensor:
    if norm_type == "layernorm":
        return layernorm(x, p["scale"], p["bias"], eps)
    return rmsnorm(x, p["scale"], eps)


def norm_spec(d: int, norm_type: str) -> Dict[str, ParamSpec]:
    spec = {"scale": ParamSpec((d,), "ones")}
    if norm_type == "layernorm":
        spec["bias"] = ParamSpec((d,), "zeros")
    return spec


# -- rotary position embeddings ----------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to
    (..., seq).  Rotates the two halves of head_dim (not interleaved)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    ang = positions[..., None].float() * freqs                # (..., seq, hd/2)
    cos = torch.cos(ang)[..., None, :]                        # (..., seq, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings.  positions: (...,) -> (..., d)."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device)
                      / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# -- MLPs ---------------------------------------------------------------------

def mlp_spec(d: int, ff: int, act: str) -> Dict[str, ParamSpec]:
    if act == "swiglu":
        return {
            "w_gate": ParamSpec((d, ff), "scaled"),
            "w_up": ParamSpec((d, ff), "scaled"),
            "w_down": ParamSpec((ff, d), "scaled"),
        }
    return {
        "w_in": ParamSpec((d, ff), "scaled"),
        "b_in": ParamSpec((ff,), "zeros"),
        "w_out": ParamSpec((ff, d), "scaled"),
        "b_out": ParamSpec((d,), "zeros"),
    }


def apply_mlp(x: torch.Tensor, p: Dict[str, torch.Tensor],
              act: str) -> torch.Tensor:
    if act == "swiglu":
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        return (F.silu(g) * u) @ p["w_down"]
    h = F.gelu(x @ p["w_in"] + p["b_in"], approximate="tanh")
    return h @ p["w_out"] + p["b_out"]


# -- embeddings ----------------------------------------------------------------

def embed_spec(vocab: int, d: int) -> ParamSpec:
    return ParamSpec((vocab, d), "normal", 0.02)


def unembed_spec(d: int, vocab: int) -> ParamSpec:
    return ParamSpec((d, vocab), "scaled")
