"""Parameter specs and the elementary layers of the dense family, with
the two init rules of the mamba2 mixer (``arange_log``, ``uniform_dt``).

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
    init: str = "normal"   # normal | zeros | ones | scaled | arange_log
                           # | uniform_dt
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
        elif s.init == "arange_log":
            t = arange_log(s.shape)
        elif s.init == "uniform_dt":
            t = uniform_dt(s.shape, generator)
        else:
            std = s.scale
            if s.init == "scaled":
                std = s.scale / math.sqrt(max(s.shape[s.fan_in_axis], 1))
            t = torch.randn(s.shape, generator=generator) * std
        out[key] = t.to(device=device, dtype=dtype)
    return out


def arange_log(shape: Tuple[int, ...]) -> torch.Tensor:
    """Mamba A_log init: log 1..H along the last axis."""
    h = shape[-1]
    return torch.log(torch.arange(1, h + 1, dtype=torch.float32)
                     ).expand(shape).clone()


def uniform_dt(shape: Tuple[int, ...], generator: torch.Generator,
               dt_min: float = 1e-3, dt_max: float = 0.1,
               floor: float = 1e-4) -> torch.Tensor:
    """Mamba dt_bias init: the inverse softplus of a log-uniform dt in
    [dt_min, dt_max], floored at ``floor``."""
    u = torch.rand(shape, generator=generator)
    dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min))
                   + math.log(dt_min))
    dt = torch.clamp(dt, min=floor)
    return dt + torch.log(-torch.expm1(-dt))


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
              act: str, tp=None) -> torch.Tensor:
    """The MLP; under tensor parallelism (``tp``, a
    ``serving.tp.TPContext``) ``p`` holds the rank's slice of the ffn
    hidden in the up projections, and the hidden is gathered from every
    rank before the (whole) down projection."""
    if act == "swiglu":
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        h = F.silu(g) * u
        if tp is not None:
            h = tp.gather_hidden(h)
        return h @ p["w_down"]
    h = F.gelu(x @ p["w_in"] + p["b_in"], approximate="tanh")
    if tp is not None:
        h = tp.gather_hidden(h)
    return h @ p["w_out"] + p["b_out"]


# -- embeddings ----------------------------------------------------------------

def embed_spec(vocab: int, d: int) -> ParamSpec:
    return ParamSpec((vocab, d), "normal", 0.02)


def unembed_spec(d: int, vocab: int) -> ParamSpec:
    return ParamSpec((d, vocab), "scaled")
