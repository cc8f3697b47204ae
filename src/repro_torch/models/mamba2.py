"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) mixer.

The port of the JAX package's ``models/mamba2.py``: the chunked SSD scan
for prefill and extends (a quadratic intra-chunk term plus a linear
inter-chunk state recurrence) and the O(1) recurrent update for decode.
``apply_mamba`` sends its scan through ``kernels.ops.ssd``: a CPU tensor
runs ``ssd_chunked`` here (the plain version), a CUDA tensor launches the
hand-written kernel ``kernels/csrc/ssd_scan.cu``.  ``ssd_decode_step``
stays plain PyTorch, as the JAX package computes it outside any kernel.

Shapes (following the paper's minimal implementation):
  x  : (B, L, H, P)   inner activations, H = d_inner/P heads
  dt : (B, L, H)      softplus(dt + bias) per head
  A  : (H,)           negative decay rate (A = -exp(A_log))
  B,C: (B, L, G, N)   input/output projections, G groups broadcast to H
State: (B, H, P, N).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig
from .layers import ParamSpec


def mamba_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    di, n, g = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_groups
    h, w = cfg.ssm_n_heads, cfg.ssm_conv_width
    conv_ch = di + 2 * g * n
    return {
        "w_in": ParamSpec((d, 2 * di + 2 * g * n + h), "scaled", 1.0, 0),
        "conv_w": ParamSpec((w, conv_ch), "scaled", 1.0, 0),
        "conv_b": ParamSpec((conv_ch,), "zeros"),
        "A_log": ParamSpec((h,), "arange_log"),
        "D": ParamSpec((h,), "ones"),
        "dt_bias": ParamSpec((h,), "uniform_dt"),
        "norm_scale": ParamSpec((di,), "ones"),
        "w_out": ParamSpec((di, d), "scaled", 1.0, 0),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    di, n, g = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_groups
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * g * n]
    dt = zxbcdt[..., di + di + 2 * g * n:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d as the JAX package writes it: W shifted
    multiply-adds (not ``conv1d``, which runs in TF32 through cuDNN by
    default).  xbc: (B, L, C); w: (W, C).

    Returns (out (B, L, C), final conv state (B, W-1, C))."""
    bsz, l, ch = xbc.shape
    width = w.shape[0]
    if init_state is None:
        init_state = torch.zeros((bsz, width - 1, ch), dtype=xbc.dtype,
                                 device=xbc.device)
    padded = torch.cat([init_state.to(xbc.dtype), xbc], dim=1)
    out = torch.zeros_like(xbc)
    for i in range(width):
        out = out + padded[:, i:i + l, :] * w[i]
    new_state = padded[:, l:, :] if width > 1 else init_state
    return F.silu(out + b), new_state


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with the JAX package's type promotion (bf16 with
    fp32 computes in fp32); torch refuses operands of mixed dtypes."""
    dt = functools.reduce(torch.promote_types, (o.dtype for o in ops))
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: a (..., q) -> (..., q, q) lower-triangular sums
    S[i, j] = sum(a[j+1..i]) for j < i, 0 on diagonal, -inf above."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    s = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return s.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, the plain version of ``kernels/csrc/ssd_scan.cu``.

    x: (B,L,H,P), dt: (B,L,H) (already softplus'd), a: (H,) negative,
    b,c: (B,L,G,N); L a multiple of ``chunk``.  Returns (y (B,L,H,P),
    final_state (B,H,P,N)), the final state in x's dtype as in the JAX
    package's ``ssd_chunked``.
    """
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if l % chunk:
        raise ValueError(f"L ({l}) must be a multiple of chunk ({chunk})")
    nc = l // chunk
    rep = h // g

    bh = b.repeat_interleave(rep, dim=2)              # (B,L,H,N)
    ch_ = c.repeat_interleave(rep, dim=2)

    xd = x * dt[..., None]                            # discretized input
    ad = a[None, None, :] * dt                        # (B,L,H) log-decay

    def r(t):  # L -> (nc, chunk)
        return t.reshape(bsz, nc, chunk, *t.shape[2:])

    xc, adc, bc, cc = r(xd), r(ad), r(bh), r(ch_)
    adc = adc.permute(0, 1, 3, 2)                     # (B,nc,H,Q)
    a_cum = torch.cumsum(adc, dim=-1)                 # (B,nc,H,Q)

    # 1) intra-chunk (quadratic in Q)
    lmat = torch.exp(_segsum(adc))                    # (B,nc,H,Q,Q)
    scores = _einsum("bzqhn,bzshn->bzhqs", cc, bc) * lmat
    y_diag = _einsum("bzhqs,bzshp->bzqhp", scores, xc)

    # 2) per-chunk final-state contribution
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # (B,nc,H,Q)
    states = _einsum("bzshn,bzhs,bzshp->bzhpn", bc, decay_states, xc)

    # 3) inter-chunk recurrence (a loop over chunks)
    chunk_decay = torch.exp(a_cum[..., -1])           # (B,nc,H)
    if init_state is None:
        init_state = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                                 device=x.device)
    carry = init_state.float()
    prev = []
    for z in range(nc):
        prev.append(carry)                            # state entering chunk
        carry = carry * chunk_decay[:, z, :, None, None].float() \
            + states[:, z].float()
    prev_states = torch.stack(prev, dim=1)            # (B,nc,H,P,N)

    # 4) chunk-input contribution through entering state
    state_decay = torch.exp(a_cum)                    # (B,nc,H,Q)
    y_off = _einsum("bzqhn,bzhpn,bzhq->bzqhp", cc,
                    prev_states.to(cc.dtype), state_decay.to(cc.dtype))

    y = (y_diag + y_off).reshape(bsz, l, h, p)
    return y, carry.to(x.dtype)


def ssd_decode_step(xt: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    bt: torch.Tensor, ct: torch.Tensor, state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(1) recurrent step.  xt: (B,H,P), dt: (B,H), bt/ct: (B,G,N),
    state: (B,H,P,N)."""
    h = xt.shape[1]
    g = bt.shape[1]
    rep = h // g
    bh = bt.repeat_interleave(rep, dim=1)             # (B,H,N)
    chh = ct.repeat_interleave(rep, dim=1)
    decay = torch.exp(a[None, :] * dt)                # (B,H)
    upd = _einsum("bhp,bhn->bhpn", xt * dt[..., None], bh)
    new_state = state * decay[..., None, None] + upd
    y = _einsum("bhpn,bhn->bhp", new_state, chh)
    return y, new_state


def gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Mamba2 output norm: RMSNorm(y * silu(z)) * scale."""
    dt_ = y.dtype
    y = (y * F.silu(z)).float()
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(dt_)


def apply_mamba(x: torch.Tensor, p: Dict[str, torch.Tensor],
                cfg: ModelConfig,
                state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                return_state: bool = False):
    """Full-sequence mamba2 mixer.  x: (B, L, d).

    state: optional (conv_state (B,W-1,C), ssm_state (B,H,P,N)) to resume
    from (chunked prefill).  Returns y or (y, new_state); the new state's
    tensors are new, never the inputs written over."""
    bsz, l, d = x.shape
    di, n, g, h = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_groups,
                   cfg.ssm_n_heads)
    pdim = cfg.ssm_head_dim

    zxbcdt = x @ p["w_in"]
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    conv_in = None if state is None else state[0]
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_in)
    xs = xbc[..., :di].reshape(bsz, l, h, pdim)
    b = xbc[..., di:di + g * n].reshape(bsz, l, g, n)
    c = xbc[..., di + g * n:].reshape(bsz, l, g, n)
    dt = F.softplus(dt + p["dt_bias"])
    a = -torch.exp(p["A_log"].float())

    # pad L to a multiple of the chunk (pads contribute zero via dt=0)
    chunk = min(cfg.ssm_chunk, l)
    pad = (-l) % chunk
    xs_s, dt_s, b_s, c_s = xs, dt, b, c
    if pad:
        xs_s = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt_s = F.pad(dt, (0, 0, 0, pad))
        b_s = F.pad(b, (0, 0, 0, 0, 0, pad))
        c_s = F.pad(c, (0, 0, 0, 0, 0, pad))

    init_ssm = None if state is None else state[1]
    y, final = ops.ssd(xs_s, dt_s, a, b_s, c_s, chunk, init_ssm)
    if pad:
        y = y[:, :l]
    y = y + xs * p["D"][None, None, :, None]
    y = y.reshape(bsz, l, di)
    y = gated_rmsnorm(y, z, p["norm_scale"], cfg.rmsnorm_eps)
    out = (y @ p["w_out"]).to(x.dtype)
    if return_state:
        return out, (conv_state, final)
    return out


def apply_mamba_decode(x: torch.Tensor, p: Dict[str, torch.Tensor],
                       cfg: ModelConfig,
                       state: Tuple[torch.Tensor, torch.Tensor],
                       active: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor,
                                  Tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode.  x: (B, 1, d); state = (conv_state, ssm_state).
    Returns (y (B, 1, d), new state), the new state's tensors new.

    With a 0-d bool ``active`` (the fused decode loop's static buffers)
    the new states are written into ``state``'s own tensors instead, and
    ``state`` is returned: an active step writes what the new tensors
    would hold, a masked one leaves both tensors exactly as they were."""
    bsz = x.shape[0]
    di, n, g, h = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_groups,
                   cfg.ssm_n_heads)
    pdim = cfg.ssm_head_dim
    conv_state, ssm_state = state

    zxbcdt = (x @ p["w_in"])[:, 0]
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    # conv: append the new column, take the last W taps
    window = torch.cat([conv_state.to(xbc.dtype), xbc[:, None, :]], dim=1)
    conv_out = _einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"]
    xbc = F.silu(conv_out)
    new_conv_state = window[:, 1:, :]

    xt = xbc[..., :di].reshape(bsz, h, pdim)
    bt = xbc[..., di:di + g * n].reshape(bsz, g, n)
    ct = xbc[..., di + g * n:].reshape(bsz, g, n)
    dt = F.softplus(dt + p["dt_bias"])
    a = -torch.exp(p["A_log"].float())

    y, new_ssm = ssd_decode_step(xt.float(), dt.float(), a, bt.float(),
                                 ct.float(), ssm_state.float())
    y = y.to(x.dtype) + xt * p["D"][None, :, None]
    y = y.reshape(bsz, 1, di)
    y = gated_rmsnorm(y, z[:, None, :], p["norm_scale"], cfg.rmsnorm_eps)
    out = (y @ p["w_out"]).to(x.dtype)
    new_ssm = new_ssm.to(ssm_state.dtype)
    if active is None:
        return out, (new_conv_state, new_ssm)
    torch.where(active, new_conv_state, conv_state, out=conv_state)
    torch.where(active, new_ssm, ssm_state, out=ssm_state)
    return out, state
