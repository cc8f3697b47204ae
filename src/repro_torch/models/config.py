"""Model configuration for every architecture family the framework supports.

A single :class:`ModelConfig` dataclass describes all six families
(dense / moe / ssm / hybrid / encdec / vlm).  Family-specific fields are
ignored by families that do not use them; ``validate()`` enforces
consistency.  Configs live in ``repro_torch.configs.<arch>`` and are
plain instances of this class.  A copy of the JAX package's
``models/config.py``: the port imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # -- identity ---------------------------------------------------------
    name: str = "unnamed"
    family: str = "dense"
    citation: str = ""

    # -- trunk ------------------------------------------------------------
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0          # 0 -> d_model // n_heads
    d_ff: int = 1024           # dense MLP hidden (for moe: per-expert hidden)
    vocab_size: int = 512
    rmsnorm_eps: float = 1e-5
    norm_type: str = "rmsnorm"   # "rmsnorm" | "layernorm" (whisper)
    act: str = "swiglu"          # "swiglu" | "gelu" (whisper)
    rope_theta: float = 10000.0
    use_rope: bool = True        # whisper decoder uses learned abs pos instead
    max_position_embeddings: int = 1 << 20
    tie_embeddings: bool = False
    dtype: str = "float32"       # computation dtype ("bfloat16" for dry-run)
    remat: bool = True           # activation-checkpoint each layer in train

    # -- attention variants ------------------------------------------------
    sliding_window: int = 0      # 0 = full attention; >0 = window size
    # Window used when serving the long_500k shape on attention archs:
    long_context_window: int = 8192

    # -- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 512   # tokens per GShard dispatch group
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3

    # -- SSM (Mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0           # N
    ssm_head_dim: int = 64       # P
    ssm_expand: int = 2          # d_inner = expand * d_model
    ssm_n_groups: int = 1        # G (B/C projection groups)
    ssm_conv_width: int = 4
    ssm_chunk: int = 128         # SSD chunk length
    ssm_dt_min: float = 0.001
    ssm_dt_max: float = 0.1

    # -- hybrid (hymba): parallel attn + ssm heads in each layer -------------
    # hybrid layers use both the attention fields and the ssm fields.

    # -- encoder-decoder (whisper) -------------------------------------------
    n_encoder_layers: int = 0
    encoder_seq_len: int = 1500   # precomputed audio frame embeddings (stub)

    # -- VLM (llama-3.2-vision): interleaved cross-attention layers ----------
    cross_attn_every: int = 0     # every Nth layer is a cross-attn layer
    n_image_tokens: int = 1601    # precomputed patch embeddings (stub)

    # ------------------------------------------------------------------ api
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def n_cross_layers(self) -> int:
        if self.family == "vlm" and self.cross_attn_every:
            return self.n_layers // self.cross_attn_every
        if self.family == "encdec":
            return self.n_layers  # every decoder layer cross-attends
        return 0

    @property
    def n_self_layers(self) -> int:
        return self.n_layers - (self.n_layers // self.cross_attn_every
                                if self.family == "vlm" and self.cross_attn_every else 0)

    def validate(self) -> "ModelConfig":
        assert self.family in FAMILIES, self.family
        if self.family != "ssm":
            assert self.n_heads % self.n_kv_heads == 0, (
                f"{self.name}: n_heads={self.n_heads} not divisible by "
                f"n_kv_heads={self.n_kv_heads}")
        if self.family == "moe":
            assert self.n_experts > 0 and 0 < self.top_k <= self.n_experts
        if self.family in ("ssm", "hybrid"):
            assert self.ssm_state > 0
            assert self.ssm_d_inner % self.ssm_head_dim == 0
        if self.family == "vlm":
            assert self.cross_attn_every > 0
            assert self.n_layers % self.cross_attn_every == 0
        if self.family == "encdec":
            assert self.n_encoder_layers > 0
        return self

    # -- parameter counting (for roofline MODEL_FLOPS) ------------------------
    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count; active_only counts top_k experts."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            return d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d

        def mlp_params() -> int:
            if self.act == "swiglu":
                return 3 * d * ff
            return 2 * d * ff

        def ssm_params() -> int:
            di, n, g = self.ssm_d_inner, self.ssm_state, self.ssm_n_groups
            h = self.ssm_n_heads
            in_proj = d * (2 * di + 2 * g * n + h)
            conv = (di + 2 * g * n) * self.ssm_conv_width
            out = di * d
            return in_proj + conv + out + 2 * h  # + A_log, D, dt_bias(h)

        per_layer = 0
        if self.family == "dense":
            per_layer = attn_params() + mlp_params()
            total = self.n_layers * per_layer
        elif self.family == "moe":
            experts = self.n_experts if not active_only else self.top_k
            per_layer = attn_params() + experts * 3 * d * ff + d * self.n_experts
            total = self.n_layers * per_layer
        elif self.family == "ssm":
            total = self.n_layers * ssm_params()
        elif self.family == "hybrid":
            total = self.n_layers * (attn_params() + ssm_params() + mlp_params())
        elif self.family == "encdec":
            dec = self.n_layers * (2 * attn_params() + mlp_params())
            enc = self.n_encoder_layers * (attn_params() + mlp_params())
            total = dec + enc
        elif self.family == "vlm":
            n_cross = self.n_cross_layers
            n_self = self.n_layers - n_cross
            total = (n_self * (attn_params() + mlp_params())
                     + n_cross * (2 * attn_params() + mlp_params()))
        else:  # pragma: no cover
            raise ValueError(self.family)
        return total + emb

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test variant of the same family (tiny but same code paths)."""
        small = dict(
            n_layers=2,
            d_model=min(self.d_model, 128),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=32,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            max_position_embeddings=4096,
        )
        if self.family == "moe":
            small.update(n_experts=min(self.n_experts, 4),
                         top_k=min(self.top_k, 2))
        if self.family in ("ssm", "hybrid"):
            small.update(ssm_state=min(self.ssm_state, 16), ssm_head_dim=16,
                         ssm_chunk=32)
        if self.family == "encdec":
            small.update(n_encoder_layers=2, encoder_seq_len=64)
        if self.family == "vlm":
            small.update(cross_attn_every=2, n_image_tokens=16)
        if self.family == "hybrid":
            small.update(n_heads=4, n_kv_heads=2)
        small.update(overrides)
        small.setdefault("name", self.name + "-smoke")
        return dataclasses.replace(self, **small).validate()


# ---------------------------------------------------------------------------
# Input shape suite (assigned)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
