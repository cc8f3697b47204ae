"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-30B-A3B lineage].

94L d_model=4096 64H (GQA kv=4) per-expert d_ff=1536 vocab=151936,
MoE 128 experts top-8.
A copy of the JAX package's ``configs/qwen3_moe_235b.py``.  The port's
registry refuses it: 235 B parameters do not fit one 80 GB card."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    citation="hf:Qwen/Qwen3-30B-A3B",
    n_layers=94,
    d_model=4096,
    n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    n_experts=128, top_k=8,
    rope_theta=1000000.0,
).validate()
