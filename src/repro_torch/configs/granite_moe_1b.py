"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) per-expert d_ff=512 vocab=49155,
MoE 32 experts top-8.
A copy of the JAX package's ``configs/granite_moe_1b.py``."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
    n_layers=24,
    d_model=1024,
    n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512,
    vocab_size=49155,
    n_experts=32, top_k=8,
    tie_embeddings=True,
).validate()
