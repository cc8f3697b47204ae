"""phi3-mini-3.8b — RoPE SwiGLU GQA [arXiv:2404.14219].

32L d_model=3072 32H (GQA kv=32 => MHA) d_ff=8192 vocab=32064.
A copy of the JAX package's ``configs/phi3_mini_3_8b.py``."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    citation="arXiv:2404.14219",
    n_layers=32,
    d_model=3072,
    n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192,
    vocab_size=32064,
).validate()
