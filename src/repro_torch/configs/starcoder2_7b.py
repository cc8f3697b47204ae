"""starcoder2-7b — GQA, RoPE, 4k sliding window [arXiv:2402.19173].

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
A copy of the JAX package's ``configs/starcoder2_7b.py``."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    citation="arXiv:2402.19173",
    n_layers=32,
    d_model=4608,
    n_heads=36, n_kv_heads=4, head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    sliding_window=4096,
    act="gelu",   # starcoder2 uses a 2-matrix GELU MLP, not SwiGLU
).validate()
