"""hymba-1.5b — parallel attention + mamba heads [arXiv:2411.13676].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Each layer runs attention and a Mamba2 mixer in parallel on the same
normed input and fuses the outputs (mean).  Attention uses a sliding
window (the Hymba design keeps most layers SWA), making this arch
long_500k-native.
A copy of the JAX package's ``configs/hymba_1_5b.py``."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    citation="arXiv:2411.13676",
    n_layers=32,
    d_model=1600,
    n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    sliding_window=2048,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_n_groups=1,
    ssm_chunk=128,
).validate()
