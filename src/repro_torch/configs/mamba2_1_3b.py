"""mamba2-1.3b — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=2048, attention-free, d_ff=0, vocab=50280, ssm_state=128.
d_inner = 2*d_model = 4096, head_dim 64 -> 64 SSD heads, 1 B/C group.
A copy of the JAX package's ``configs/mamba2_1_3b.py``."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    citation="arXiv:2405.21060",
    n_layers=48,
    d_model=2048,
    n_heads=1, n_kv_heads=1,   # unused (attention-free)
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_n_groups=1,
    ssm_conv_width=4,
    ssm_chunk=128,
    tie_embeddings=True,       # GPT-NeoX tokenizer family ties embeddings
).validate()
