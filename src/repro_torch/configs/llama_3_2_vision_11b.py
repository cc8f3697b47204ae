"""llama-3.2-vision-11b [hf:meta-llama/Llama-3.2-11B-Vision].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; every 5th layer is
a gated cross-attention layer over image-patch embeddings.  The ViT vision
encoder + projector is a stub: the session takes precomputed patch
embeddings (B, 1601, d_model).
A copy of the JAX package's ``configs/llama_3_2_vision_11b.py``."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    citation="hf:meta-llama/Llama-3.2-11B-Vision",
    n_layers=40,
    d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    cross_attn_every=5,
    n_image_tokens=1601,
).validate()
