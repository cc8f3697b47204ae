"""whisper-base — encoder-decoder, conv frontend stubbed [arXiv:2212.04356].

6L (decoder) + 6L (encoder) d_model=512 8H d_ff=2048 vocab=51865.
The mel-spectrogram + conv feature extractor is a stub: the session takes
precomputed frame embeddings (B, 1500, d).  Sinusoidal positions for both
encoder and decoder (the HF card uses learned decoder positions).
A copy of the JAX package's ``configs/whisper_base.py``."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    citation="arXiv:2212.04356",
    n_layers=6,
    n_encoder_layers=6,
    d_model=512,
    n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    norm_type="layernorm",
    act="gelu",
    use_rope=False,
    encoder_seq_len=1500,
).validate()
