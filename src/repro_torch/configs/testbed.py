"""Toy testbed model pair for the runnable SpecReason experiments.

The *mechanism-scale* analog of the paper's (QwQ-32B, R1-1.5B) pair: the
base model is ~8x the small model's per-token FLOPs, trained longer and on
score supervision (so it can act as the verifier); the small model trains
on the compact CoT style only (it is genuinely less verbose, reproducing
the paper's Fig 4a effect)."""

from ..models.config import ModelConfig
from ..tokenizer import toy as tk

BASE = ModelConfig(
    name="testbed-base",
    family="dense",
    n_layers=5,
    d_model=224,
    n_heads=8, n_kv_heads=4, head_dim=28,
    d_ff=896,
    vocab_size=tk.VOCAB_SIZE,
    max_position_embeddings=2048,
).validate()

SMALL = ModelConfig(
    name="testbed-small",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=512,
    vocab_size=tk.VOCAB_SIZE,
    max_position_embeddings=2048,
).validate()

# Dispatch-bound decode probe: a drafter so small that per-token model
# compute is negligible next to per-token host/dispatch overhead on any
# host — the regime the paper's accelerators are in for BOTH models.  The
# decode microbenchmark (benchmarks/bench_decode.py) uses it to isolate
# the decode-loop overhead that the fused while_loop removes; at micro
# scale the fused/eager ratio IS the loop-overhead ratio.  (On a slow
# emulated CPU the trained pair above can be compute-bound, which caps
# their end-to-end fused speedup at 1 + overhead/compute.)
MICRO = ModelConfig(
    name="testbed-micro",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128,
    vocab_size=tk.VOCAB_SIZE,
    max_position_embeddings=2048,
).validate()

# The micro pair's drafter: pairs with MICRO for the serving-throughput
# benchmark (benchmarks/bench_serving.py), where both models must be
# dispatch-bound so the sequential/continuous req/s ratio isolates the
# scheduler, not host matmul throughput.
MICRO_SMALL = ModelConfig(
    name="testbed-micro-small",
    family="dense",
    n_layers=1,
    d_model=32,
    n_heads=2, n_kv_heads=2, head_dim=16,
    d_ff=64,
    vocab_size=tk.VOCAB_SIZE,
    max_position_embeddings=2048,
).validate()
