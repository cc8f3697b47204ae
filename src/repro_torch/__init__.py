"""PyTorch/CUDA port of the SpecReason system (Pan et al., 2025).

A package of its own beside the JAX package ``repro``, which stays the
reference.  It imports ``torch`` and never ``jax``, and nothing of
``repro``: modules it shares with the reference (configs, tokenizer,
segmenter, policies, tasks) are copies.

Subpackages (the sequential and continuous-batching serving paths of the
dense family):
  kernels    hand-written CUDA kernels for Hopper (sm_90a) + plain
             PyTorch versions; ``ops`` dispatches CPU tensors to the
             plain version and CUDA tensors to the kernel
  models     dense transformer forward, prefill and decode over a KV
             cache, and batched rows over a paged KV store
  sampling   logit adjustment and Gumbel-argmax sampling
  serving    the single-request Engine, the checkpoint loader, and the
             continuous-batching stack: paged KV, the batched and spec
             engines, the scheduler and the workload runner
  core       the SpecReason controller, verifier, token-level spec
             decode and baselines
  launch     ``python -m repro_torch.launch.serve``

Every entry point takes a ``device`` and defaults to ``"cuda"``; pass
``"cpu"`` to run the plain versions.
"""
