"""PyTorch/CUDA port of the SpecReason system (Pan et al., 2025).

A package of its own beside the JAX package ``repro``, which stays the
reference.  It imports ``torch`` and never ``jax``, and nothing of
``repro``: modules it shares with the reference (configs, tokenizer,
segmenter, policies, tasks) are copies.

Subpackages (the sequential serving path of the dense family):
  kernels    hand-written CUDA kernels for Hopper (sm_90a) + plain
             PyTorch versions; ``ops`` dispatches CPU tensors to the
             plain version and CUDA tensors to the kernel
  models     dense transformer forward, prefill and decode over a KV cache
  sampling   logit adjustment and Gumbel-argmax sampling
  serving    the single-request Engine and the checkpoint loader
  core       the SpecReason controller, verifier and baselines
  launch     ``python -m repro_torch.launch.serve``

Every entry point takes a ``device`` and defaults to ``"cuda"``; pass
``"cpu"`` to run the plain versions.
"""
