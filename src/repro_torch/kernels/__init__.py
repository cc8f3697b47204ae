"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

decode_attention  flash-decode: one token per row over a dense KV cache
                  (port of the Pallas ``decode_attention``)
flash_attention   causal GQA prefill / verification attention with a
                  query offset, a kv length and a window (port of the
                  Pallas ``flash_attention``)

``csrc/`` holds the CUDA sources, ``build`` compiles them with nvcc at
first use, ``ref`` holds the plain PyTorch versions, and ``ops``
dispatches: CPU tensors to ``ref``, CUDA tensors to the kernels.
"""
