"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

decode_attention  flash-decode: one token per row over a dense KV cache
                  (port of the Pallas ``decode_attention``)
flash_attention   causal GQA prefill / verification attention with a
                  query offset, a kv length and a window, on the tensor
                  cores (3xTF32 mma.sync; port of the Pallas
                  ``flash_attention``)
paged_decode_attention  flash-decode over a page pool through per-row block
                  tables (port of the Pallas ``paged_decode_attention``)
paged_append_attention  span attention: T queries per row over its pages
                  plus the span's own K/V, on the tensor cores (3xTF32
                  mma.sync; port of the Pallas ``paged_append_attention``)
ssd_scan          Mamba2 chunked SSD scan: intra-chunk quadratic term plus
                  the inter-chunk state recurrence (port of the Pallas
                  ``ssd_scan``)

``csrc/`` holds the CUDA sources (``decode_core.cuh`` is the flash-decode
body both decode kernels share, ``tf32_mma.cuh`` the tensor-core helpers
of flash_attention and paged_append_attention), ``tile_plan`` the block
and split plan of the four attention kernels, ``build`` compiles the
sources with nvcc at first use, ``ref`` holds the plain PyTorch versions
of the attention kernels and the SSD scan's sequential oracle (the scan's
plain version is ``models.mamba2.ssd_chunked``), ``counts`` the
wrappers' launch counts (launches recorded into a CUDA graph count on
each replay), and ``ops`` dispatches: CPU tensors to the plain versions,
CUDA tensors to the kernels.
"""
