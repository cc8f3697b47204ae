"""SpecReason core: step speculation by the small model, one-pass
verification by the base model, accept or regenerate.

segmenter   reasoning-step boundary detection (copy of the reference)
verifier    prefill-only single-token utility scoring
policies    acceptance policies (copy of the reference)
controller  speculate -> verify -> accept / fallback loop
baselines   vanilla reasoning with one model
"""
