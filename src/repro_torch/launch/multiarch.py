"""Run the SpecReason controller with a base model of every architecture
the port's registry has, at the registry's reduced sizes: one small
dense speculator drafts for each base, and each base rolls back its own
way (an attention cache by truncation; SSM state, and a hybrid's K/V
and SSM state together, by snapshot and replay).  The port's twin of
the JAX package's ``examples/multiarch_smoke.py``, over the port's
registry: phi3-mini-3.8b, starcoder2-7b (sliding window) and minitron-4b
(dense), mamba2-1.3b (ssm), hymba-1.5b (hybrid: windowed attention and a
mamba2 mixer in each layer), granite-moe-1b-a400m (moe: a mixture of
experts in each layer), whisper-base (encdec) and llama-3.2-vision-11b
(vlm).  The two cross-attention bases attend to a stub source attached
to their sessions (``loader.attach_cross_source``: N(0, 1) x 0.1 from
seed 7, 64 frame embeddings that the encoder encodes, or 16 patch
embeddings), as the JAX package's example attaches it; the controller
is unchanged.  The registry refuses the JAX package's other two
architectures (yi-34b, and qwen3-moe-235b-a22b, too large for one
card).  Each engine decodes by its default loop (the fused one, for
every family), and each line names the base's family, its rollback and
both engines' loops.

  PYTHONPATH=src python -m repro_torch.launch.multiarch --device cpu
"""

from __future__ import annotations

import argparse
import random
from typing import List, Optional

import torch

from .. import device as devices
from ..configs import registry
from ..core.controller import SpecReason, SpecReasonConfig
from ..core.policies import StaticThreshold
from ..data import tasks
from ..models.config import ModelConfig
from ..models.model import Model
from ..serving.engine import Engine
from ..serving.loader import arch_config, attach_cross_source, \
    decode_loops
from ..tokenizer import toy as tk

SMALL = ModelConfig(name="spec-small", family="dense", n_layers=1,
                    d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
                    d_ff=128, vocab_size=tk.VOCAB_SIZE)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    small_model = Model(SMALL)
    small = Engine(small_model, small_model.init(1, device=dev),
                   max_len=256, name="small")
    prompt = tasks.question_tokens(tasks.sample_task(random.Random(3)))
    for arch in registry.ASSIGNED:
        cfg = arch_config(arch, reduced=True)
        model = Model(cfg)
        base = attach_cross_source(Engine(model, model.init(0, device=dev),
                                          max_len=256, name=arch))
        sr = SpecReason(base, small, SpecReasonConfig(
            policy=StaticThreshold(5.0), token_budget=24, max_steps=3))
        res = sr.run(prompt, torch.Generator(device=dev).manual_seed(11))
        print(f"{arch:24s} [{cfg.family:7s}] steps={len(res.steps)} "
              f"think={res.n_thinking_tokens:3d} "
              f"wall={res.wall_time:5.2f}s "
              f"rollback={'snapshot' if cfg.has_ssm else 'kv-truncate'} "
              f"decode loop: {decode_loops(base, small)}")


if __name__ == "__main__":
    main()
