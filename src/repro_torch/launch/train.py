"""Training CLI of the port: trains the toy testbed LRM pair on the
synthetic chain-arithmetic CoT tasks (the models SpecReason serves), on
the card by default.

  PYTHONPATH=src python -m repro_torch.launch.train --model base --steps 500
  PYTHONPATH=src python -m repro_torch.launch.train --model small \\
      --steps 400 --device cpu

The settings are the JAX package's (``repro.launch.train``); checkpoints
land in ``--ckpt-dir`` as ``testbed-base.npz`` and ``testbed-small.npz``,
in the format both packages read.
"""

from __future__ import annotations

import argparse
import os

from ..configs import testbed
from ..training.optimizer import AdamWConfig
from ..training.train_loop import TrainConfig, train

DEFAULT_CKPT_DIR = "exp/ckpt"


def ckpt_path(name: str, ckpt_dir: str = DEFAULT_CKPT_DIR) -> str:
    return os.path.join(ckpt_dir, f"{name}.npz")


def train_testbed_model(which: str, steps: int,
                        ckpt_dir: str = DEFAULT_CKPT_DIR, seed: int = 0,
                        log=print, device="cuda"):
    cfg = testbed.BASE if which == "base" else testbed.SMALL
    if which == "base":
        # base: verbose CoTs (style-robust) + score supervision -> verifier
        tcfg = TrainConfig(steps=steps, batch_size=16, seq_len=112,
                           kind="mixed", style_mix=(0.85, 0.1),
                           score_frac=0.3, seed=seed,
                           opt=AdamWConfig(lr=1.5e-3, warmup_steps=40))
    else:
        # small: compact CoTs only (genuinely less verbose), no score data
        tcfg = TrainConfig(steps=steps, batch_size=16, seq_len=96,
                           kind="cot", style_mix=(0.0, 0.0), seed=seed + 1,
                           opt=AdamWConfig(lr=2e-3, warmup_steps=30))
    return train(cfg, tcfg, ckpt_path=ckpt_path(cfg.name, ckpt_dir), log=log,
                 device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--model", choices=("base", "small", "both"),
                    default="both")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--small-steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.model in ("base", "both"):
        train_testbed_model("base", args.steps, args.ckpt_dir,
                            device=args.device)
    if args.model in ("small", "both"):
        train_testbed_model("small", args.small_steps or args.steps,
                            args.ckpt_dir, device=args.device)


if __name__ == "__main__":
    main()
