"""Train the toy testbed LRM pair end-to-end with the PyTorch port (the
twin of examples/train_toy_lrm.py): the base model learns verbose CoTs +
utility scoring, the small model compact CoTs.  On the card by default;
checkpoints land in exp/ckpt/ in the format both packages read.

  PYTHONPATH=src python examples/train_toy_lrm_torch.py --steps 500
  PYTHONPATH=src python examples/train_toy_lrm_torch.py --device cpu
"""

import argparse

from repro_torch.launch.train import train_testbed_model


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--small-steps", type=int, default=400)
    ap.add_argument("--ckpt-dir", default="exp/ckpt")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    train_testbed_model("base", args.steps, args.ckpt_dir,
                        device=args.device)
    train_testbed_model("small", args.small_steps, args.ckpt_dir,
                        device=args.device)
    print("done; serve the pair with "
          "python -m repro_torch.launch.serve --ckpt-dir exp/ckpt")


if __name__ == "__main__":
    main()
