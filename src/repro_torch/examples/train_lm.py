"""End-to-end training scenario: a reduced granite-MoE trains for a few
hundred steps with checkpointing and straggler monitoring (a copy of
``examples/train_lm.py`` over ``repro_torch.launch.train``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200 \\
        [--device cpu] [--ckpt DIR]

The checkpoints go to ``--ckpt`` (default ``quickstart_ckpt`` in the
temporary directory); a directory that holds one resumes from it.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "quickstart_ckpt"))
    args = ap.parse_args(argv)
    from ..launch import train
    train.main(["--arch", "granite-moe-1b-a400m",
                "--steps", str(args.steps), "--reduced",
                "--ckpt", args.ckpt, "--batch", "16", "--seq", "128",
                "--device", args.device])
    return 0


if __name__ == "__main__":
    sys.exit(main())
