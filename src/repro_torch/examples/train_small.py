"""Train a small LM on the synthetic pipeline, then restart it from its
checkpoint for 10 more steps (the fault-tolerance demo; port of
``examples/train_small.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_small \\
        [--steps 200] [--device cpu] [--ckpt-dir DIR]

Checkpoints go to a fresh temporary directory unless ``--ckpt-dir`` names
one; they are the reference's files, so ``repro.launch.train`` resumes
from them too.
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    args = ap.parse_args(argv)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    common = ["--arch", "codellama-7b", "--smoke", "--batch",
              str(args.batch), "--seq", str(args.seq), "--lr", "3e-3",
              "--ckpt-dir", ckpt, "--device", args.device]
    losses = train_main(common + ["--steps", str(args.steps),
                                  "--ckpt-every", "100"])
    assert losses[-1] < losses[0], "loss did not improve"
    print("resuming from checkpoint for 10 more steps (restart demo)...")
    resumed = train_main(common + ["--steps", str(args.steps + 10)])
    print("OK")
    return {"losses": losses, "resumed": resumed, "ckpt_dir": ckpt}


if __name__ == "__main__":
    main()
