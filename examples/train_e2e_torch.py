"""End-to-end driver (PyTorch / CUDA port): train a qwen3-style model for a
few hundred steps with checkpointing.

    PYTHONPATH=src python examples/train_e2e_torch.py [--steps 300] [--device cpu]

The twin of ``examples/train_e2e.py`` on ``repro_torch``, through
``repro_torch.launch.train.main``, on the card by default: qwen3-0.6b
reduced keeps the full substrate (data pipeline, AdamW, checkpoint /
restart).  A checkpoint directory that already holds steps is resumed
from, as the launcher does.
"""

import argparse
import os
import tempfile

from repro_torch.launch import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_e2e"))
    ap.add_argument("--device", default="cuda",
                    help="device of the model and data (default: cuda)")
    args = ap.parse_args(argv)

    first, last = train.main([
        "--arch", "qwen3-0.6b", "--reduced",
        "--steps", str(args.steps),
        "--batch", "8", "--seq", "128",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100",
        "--log-every", "25", "--device", args.device,
    ])
    assert last < first, "loss did not decrease"
    print(f"loss {first:.3f} -> {last:.3f}: OK")


if __name__ == "__main__":
    main()
