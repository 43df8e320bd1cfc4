"""End-to-end training example on the port: data pipeline -> model ->
AdamW -> checkpointing, through ``repro_torch.launch.train``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm            # smoke
    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset full

The JAX example's run: smollm-135m, batch 8 x 128 synthetic tokens, a
checkpoint every 100 steps, a log line every 20. The smoke preset trains
the reduced config, ``full`` the published 135M widths; ``--device``
(default ``cuda``) picks the card or the CPU, ``--checkpoint-dir`` the
directory (by default one of the port's own, apart from the JAX
example's).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Optional

from repro_torch.launch.train import main as train_main


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train_lm"))
    args = ap.parse_args(argv)

    return train_main([
        "--arch", "smollm-135m",
        "--preset", args.preset,
        "--steps", str(args.steps),
        "--batch", "8",
        "--seq", "128",
        "--dataset", "synthetic",
        "--checkpoint-dir", args.checkpoint_dir,
        "--checkpoint-every", "100",
        "--log-every", "20",
        "--device", args.device,
    ])


if __name__ == "__main__":
    sys.exit(main())
