"""Training launcher of the port: AdamW steps on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \
        --preset full --steps 6 --batch 2 --seq 2048

Counterpart of the JAX package's ``launch/train.py``, same flags and log
line, plus ``--device`` (default ``cuda``; ``--device cpu`` runs the
kernels' plain versions). Random init from ``--seed`` on a generator on
the run's device; per-layer remat on. ``--preset smoke`` runs the
arch's reduced config, ``full`` its published widths. Checkpoint /
restart with ``--checkpoint-dir`` and ``--resume``. ``--compile-only``
runs the arch's ``train_4k`` cell of the dry run instead of training
(``launch/dryrun.py``: the full config's step counted on the ``meta``
device, written to ``results/dryrun``), on one card or, with ``--mesh
single|multi``, on the 16 x 16 or 2 x 16 x 16 mesh as JAX's does, and
prints its status. As in JAX, each step's batch carries the stub
frontend inputs of the vlm (``patches``) and the encoder-decoder
(``frames``) from one ``numpy.random.default_rng(0)`` drawn once a
step (``data.pipeline.attach_modality_stubs``); an MoE arch's loss adds
``router_aux_coef`` x its router aux loss.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..configs import ARCHS, get_config, smoke_config
from ..data.pipeline import attach_modality_stubs, make_dataset
from ..distributed.checkpoint import CheckpointManager
from ..distributed.optimizer import Optimizer, OptimizerConfig
from ..models.config import ModelConfig
from ..models.layers import resolve_device
from ..models.registry import get_api
from ..models.steps import make_train_step


def build(cfg: ModelConfig, *, steps: int, lr: float, seed: int,
          device: torch.device, impl: str = "auto", remat: bool = True):
    """(params, optimizer, opt_state, train_step) as the launcher makes
    them: random init on a generator on ``device``, AdamW with 10 warmup
    steps and cosine decay over ``max(steps, 100)``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = get_api(cfg).init(cfg, gen, device=device)
    opt = Optimizer(OptimizerConfig(lr=lr, warmup_steps=10,
                                    decay_steps=max(steps, 100)))
    return (params, opt, opt.init(params),
            make_train_step(cfg, opt, remat=remat, impl=impl))


def batch_on(cfg: ModelConfig, ds, step: int, rng: np.random.Generator,
             device: torch.device) -> Dict[str, torch.Tensor]:
    """Step ``step``'s batch of ``ds`` with the family's stub inputs
    drawn from ``rng`` (none for a family without them), on
    ``device``."""
    batch = attach_modality_stubs(cfg, ds.batch(step), rng)
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-135m", choices=ARCHS)
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--dataset", default="synthetic",
                    choices=["synthetic", "corpus"])
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compile-only", action="store_true",
                    help="count the full config's train_4k step on the meta "
                         "device (the dry run) instead of training")
    ap.add_argument("--mesh", default="card",
                    choices=["card", "single", "multi"],
                    help="--compile-only's mesh: one card, 16x16 or 2x16x16")
    args = ap.parse_args(argv)

    if args.compile_only:
        from .dryrun import run_cell
        multi = {"card": None, "single": False, "multi": True}[args.mesh]
        rec = run_cell(args.arch, "train_4k", out_dir="results/dryrun",
                       multi_pod=multi)
        print(rec["status"], rec.get("roofline", rec.get("error")))
        return 0 if rec["status"] == "ok" else 1

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.preset == "smoke" \
        else get_config(args.arch)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"dataset={args.dataset} steps={args.steps}")

    params, _, opt_state, step_fn = build(
        cfg, steps=args.steps, lr=args.lr, seed=args.seed, device=device)
    ds = make_dataset(args.dataset, cfg, args.seq, args.batch)

    start = 0
    ckpt = None
    if args.checkpoint_dir:
        ckpt = CheckpointManager(args.checkpoint_dir)
        if args.resume and ckpt.latest_step() is not None:
            start, state, _ = ckpt.restore({"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            print(f"resumed from step {start}")

    rng = np.random.default_rng(0)
    t0 = time.time()
    for step in range(start, args.steps):
        params, opt_state, m = step_fn(params, opt_state,
                                       batch_on(cfg, ds, step, rng, device))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss={float(m['loss']):.4f} "
                  f"gnorm={float(m['grad_norm']):.3f} "
                  f"lr={float(m['lr']):.2e} "
                  f"({(time.time()-t0)/(step-start+1):.2f}s/step)",
                  flush=True)
        if ckpt and (step + 1) % args.checkpoint_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state})
    if ckpt:
        ckpt.save(args.steps, {"params": params, "opt": opt_state})
        ckpt.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
