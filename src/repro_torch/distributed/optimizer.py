"""AdamW for the port's trainer (one device).

Port of the JAX package's ``distributed/optimizer.py``: the config, the
warmup + cosine schedule, the global norm and the AdamW update, with the
same arithmetic in the same order (float32 moments, global-norm clip,
bias corrections and the schedule at ``step + 1``). Decoupled weight
decay applies to every leaf with ``ndim >= 2`` as the tree holds it:
with layers stacked on a leading ``L`` axis that includes the per-layer
vectors (norm scales, ``A_log``, ``D``, ``dt_bias``, conv biases,
``gate_norm``), and leaves out only the unstacked ones such as
``final_norm`` (ROADMAP.md, C).

Unlike the JAX update, which returns new trees, :meth:`Optimizer.update`
writes params and moments in place, one slice of at most
``_SLICE`` elements at a time, so a full-width leaf (``[64, 2560, 5120]``
on mamba2-2.7b) needs a few float32 temporaries of one slice and not of
the whole leaf. ZeRO sharding of the state and the int8 compressed
all-reduce are multi-device and wait for ROADMAP.md, A9.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

# elements per slice of the in-place update and of the norm
_SLICE = 1 << 24


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nested dict in sorted-key order (``jax.tree_util``'s
    order for dicts)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """A tree like ``tree`` of ``fn`` over matching leaves, called in
    :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio * lr``; float32,
    on ``step``'s device."""
    s = torch.as_tensor(step).float()
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    ratio = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.clamp(warm, max=1.0) * ratio


def _slices(*tensors: torch.Tensor) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Matching flat slices of same-shaped tensors (views of contiguous
    ones, so writes to them land in the tensors)."""
    flat = [t.reshape(-1) for t in tensors]
    for i in range(0, flat[0].numel(), _SLICE):
        yield tuple(f[i:i + _SLICE] for f in flat)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    total = None
    for x in tree_leaves(tree):
        sq = sum(torch.sum(torch.square(s.float())) for (s,) in _slices(x))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


class Optimizer:
    """AdamW. State: ``{"m", "v"}`` float32 trees like the params and
    ``"step"``, a 0-dim int32 tensor on the params' device."""

    def __init__(self, config: Optional[OptimizerConfig] = None):
        self.config = config or OptimizerConfig()

    def init(self, params) -> Dict:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        step_device = tree_leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=step_device)}

    @torch.no_grad()
    def update(self, params, grads, state) -> Tuple[Dict, Dict, Dict]:
        """One AdamW step, in place on ``params`` and ``state``'s
        moments; returns (params, state, metrics) with the same trees."""
        cfg = self.config
        step = state["step"] + 1
        lr = lr_schedule(cfg, step)
        gnorm = global_norm(grads)
        clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        sf = step.float()
        b1c = 1.0 - torch.pow(cfg.b1, sf)
        b2c = 1.0 - torch.pow(cfg.b2, sf)

        def upd(p, g, m, v):
            decay = p.ndim >= 2     # the stacked leaf's ndim (see module doc)
            for ps, gs, ms, vs in _slices(p, g, m, v):
                gf = gs.float() * clip
                m_new = cfg.b1 * ms + (1.0 - cfg.b1) * gf
                v_new = cfg.b2 * vs + (1.0 - cfg.b2) * gf * gf
                mh = m_new / b1c
                vh = v_new / b2c
                delta = mh / (torch.sqrt(vh) + cfg.eps)
                if decay:
                    delta = delta + cfg.weight_decay * ps.float()
                ps.copy_((ps.float() - lr * delta).to(ps.dtype))
                ms.copy_(m_new)
                vs.copy_(v_new)

        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]), tree_leaves(state["v"])):
            if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
                raise ValueError("params and moments must be contiguous")
            upd(p, g, m, v)
        state["step"] = step
        metrics = {"grad_norm": gnorm, "lr": lr, "step": sf}
        return params, state, metrics
