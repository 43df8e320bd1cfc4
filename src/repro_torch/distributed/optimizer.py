"""AdamW for the port's trainer, ZeRO-1 sharding of its state and the
int8 error-feedback all-reduce.

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
the whole leaf.

On a mesh the params are DTensors (``launch/cell_shardings.py``
places them). :meth:`Optimizer.state_shardings` puts the float32
moments on the data axis as well (ZeRO-1: each data rank owns 1/DP of
the state), and :meth:`Optimizer.update` works on local shards: each
gradient is redistributed to its moments' placement (a reduce-scatter
over data, an all-reduce where the moments are replicated), the local
piece of the param is updated, and a param whose placement differs
from its moments' is gathered back to its own (an all-gather).
:func:`global_norm` sums each rank's local squares, each shard counted
once, and all-reduces the sum.

:func:`compressed_psum` is the int8 error-feedback data-parallel
all-reduce for trainers that hold whole params on every rank
(:func:`make_compressed_dp_grad_fn`): quantise to int8 with a
per-tensor scale, all-reduce the dequantised values, divide by the
group size, and carry the quantisation residual into the next step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate

from .sharding import NamedSharding, P, empty_dtensor, param_shardings

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


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    return sum(torch.sum(torch.square(s.float())) for (s,) in _slices(x))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32. DTensor
    leaves (no ``Partial`` placement) add their local sums, each divided
    by the number of ranks holding the same shard, and one all-reduce
    over their mesh sums those; the result is a plain tensor."""
    total = None
    dtensors = []
    for x in tree_leaves(tree):
        if isinstance(x, DTensor):
            dtensors.append(x)
            continue
        sq = _sum_squares(x)
        total = sq if total is None else total + sq
    if dtensors:
        mesh = dtensors[0].device_mesh
        local = None
        for x in dtensors:
            if any(isinstance(pl, Partial) for pl in x.placements):
                raise ValueError("global_norm needs reduced DTensors")
            copies = 1          # ranks holding this rank's shard
            for i, pl in enumerate(x.placements):
                if isinstance(pl, Replicate):
                    copies *= mesh.size(i)
            sq = _sum_squares(x.to_local()) / copies
            local = sq if local is None else local + sq
        summed = DTensor.from_local(local, mesh, [Partial()] * mesh.ndim,
                                    run_check=False).full_tensor()
        total = summed if total is None else total + summed
    return torch.sqrt(total)


class Optimizer:
    """AdamW. State: ``{"m", "v"}`` float32 trees like the params and
    ``"step"``, a 0-dim int32 tensor on the params' device."""

    def __init__(self, config: Optional[OptimizerConfig] = None):
        self.config = config or OptimizerConfig()

    def init(self, params, shardings: Optional[Dict] = None) -> Dict:
        """Zero moments like ``params`` and step 0. DTensor params give
        DTensor moments on ``shardings["m"]`` / ``["v"]`` (from
        :meth:`state_shardings`), else on the params' placements."""
        def zeros(p, sh=None):
            if isinstance(p, DTensor):
                return empty_dtensor(
                    p.shape, p.device_mesh,
                    sh.placements() if sh is not None else p.placements,
                    dtype=torch.float32, device=p.to_local().device, fill=0.0)
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        first = tree_leaves(params)[0]
        step_device = first.to_local().device if isinstance(first, DTensor) \
            else first.device
        if shardings is None:
            m, v = tree_map(zeros, params), tree_map(zeros, params)
        else:
            m = tree_map(zeros, params, shardings["m"])
            v = tree_map(zeros, params, shardings["v"])
        return {"m": m, "v": v,
                "step": torch.zeros((), dtype=torch.int32, device=step_device)}

    def state_shardings(self, params, mesh, *, zero_axis: str = "data"):
        """ZeRO-1: moments sharded over the data axis (on top of any
        model-axis sharding the param rule gives)."""
        m_shard, _ = param_shardings(params, mesh, zero_axis=zero_axis)
        return {"m": m_shard, "v": tree_map(lambda sh: sh, m_shard),
                "step": NamedSharding(mesh, P())}

    @torch.no_grad()
    def update(self, params, grads, state) -> Tuple[Dict, Dict, Dict]:
        """One AdamW step, in place on ``params`` and ``state``'s
        moments; returns (params, state, metrics) with the same trees."""
        cfg = self.config
        step = state["step"] + 1
        lr = lr_schedule(cfg, step)
        # on a mesh: each gradient on its moments' placement (reduced)
        grads = tree_map(
            lambda g, m: g.redistribute(m.device_mesh, m.placements)
            if isinstance(g, DTensor) else g, grads, state["m"])
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
            if isinstance(p, DTensor):
                _update_local(upd, p, g, m, v)
                continue
            if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
                raise ValueError("params and moments must be contiguous")
            upd(p, g, m, v)
        state["step"] = step
        metrics = {"grad_norm": gnorm, "lr": lr, "step": sf}
        return params, state, metrics


def _update_local(upd, p: DTensor, g: DTensor, m: DTensor, v: DTensor):
    """``upd`` on the local shards of a DTensor leaf (``g`` already on
    ``m``'s placement). A param on another placement than its moments is
    updated in its moments' layout and gathered back into its own."""
    mesh, target = m.device_mesh, tuple(m.placements)
    same = tuple(p.placements) == target
    # redistributing a param onto finer shards slices it locally
    p_work = p.to_local() if same else \
        p.redistribute(mesh, target).to_local().contiguous()
    parts = (p_work, g.to_local().contiguous(), m.to_local(), v.to_local())
    if not all(t.is_contiguous() for t in parts):
        raise ValueError("local shards must be contiguous")
    upd(*parts)
    if not same:
        new = DTensor.from_local(p_work, mesh, target, run_check=False,
                                 shape=p.shape, stride=p.stride())
        p.to_local().copy_(new.redistribute(mesh, p.placements).to_local())


# ---------------------------------------------------------------------------
# int8 error-feedback gradient compression (data-parallel trainers that
# hold whole params on every rank)
# ---------------------------------------------------------------------------

def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation. Returns (q, scale)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(g: torch.Tensor, err: torch.Tensor, group=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 all-reduce of one gradient over ``group``
    (a process group, default the world): quantise (g + carried error),
    all-reduce the dequantised payload, and return (the mean over the
    group's ranks, the new error). The residual carries what the
    quantiser dropped into the next step, which keeps the sum over steps
    unbiased (error-feedback SGD). The sum runs in float32, as JAX's
    ``psum`` of the payload; the algorithm's wire format is the int8
    values plus one scale per rank."""
    gf = g.float() + err
    q, scale = quantize_int8(gf)
    new_err = gf - dequantize_int8(q, scale)
    q_sum = q.float() * scale
    dist.all_reduce(q_sum, group=group)
    return q_sum / dist.get_world_size(group), new_err


def make_compressed_dp_grad_fn(loss_fn: Callable, group=None) -> Callable:
    """``grad_fn(params, batch, err_tree) -> (grads, new err_tree)``:
    each rank's gradients of ``loss_fn(params, batch)`` (a scalar) on
    its own batch, reduced by :func:`compressed_psum` leaf by leaf, in
    the params' dtypes."""

    def grad_fn(params, batch, err_tree):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        grads = torch.autograd.grad(loss_fn(params, batch), leaves,
                                    allow_unused=True, materialize_grads=True)
        out_g, out_e = [], []
        for g, e in zip(grads, tree_leaves(err_tree)):
            rg, ne = compressed_psum(g, e, group)
            out_g.append(rg.to(g.dtype))
            out_e.append(ne)
        it_g, it_e = iter(out_g), iter(out_e)
        return (tree_map(lambda _: next(it_g), params),
                tree_map(lambda _: next(it_e), params))

    return grad_fn
