"""Roofline analysis of one step counted on the ``meta`` device.

Port of the JAX package's ``launch/analysis.py``. JAX reads a compiled
step's ``cost_analysis()`` and parses its HLO for collectives; the port
counts one run of the step on meta tensors instead -- on one card with
:func:`cost_analysis`, on a mesh with :func:`mesh_cost_analysis`:

* ``flops``: the matrix products' FLOPs
  (``torch.utils.flop_counter.FlopCounterMode``); elementwise work is
  not counted;
* ``bytes accessed``: every aten op's operand and result bytes (views
  excluded), summed by :class:`ByteCounter` -- an unfused upper bound on
  HBM traffic, as XLA's count is.

The count is the work of the plain form that runs on meta, not of the
kernel that runs on the card: ``ref.flash_attention_chunked`` computes
every 512-key block, masked ones included, and the remat recompute of a
train step is counted as run. The collective term is 0 on one card
(``coll={"total": 0}``).

On a mesh the step runs on meta DTensors over the fake process group
(``mesh.open_fake_group``). :class:`MeshCounter` lets DTensor desugar
each op into its local ops and collectives (it returns ``NotImplemented``
for a DTensor op, as ``CommDebugMode`` does) and counts those, so FLOPs
and bytes are one device's, of its local shards (DTensor's own shape
propagation, which runs ops on fake tensors of the global shapes, is not
counted). Every
``_c10d_functional`` collective is recorded with its kind and result
bytes (JAX's convention: the result of each collective, per device);
:func:`parse_collective_bytes` and :func:`count_collective_ops` sum the
record under JAX's keys.

Roofline terms (seconds), per the constants in ``mesh.HW``:

    compute    = flops / peak_flops
    memory     = bytes / hbm_bw
    collective = coll_bytes / ici_bw
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from ..models.config import ModelConfig
from .mesh import HW

# ops that allocate without reading or writing their result
_NO_ACCESS = {torch.ops.aten.empty.memory_format,
              torch.ops.aten.empty_strided.default,
              torch.ops.aten.empty_like.default}


def tensor_bytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree`` (numel x element size)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def local_tensor_bytes(tree) -> int:
    """:func:`tensor_bytes` of one device: a DTensor leaf counts its
    local shard."""
    return sum(t.to_local().numel() * t.element_size()
               if isinstance(t, DTensor) else t.numel() * t.element_size()
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


class ByteCounter(TorchDispatchMode):
    """Sums each aten op's operand and result bytes into ``bytes``
    (views and bare allocations move nothing and are skipped)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func not in _NO_ACCESS:
            self.bytes += tensor_bytes((args, kwargs, out))
        return out


def cost_analysis(fn: Callable, *args) -> Tuple[Dict[str, float], object]:
    """(``{"flops", "bytes accessed"}``, the result) of one call
    ``fn(*args)``, counted as the module docstring says. Run it on meta
    tensors to count a step of any size without a device."""
    with FlopCounterMode(display=False) as flops, ByteCounter() as nbytes:
        out = fn(*args)
    return {"flops": float(flops.get_total_flops()),
            "bytes accessed": float(nbytes.bytes)}, out


_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
                "all-to-all", "collective-permute")
# collective op names by JAX kind: the functional collectives
# (``_c10d_functional``, ``_c10d_functional_autograd``) and DTensor's own
# shard-to-shard all-to-all (``_dtensor.shard_dim_alltoall``, whose inner
# collective a mode does not see)
_KIND_OF = (("all_reduce", "all-reduce"), ("all_gather", "all-gather"),
            ("reduce_scatter", "reduce-scatter"),
            ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
            ("permute", "collective-permute"))


def _collective_kind(func) -> str:
    """The JAX kind of a collective op, or "" for other ops."""
    ns = getattr(func, "namespace", "")
    if not (ns.startswith("_c10d_functional") or ns == "_dtensor"):
        return ""
    name = func._opname
    for key, kind in _KIND_OF:
        if key in name:
            return kind
    return ""


class MeshCounter(ByteCounter):
    """One device's counts of a run on DTensors: ``bytes`` (operand and
    result bytes of the local ops, as :class:`ByteCounter`), ``flops``
    (the matrix products' FLOPs of the local ops, ``FlopCounterMode``'s
    formulas) and ``collectives``, a list of (kind, result bytes) of
    every collective."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.collectives = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # DTensor desugars; its ops come back
        kwargs = kwargs or {}
        if any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)   # DTensor's global-shape propagation
        out = super().__torch_dispatch__(func, types, args, kwargs)
        packet = getattr(func, "_overloadpacket", None)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        kind = _collective_kind(func)
        if kind:
            self.collectives.append((kind, tensor_bytes(out)))
        return out


def mesh_cost_analysis(fn: Callable, *args
                       ) -> Tuple[Dict[str, float], list, object]:
    """(``{"flops", "bytes accessed"}`` per device, the collective
    record, the result) of one call ``fn(*args)`` on DTensors, counted
    by :class:`MeshCounter`."""
    with MeshCounter() as counter:
        out = fn(*args)
    return ({"flops": float(counter.flops),
             "bytes accessed": float(counter.bytes)},
            counter.collectives, out)


def parse_collective_bytes(collectives) -> Dict[str, int]:
    """Result bytes per device of every collective in a
    :class:`MeshCounter` record, by JAX kind, and their ``total``."""
    out: Dict[str, int] = {c: 0 for c in _COLLECTIVES}
    for kind, nbytes in collectives:
        out[kind] += nbytes
    out["total"] = sum(out[c] for c in _COLLECTIVES)
    return out


def count_collective_ops(collectives) -> Dict[str, int]:
    """The number of collectives of each JAX kind in a record."""
    out: Dict[str, int] = {c: 0 for c in _COLLECTIVES}
    for kind, _ in collectives:
        out[kind] += 1
    return out


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float,
                   io_bytes_per_dev: float = 0.0) -> Dict[str, float]:
    """``bytes_per_dev`` is the counted 'bytes accessed', an UPPER bound
    on HBM traffic (no op is fused). ``io_bytes_per_dev`` (argument +
    output sizes) is the matching LOWER bound: every input and output
    crosses HBM at least once. The memory term uses the upper bound;
    both are recorded."""
    compute = flops_per_dev / HW["peak_flops_bf16"]
    memory = bytes_per_dev / HW["hbm_bw"]
    memory_io = io_bytes_per_dev / HW["hbm_bw"]
    collective = coll_bytes_per_dev / HW["ici_bw"]
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = dom.replace("_s", "")
    terms["memory_io_lower_s"] = memory_io
    total = max(compute, memory, collective)
    terms["step_time_lower_bound_s"] = total
    terms["roofline_fraction"] = compute / total if total > 0 else 0.0
    # the fraction if fusion removed all intermediate traffic
    best = max(compute, memory_io, collective)
    terms["roofline_fraction_optimistic"] = (compute / best
                                             if best > 0 else 0.0)
    return terms


def model_flops(cfg: ModelConfig, kind: str, tokens: int) -> float:
    """6·N·D (train) / 2·N·D (inference) on active params."""
    n_active = cfg.active_param_count()
    per_token = 6.0 * n_active if kind == "train" else 2.0 * n_active
    return per_token * tokens


def summarize_cell(cfg: ModelConfig, kind: str, n_tokens: int,
                   n_chips: int, cost: dict, coll: Dict[str, int],
                   io_bytes: float = 0.0) -> Dict[str, float]:
    flops = float(cost.get("flops", 0.0))
    b_out = float(cost.get("bytes accessed", 0.0))
    terms = roofline_terms(flops, b_out, float(coll.get("total", 0)),
                           io_bytes)
    mf = model_flops(cfg, kind, n_tokens)
    total = flops * n_chips
    terms.update({
        "hlo_flops_per_dev": flops,
        "hlo_bytes_per_dev": b_out,
        "coll_bytes_per_dev": float(coll.get("total", 0)),
        "model_flops_total": mf,
        "useful_flops_ratio": (mf / total) if total > 0 else 0.0,
    })
    return terms
