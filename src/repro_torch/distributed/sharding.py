"""Divisibility-aware sharding rules of the port.

Port of the JAX package's ``distributed/sharding.py``, same names and
decisions, with PyTorch's idiom underneath:

* **Activation constraints** -- :func:`constrain` resolves logical axes
  ("batch", "model", "expert", ...) against the mesh of the active
  :func:`mesh_context` and redistributes a ``DTensor`` to the resolved
  placements. Resolution is divisibility-aware: a logical axis whose
  dimension does not divide the mesh axis falls back to replication
  (smollm's 9 heads on a 16-way model axis). Without an active mesh, or
  on a plain tensor, it returns its input unchanged, so the same model
  code runs the one-device paths bit for bit and the sharded steps.

* **Parameter shardings** -- :func:`param_shardings` maps a params tree
  (by ``/``-joined key path) to :class:`NamedSharding` s by the same
  rules. Stacked-layer params ([L, ...]) keep dim 0 unsharded.

A spec is a :class:`P`, a tuple with one entry per tensor dim: ``None``
(replicated), a mesh axis name, or a tuple of names (major to minor), as
``jax.sharding.PartitionSpec``; :func:`spec_to_placements` turns it
into DTensor placements on a ``DeviceMesh``. A mesh here is a
``DeviceMesh`` (axis names in ``mesh_dim_names``) or any object whose
``shape`` maps axis names to sizes (the spec tests' stand-ins).

Logical axis -> mesh axes:
    batch   -> ("pod", "data")   (whichever exist in the mesh)
    data    -> ("data",)
    model   -> ("model",)        tensor-parallel dimension
    expert  -> ("model",)        MoE expert parallelism
    zero    -> ("data",)         optimizer-state / ZeRO-1 sharding
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

LOGICAL_RULES = {
    "batch": ("pod", "data"),
    "data": ("data",),
    "model": ("model",),
    "expert": ("model",),
    "residual": ("model",),   # d dim of the between-layer carry
    "zero": ("data",),
    None: (),
}

# pure-data-parallel rule set: small models spread the batch over the
# model axis too and keep every tensor dimension unsharded
DP_ALL_RULES = {
    "batch": ("pod", "data", "model"),
    "data": ("data",),
    "model": (),
    "expert": (),
    "residual": (),
    "zero": ("data",),
    None: (),
}

# Megatron-style: residual stream replicated on d between layers; the
# block-internal heads/d_ff stay model-sharded, so each block costs one
# row-parallel all-reduce instead of a resharding cycle
MEGATRON_RULES = dict(LOGICAL_RULES, residual=())

_RULE_SETS = {"default": LOGICAL_RULES, "dp-all": DP_ALL_RULES,
              "megatron": MEGATRON_RULES}
_active_rules = LOGICAL_RULES
_mesh_stack: List = []


class P(tuple):
    """A partition spec: one entry per tensor dim (``None``, an axis
    name or a tuple of names), compared entry by entry like
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class NamedSharding(NamedTuple):
    """A spec on a mesh (``jax.sharding.NamedSharding``'s two fields)."""
    mesh: object
    spec: P

    def placements(self) -> Tuple:
        return spec_to_placements(self.spec, self.mesh)


def set_logical_mode(mode: str) -> None:
    global _active_rules
    _active_rules = _RULE_SETS[mode]


class logical_mode:
    """Context manager: swap the activation-constraint rule set while
    running a variant layout."""

    def __init__(self, mode: str):
        self.mode = mode

    def __enter__(self):
        self.prev = _active_rules
        set_logical_mode(self.mode)

    def __exit__(self, *exc):
        global _active_rules
        _active_rules = self.prev


@contextlib.contextmanager
def mesh_context(mesh) -> Iterator:
    """The mesh :func:`constrain` resolves against inside the block
    (JAX's ``with mesh:``)."""
    _mesh_stack.append(mesh)
    try:
        yield mesh
    finally:
        _mesh_stack.pop()


def current_mesh():
    """The innermost active :func:`mesh_context` mesh, or None."""
    return _mesh_stack[-1] if _mesh_stack else None


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a ``shape``-mapping
    mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def logical_to_spec(
    logical_axes: Sequence[Optional[str]],
    dims: Sequence[int],
    mesh,
) -> P:
    """Resolve logical axes to a spec, dropping any mesh axis that does
    not divide the corresponding dimension."""
    sizes = axis_sizes(mesh)
    spec = []
    used = set()
    for logical, dim in zip(logical_axes, dims):
        mesh_axes = _active_rules.get(logical, ())
        chosen = []
        total = 1
        for ax in mesh_axes:
            if ax not in sizes or ax in used:
                continue
            size = sizes[ax]
            if dim % (total * size) == 0:
                chosen.append(ax)
                total *= size
        for ax in chosen:
            used.add(ax)
        if not chosen:
            spec.append(None)
        elif len(chosen) == 1:
            spec.append(chosen[0])
        else:
            spec.append(tuple(chosen))
    return P(*spec)


def spec_axes(part) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major to minor."""
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def spec_to_placements(spec: Sequence, mesh) -> Tuple:
    """DTensor placements (one per mesh dim) of ``spec`` on a
    ``DeviceMesh``: ``Shard(i)`` on each mesh dim named by entry ``i``,
    ``Replicate()`` on the others and on axes of size 1 (DTensor
    refuses views that drop a size-1 dim it holds sharded). A dim split over several axes is
    split in mesh-dim order (JAX splits in the entry's order; the two
    agree for every spec the rules give except ``_add_zero_axis``'s
    ``(model, data)`` fallback, whose shards have the same size)."""
    names = list(mesh.mesh_dim_names)
    placements = [Replicate()] * len(names)
    for i, part in enumerate(spec):
        for ax in spec_axes(part):
            j = names.index(ax)
            if mesh.size(j) > 1:     # a 1-way split is a replica
                placements[j] = Shard(i)
    return tuple(placements)


def local_shape(shape: Sequence[int], mesh, placements) -> Tuple[int, ...]:
    """One rank's shard shape of a tensor of ``shape`` (the rules shard
    only dims that split evenly)."""
    local = list(shape)
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.size(i)
            if local[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(shape)} does not "
                                 f"split {n} ways")
            local[pl.dim] //= n
    return tuple(local)


def empty_dtensor(shape: Sequence[int], mesh, placements, *,
                  dtype: torch.dtype, device, fill=None) -> DTensor:
    """A DTensor of global ``shape`` whose local shard is allocated on
    ``device`` (uninitialised, or filled with ``fill``); no collective."""
    local = torch.empty(local_shape(shape, mesh, placements), dtype=dtype,
                        device=device)
    if fill is not None:
        local.fill_(fill)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor to the logical axes' placements on the
    active mesh; any other input (no mesh, a plain tensor) unchanged."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(f"{len(logical_axes)} axes for rank-{x.ndim} value")
    placements = spec_to_placements(
        logical_to_spec(logical_axes, x.shape, mesh), mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def _replicate_dims(x: DTensor, dims) -> DTensor:
    """``x`` with every mesh dim that shards one of ``dims`` replicated."""
    placements = [Replicate() if isinstance(pl, Shard) and pl.dim in dims
                  else pl for pl in x.placements]
    if placements == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def _unflatten(x: torch.Tensor, dim: int, sizes) -> torch.Tensor:
    if isinstance(x, DTensor):
        n = 1
        for i, pl in enumerate(x.placements):
            if isinstance(pl, Shard) and pl.dim == dim:
                n *= x.device_mesh.size(i)
        if sizes[0] % n:
            x = _replicate_dims(x, (dim,))
    return x.unflatten(dim, sizes)


def _flatten(x: torch.Tensor, start: int, end: int) -> torch.Tensor:
    if isinstance(x, DTensor):
        x = _replicate_dims(x, range(start + 1, end + 1))
    return x.flatten(start, end)


class _Unflatten(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, sizes):
        ctx.dim, ctx.n = dim, len(sizes)
        return _unflatten(x, dim, sizes)

    @staticmethod
    def backward(ctx, g):
        return _flatten(g, ctx.dim, ctx.dim + ctx.n - 1), None, None


class _Flatten(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, start, end):
        ctx.start, ctx.sizes = start, tuple(x.shape[start:end + 1])
        return _flatten(x, start, end)

    @staticmethod
    def backward(ctx, g):
        return _unflatten(g, ctx.start, ctx.sizes), None, None


def unflatten(x: torch.Tensor, dim: int, sizes: Sequence[int]) -> torch.Tensor:
    """``x.unflatten(dim, sizes)``. DTensor refuses a view that splits a
    sharded dim into pieces ``sizes[0]`` does not divide (9 heads of 64
    over a model axis of 2): on a DTensor that dim is replicated first,
    in the forward and in the backward's inverse view alike."""
    if not isinstance(x, DTensor):
        return x.unflatten(dim, sizes)
    return _Unflatten.apply(x, dim % x.ndim, tuple(sizes))


def flatten(x: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """``x.flatten(start, end)``. DTensor keeps a merged dim's split only
    on its leading part: on a DTensor the dims after ``start`` are
    replicated first (forward and backward, as :func:`unflatten`)."""
    if not isinstance(x, DTensor):
        return x.flatten(start, end)
    return _Flatten.apply(x, start % x.ndim, end % x.ndim)


def whole_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with ``dim`` unsplit: a DTensor sharded on it is gathered
    on it; any other tensor unchanged."""
    if isinstance(x, DTensor):
        x = _replicate_dims(x, (dim % x.ndim,))
    return x


def only_split(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor ``x`` with every mesh dim that does not split ``dim``
    replicated; any other tensor unchanged."""
    if not isinstance(x, DTensor):
        return x
    return _replicate_dims(x, [d for d in range(x.ndim) if d != dim])


def reduced(x: DTensor) -> DTensor:
    """``x`` with every ``Partial`` placement reduced to ``Replicate``."""
    placements = [Replicate() if pl.is_partial() else pl
                  for pl in x.placements]
    if placements == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def pad(x: torch.Tensor, widths: Sequence[int]) -> torch.Tensor:
    """``F.pad(x, widths)`` (constant 0). A DTensor is padded shard by
    shard, its padded dims replicated first: DTensor's pad strategy
    is not the same across versions (one gives a malformed spec)."""
    if not isinstance(x, DTensor):
        return torch.nn.functional.pad(x, widths)
    dims = [x.ndim - 1 - i // 2 for i, w in enumerate(widths) if w]
    x = _replicate_dims(x, dims)
    shape = list(x.shape)
    for i in range(0, len(widths), 2):
        shape[x.ndim - 1 - i // 2] += widths[i] + widths[i + 1]
    return DTensor.from_local(
        torch.nn.functional.pad(x.to_local(), widths), x.device_mesh,
        x.placements, run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def roll(x: torch.Tensor, shift: int, dim: int) -> torch.Tensor:
    """``torch.roll(x, shift, dim)``; on a DTensor (no roll strategy in
    DTensor) the two slices concatenated, the same values."""
    if not isinstance(x, DTensor):
        return torch.roll(x, shift, dims=dim)
    shift %= x.shape[dim]
    if shift == 0:
        return x
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, n - shift, shift),
                      x.narrow(dim, 0, n - shift)], dim=dim)


def _shard_start(x: DTensor, dim: int) -> int:
    """The global index of this rank's first element along ``dim``."""
    split = [i for i, pl in enumerate(x.placements)
             if isinstance(pl, Shard) and pl.dim == dim]
    return _rank_over(x.device_mesh, split) * x.to_local().shape[dim]


def unbind_layers(x: torch.Tensor):
    """``torch.unbind(x, 0)`` of a stacked leaf [L, ...]; a DTensor
    sharded on L (``_add_zero_axis`` may pick it for a small leaf) is
    gathered on L first."""
    if isinstance(x, DTensor):
        x = _replicate_dims(x, (0,))
    return torch.unbind(x, 0)


def layer(x: torch.Tensor, i: int) -> torch.Tensor:
    """``x[i]`` of a stacked leaf, as :func:`unbind_layers`."""
    if isinstance(x, DTensor):
        x = _replicate_dims(x, (0,))
    return x[i]


def write_rows(caches: Sequence[torch.Tensor], slot: torch.Tensor,
               news: Sequence[torch.Tensor]) -> None:
    """``cache[b, slot[b]] = new[b]`` in place for every row ``b`` of each
    cache [B, S, ...] and its ``new`` [B, ...] (``slot`` a scalar or [B]
    of ints; one row index for all the plain caches). On a DTensor cache
    each rank writes its own rows, and only the slots inside its part of
    S: the other rows' values are read and written back unchanged, so no
    index depends on the data."""
    idx = None
    for cache, new in zip(caches, news):
        B = cache.shape[0]
        if not isinstance(cache, DTensor):
            if idx is None:
                idx = (torch.arange(B, device=cache.device), slot.expand(B))
            cache[idx] = new.to(cache.dtype)
        else:
            _write_rows_local(cache, slot, new)


def _write_rows_local(cache: DTensor, slot: torch.Tensor,
                      new: torch.Tensor) -> None:
    B = cache.shape[0]
    mesh = cache.device_mesh
    # new [B, ...] on the cache's placements, S (dim 1) removed
    new_pl = [(Replicate() if pl.dim == 1 else
               Shard(pl.dim - 1 if pl.dim > 1 else 0))
              if isinstance(pl, Shard) else pl for pl in cache.placements]
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    new = new.redistribute(mesh, new_pl).to_local()
    if isinstance(slot, DTensor):
        slot = slot.full_tensor()
    local = cache.to_local()
    b0, s0 = _shard_start(cache, 0), _shard_start(cache, 1)
    nb, ns = local.shape[:2]
    rel = slot.expand(B)[b0:b0 + nb] - s0
    inside = (rel >= 0) & (rel < ns)
    idx = (torch.arange(nb, device=local.device), rel.clamp(0, ns - 1))
    keep = inside.reshape((nb,) + (1,) * (local.ndim - 2))
    local[idx] = torch.where(keep, new.to(local.dtype), local[idx])


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) of per-rank pieces over process groups; the
    gradient of each piece is the gradient of the sum (identity)."""

    @staticmethod
    def forward(ctx, t, groups):
        from torch.distributed import _functional_collectives as funcol
        for g in groups:
            t = funcol.wait_tensor(funcol.all_reduce(t, "sum", g))
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


def _rank_over(mesh, dims) -> int:
    r = 0
    for i in dims:
        r = r * mesh.size(i) + mesh.get_local_rank(i)
    return r


def _vocab_lookup(src: DTensor, index: torch.Tensor, vocab_dim: int,
                  lookup, aligned: bool) -> DTensor:
    """``lookup(local src, local index)`` of a vocab-parallel ``src``
    (its ``vocab_dim`` sharded on some mesh dims, the vocab mesh dims):
    each rank looks up the indices inside its vocab shard, zeros the
    others, and the pieces are summed over the vocab mesh dims. The
    index is replicated over those dims and keeps its own sharding on
    the rest. With ``aligned`` (logits and their labels) ``src`` keeps
    its sharding there too, the index's; otherwise (a table) ``src`` is
    gathered there, and its gradient is a partial sum on a mesh dim that
    splits the index."""
    mesh = src.device_mesh
    if not isinstance(index, DTensor):
        index = DTensor.from_local(index, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    vocab = [i for i, pl in enumerate(src.placements)
             if isinstance(pl, Shard) and pl.dim == vocab_dim]
    idx_pl = [Replicate() if i in vocab else
              (pl if isinstance(pl, Shard) else Replicate())
              for i, pl in enumerate(index.placements)]
    src_pl, src_grad = [], []
    for i, pl in enumerate(src.placements):
        if i in vocab or aligned:
            src_pl.append(pl)
            src_grad.append(pl)
        else:
            src_pl.append(Replicate())
            src_grad.append(Partial() if isinstance(idx_pl[i], Shard)
                            else Replicate())
    groups = [mesh.get_group(i) for i in vocab]

    def local(s, ix):
        width = s.shape[vocab_dim]
        start = _rank_over(mesh, vocab) * width
        ix = ix.long()
        inside = (ix >= start) & (ix < start + width)
        got = lookup(s, (ix - start).clamp(0, width - 1), inside)
        return _SumOver.apply(got, groups) if groups else got

    from torch.distributed.tensor.experimental import local_map
    return local_map(local, out_placements=idx_pl,
                     in_placements=(src_pl, idx_pl),
                     in_grad_placements=(src_grad, idx_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        reduced(src), index)


def take_last(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[..., index]`` per position: ``x.gather(-1, index[..., None])``
    without its last dim. A DTensor ``x`` (vocab-parallel logits) goes
    through :func:`_vocab_lookup`: DTensor's own ``gather`` strategy
    cannot reduce a rank-3 result."""
    if not isinstance(x, DTensor):
        return x.gather(-1, index[..., None]).squeeze(-1)

    def lookup(s, ix, inside):
        got = s.gather(-1, ix[..., None]).squeeze(-1)
        return torch.where(inside, got, torch.zeros_like(got))

    # the index's batch split follows x's
    mesh = x.device_mesh
    if isinstance(index, DTensor):
        index = index.redistribute(mesh, [
            pl if isinstance(pl, Shard) and pl.dim < x.ndim - 1
            else Replicate() for pl in x.placements])
    return _vocab_lookup(x, index, x.ndim - 1, lookup, aligned=True)


def embedding(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; a DTensor ``table`` goes through
    :func:`_vocab_lookup` (DTensor's index and embedding strategies
    differ across versions, and a masked partial sum can be reduced
    only once)."""
    if not isinstance(table, DTensor):
        return table[tokens.long()]

    def lookup(s, ix, inside):
        got = s[ix]
        return torch.where(inside[..., None], got, torch.zeros_like(got))

    return _vocab_lookup(table, tokens, 0, lookup, aligned=False)


def batch_spec(mesh) -> P:
    """Input-batch sharding: batch dim over (pod, data)."""
    axes = [a for a in ("pod", "data") if a in axis_sizes(mesh)]
    return P(tuple(axes) if len(axes) > 1 else (axes[0] if axes else None))


# ---------------------------------------------------------------------------
# Parameter sharding rules, by path regex. First match wins.
# Conventions: stacked layer params have a leading L dim (rule specs are
# for the *trailing* dims; leading dims padded with None).
# ---------------------------------------------------------------------------

# (pattern, logical axes for trailing dims)
PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # embeddings / unembedding: vocab on model
    (r"(embed|lm_head)/table$", ("model", None)),
    # attention projections: wq [d, H, hd] heads on model; wkv [d, Hk, hd]
    # kv-heads on model if divisible else head_dim on model
    (r"attn/wq$", (None, "model", None)),
    (r"attn/wk$", (None, "model", "model_fallback")),
    (r"attn/wv$", (None, "model", "model_fallback")),
    (r"attn/wo$", ("model", None, None)),
    # dense MLP: d_ff on model
    (r"mlp/w(1|3)$", (None, "model")),
    (r"mlp/w2$", ("model", None)),
    # MoE: experts on model when divisible (expert parallelism); router repl.
    (r"moe/w(1|3)$", ("expert", None, "model_fallback")),
    (r"moe/w2$", ("expert", "model_fallback", None)),
    (r"moe/router$", (None, None)),
    # Mamba2 split projections: the d_inner-sized z/x columns on model
    # (head-aligned); the small B/C/dt projections stay replicated
    (r"ssm/w_(z|x)$", (None, "model")),
    (r"ssm/out_proj$", ("model", None)),
    # norms / scalars / conv / everything else: replicated
)


def _rule_for(path: str):
    for pat, axes in PARAM_RULES:
        if re.search(pat, path):
            return axes
    return None


def _spec_for_param(path: str, shape: Tuple[int, ...], mesh) -> P:
    axes = _rule_for(path)
    if axes is None:
        return P()
    # pad leading dims (layer stacking) with None
    n_trail = len(axes)
    if len(shape) < n_trail:
        # rule longer than rank (unstacked edge case): trim from the left
        axes = axes[len(axes) - len(shape):]
        n_trail = len(axes)
    full = [None] * (len(shape) - n_trail) + list(axes)

    sizes = axis_sizes(mesh)
    model_size = sizes.get("model", 1)
    resolved = []
    used = set()
    for logical, dim in zip(full, shape):
        if logical == "model_fallback":
            # only shard if the *primary* model-axis slot upstream failed
            # and this dim divides
            if "model" not in used and dim % model_size == 0 and "model" in sizes:
                resolved.append("model")
                used.add("model")
            else:
                resolved.append(None)
        elif logical in ("model", "expert"):
            if "model" not in used and "model" in sizes and dim % model_size == 0:
                resolved.append("model")
                used.add("model")
            else:
                resolved.append(None)
        else:
            resolved.append(None)
    return P(*resolved)


def tree_paths(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(``/``-joined key path, leaf) of a nested dict, in sorted-key
    order (``jax.tree_util``'s order for dicts)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def tree_map_with_path(fn, tree, prefix: str = ""):
    """A tree like ``tree`` of ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], f"{prefix}{k}/")
                for k in sorted(tree)}
    return fn(prefix[:-1], tree)


def param_shardings(params, mesh, *, zero_axis: Optional[str] = None):
    """(a tree of :class:`NamedSharding` like ``params``, {path:
    sharding}).

    ``zero_axis``: additionally shard the *largest* divisible dim of each
    param over the data axis (ZeRO-3-style fully-sharded params) -- used
    for the huge MoE configs where replicated-over-data params would not
    fit HBM."""
    out = {}
    for path, leaf in tree_paths(params):
        spec = _spec_for_param(path, tuple(leaf.shape), mesh)
        if zero_axis is not None and zero_axis in axis_sizes(mesh):
            spec = _add_zero_axis(spec, tuple(leaf.shape), mesh, zero_axis)
        out[path] = NamedSharding(mesh, spec)
    return tree_map_with_path(lambda path, _: out[path], params), out


def _add_zero_axis(spec: P, shape: Tuple[int, ...], mesh, zero_axis: str) -> P:
    """Add the data axis onto the largest still-unsharded divisible dim."""
    sizes = axis_sizes(mesh)
    zsize = sizes[zero_axis]
    parts = list(spec) + [None] * (len(shape) - len(spec))
    best, best_dim = None, 0
    for i, (p, dim) in enumerate(zip(parts, shape)):
        if p is None and dim % zsize == 0 and dim > best_dim:
            best, best_dim = i, dim
    if best is not None:
        parts[best] = zero_axis
        return P(*parts)
    # fall back: stack onto an already-sharded dim if divisible
    for i, (p, dim) in enumerate(zip(parts, shape)):
        if p is not None and not isinstance(p, tuple):
            shard = dim // sizes.get(p, 1)
            if shard % zsize == 0:
                parts[i] = (p, zero_axis)
                return P(*parts)
    return P(*parts)
