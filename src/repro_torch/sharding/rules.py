"""Logical-axis → mesh-axis sharding rules (counterpart of
`repro.sharding.rules`).

Every parameter and cache leaf carries a tuple of logical axis names
(`models.common.ParamFactory`, the models' `*_axes` functions).
`logical_to_pspec` maps them to a partition spec under a rule table,
enforcing (a) no mesh axis used twice in one spec and (b) divisibility of
the dim by the mesh-axis extent (replication otherwise: kv_heads = 8 on a
16-way model axis stays replicated and the KV cache shards over `seq`
instead). A spec is a plain tuple, one entry per leading tensor dim: None,
a mesh axis name, or a tuple of names (the dim split over their product,
the first the major), trailing Nones dropped, as `PartitionSpec` holds it.

A mesh is given by its extents by name: a `DeviceMesh` (names from
`mesh_dim_names`) or a plain {name: extent} mapping (the dry run's).
`tree_shardings` gives each leaf a `NamedSharding`: its spec and its DTensor
placements (Shard(dim) or Replicate() per mesh dim, in the mesh's order),
and the arithmetic of which block of the leaf a mesh coordinate holds
(`shard_slices`), which the mesh train step and decode use on plain
tensors (sharding/lm.py).

Kept for parity with the reference's API, used by no path of the port
(the mesh step computes on plain tensors, not DTensors; a test holds
them): `NamedSharding.placements`, and `activate`/`constrain`,
which redistribute a DTensor activation to its rules' placements.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable, Mapping

@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> mesh axis (or tuple of mesh axes, or None)."""
    mapping: dict[str, Any]

    def get(self, name: str):
        return self.mapping.get(name)


def default_rules(multi_pod: bool = False, fsdp: bool = True,
                  attn_dp: bool = False, moe_ep: bool = True) -> ShardingRules:
    """The reference's table. attn_dp: batch-parallel attention over
    (data × model), for archs whose q_heads do not divide the model axis;
    moe_ep: the combine-side batch axis takes `model` when the experts are
    sharded over it."""
    batch = ("pod", "data") if multi_pod else ("data",)
    attn_batch = batch + ("model",) if attn_dp else batch
    moe_batch = batch + ("model",) if moe_ep else batch
    return ShardingRules({
        # data / FSDP axes
        "batch": batch,
        "attn_batch": attn_batch,   # attention activations only
        "moe_batch": moe_batch,
        "embed": "data" if fsdp else None,
        # tensor/expert parallel axes
        "vocab": "model",
        "q_heads": None if attn_dp else "model",
        "kv_heads": None if attn_dp else "model",
        "mlp": "model",
        "experts": "model",
        "head": None,        # never shard d_head (contraction dim of scores)
        "seq": "model",      # KV-cache sequence sharding (decode SP)
        # replicated
        "layers": None, "conv": None, "ssm_state": None, "ssm_in": None,
        "ssm_rank": None, "codebooks": None, "vision_embed": None,
        "embed2": None,
    })


def mesh_extents(mesh) -> dict[str, int]:
    """{axis name: extent} of a DeviceMesh or of a plain mapping."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise ValueError("a DeviceMesh without mesh_dim_names has no axes "
                         "by name")
    return dict(zip(names, (int(s) for s in mesh.shape)))


def logical_to_pspec(axes: tuple, shape: tuple[int, ...],
                     rules: ShardingRules, mesh) -> tuple:
    ext = mesh_extents(mesh)
    used: set[str] = set()
    out: list = []
    for dim, name in zip(shape, axes):
        mesh_axes = rules.get(name) if name else None
        if mesh_axes is None:
            out.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        chosen = []
        extent = 1
        for ax in mesh_axes:
            if ax in used or ax not in ext:
                continue
            if dim % (extent * ext[ax]) == 0:
                chosen.append(ax)
                extent *= ext[ax]
        if chosen:
            used.update(chosen)
            out.append(tuple(chosen) if len(chosen) > 1 else chosen[0])
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def is_axes_leaf(x) -> bool:
    """A logical-axes annotation: non-empty plain tuple of str/None
    (NamedTuple containers like KVCache are NOT leaves)."""
    return (isinstance(x, tuple) and not hasattr(x, "_fields") and len(x) > 0
            and all(isinstance(e, (str, type(None))) for e in x))


def _children(node) -> list[tuple[str, Any]]:
    if isinstance(node, dict):
        return [(str(k), k) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, f) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(str(i), i) for i in range(len(node))]
    raise TypeError(f"not an axes container: {type(node).__name__}")


def _get(tree, key):
    return getattr(tree, key) if isinstance(key, str) and \
        hasattr(tree, "_fields") else tree[key]


def map_axes(fn: Callable, axes_tree, *trees):
    """A tree of the axes tree's structure whose leaves are fn(axes,
    leaf of each of `trees` at the same path). The axes tree decides what
    a leaf is (`is_axes_leaf`); `trees` may hold anything there (tensors,
    shapes, specs)."""
    if is_axes_leaf(axes_tree):
        return fn(axes_tree, *trees)
    kids = _children(axes_tree)
    mapped = [map_axes(fn, _get(axes_tree, k), *(_get(t, k) for t in trees))
              for _, k in kids]
    if isinstance(axes_tree, dict):
        return {k: v for (_, k), v in zip(kids, mapped)}
    if hasattr(axes_tree, "_fields"):
        return type(axes_tree)(*mapped)
    return type(axes_tree)(mapped)


def leaves_with_paths(axes_tree, *trees) -> list[tuple]:
    """[(path, axes, leaf of each of `trees`)] in the reference's leaf
    order; paths as `checkpoint.ckpt.flatten_with_paths` names them."""
    if is_axes_leaf(axes_tree):
        return [("", axes_tree, *trees)]
    out = []
    for name, k in _children(axes_tree):
        for path, *rest in leaves_with_paths(_get(axes_tree, k),
                                             *(_get(t, k) for t in trees)):
            out.append((name + "/" + path if path else name, *rest))
    return out


def spec_axes(spec: tuple) -> list[str]:
    """The mesh axes a spec uses, in its order."""
    out = []
    for entry in spec:
        if entry is not None:
            out.extend((entry,) if isinstance(entry, str) else entry)
    return out


def shard_counts(spec: tuple, mesh) -> list[int]:
    """How many blocks each spec'd dim is split into."""
    ext = mesh_extents(mesh)
    return [1 if e is None else math.prod(
        ext[a] for a in ((e,) if isinstance(e, str) else e)) for e in spec]


def shard_index(spec: tuple, mesh, coords: Mapping[str, int]) -> tuple:
    """The block index along each spec'd dim that the mesh coordinate
    `coords` holds: row-major over the dim's axes, the first the major
    (the reference's order)."""
    ext = mesh_extents(mesh)
    out = []
    for entry in spec:
        idx = 0
        for ax in (() if entry is None else
                   (entry,) if isinstance(entry, str) else entry):
            idx = idx * ext[ax] + coords[ax]
        out.append(idx)
    return tuple(out)


def shard_slices(spec: tuple, shape, mesh, coords) -> tuple:
    """The slices of a leaf of `shape` that `coords` holds."""
    out = []
    for n, idx, dim in zip(shard_counts(spec, mesh),
                           shard_index(spec, mesh, coords), shape):
        size = dim // n
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


def shard_shape(spec: tuple, shape, mesh) -> tuple:
    counts = shard_counts(spec, mesh)
    return tuple(d // counts[i] if i < len(counts) else d
                 for i, d in enumerate(shape))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement on a mesh: its spec over the mesh's named axes
    and the DTensor placements that say the same, one per mesh dim."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        names = list(mesh_extents(self.mesh))
        out: list = [Replicate()] * len(names)
        for dim, entry in enumerate(self.spec):
            axes = (() if entry is None else
                    (entry,) if isinstance(entry, str) else entry)
            order = [names.index(a) for a in axes]
            if order != sorted(order):
                # DTensor splits a dim over mesh dims in the mesh's order
                raise ValueError(f"spec {self.spec}: axes {axes} are not "
                                 f"in the mesh's order {names}")
            for i in order:
                out[i] = Shard(dim)
        return tuple(out)

    def local(self, full):
        """This rank's block of the full tensor `full` (a copy), the rank's
        coordinates those of the DeviceMesh."""
        names = list(mesh_extents(self.mesh))
        coords = dict(zip(names, self.mesh.get_coordinate()))
        return full[shard_slices(self.spec, tuple(full.shape), self.mesh,
                                 coords)].clone()


def tree_shardings(mesh, rules: ShardingRules, axes_tree, shape_tree):
    """(axes tree, tree of tensors or shapes) -> NamedSharding tree."""
    return map_axes(lambda a, x: NamedSharding(
        mesh, logical_to_pspec(a, tuple(_shape(x)), rules, mesh)),
        axes_tree, shape_tree)


def tree_pspecs(mesh, rules: ShardingRules, axes_tree, shape_tree):
    return map_axes(lambda a, x: logical_to_pspec(a, tuple(_shape(x)),
                                                  rules, mesh),
                    axes_tree, shape_tree)


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def placed_bytes(mesh, spec: tuple, shape, itemsize: int) -> int:
    """Bytes one rank holds of a leaf placed by `spec`."""
    return math.prod(shard_shape(spec, shape, mesh)) * itemsize


# ------------------------------------------------------ activation context

_CTX = threading.local()


@contextlib.contextmanager
def activate(mesh, rules: ShardingRules):
    """Enable `constrain` inside model code."""
    prev = getattr(_CTX, "v", None)
    _CTX.v = (mesh, rules)
    try:
        yield
    finally:
        _CTX.v = prev


def constrain(x, logical_axes: tuple):
    """Annotate an activation with logical axes: a DTensor is
    redistributed to the placements the rules give it; a no-op outside
    `activate` and on a plain tensor (the mesh step computes on plain
    tensors)."""
    ctx = getattr(_CTX, "v", None)
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    spec = logical_to_pspec(logical_axes, tuple(x.shape), rules, mesh)
    return x.redistribute(mesh, NamedSharding(mesh, spec).placements)


def batch_pspec(rules: ShardingRules, ndim: int) -> tuple:
    b = rules.get("batch")
    return (b, *([None] * (ndim - 1)))
