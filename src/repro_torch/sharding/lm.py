"""The LM on a (data, model) mesh of ranks over torch.distributed: each
rank stores only the blocks of the parameters, optimizer moments, int8
scales and caches that the sharding rules give it (sharding/rules.py), and
gathers a layer's weights where the layer runs (the FSDP pattern), so the
model code of `models/` runs unchanged on plain tensors.

  * `MeshComm` — this rank's coordinates on a DeviceMesh and the
    collectives the path needs, staged through host buffers (gloo carries
    CPU tensors; on the card a tensor is copied to the host, moved, and
    copied back, in plain view). Every sum over ranks is formed in rank
    order 0..N-1, in float32, so all ranks hold the same bits.
  * `DryComm` — one rank's view of a mesh shape with no process group:
    MeshComm's interface on "meta" tensors, counting the bytes MeshComm
    would send (the dry run's cost count, launch/roofline.py).
  * `ShardedLM` — a DecoderLM's parameters placed on the mesh: one local
    block per leaf, `param_tree()` in the reference's tree.
  * `train_step` — the mesh train step. The global batch is split over all
    N ranks by rows (activations are not sharded over `model`: the model
    axis' ranks take rows of their own; a batch smaller than the world
    gives each row to world / rows ranks, each carrying its share of the
    mean). Each repeat of the pattern gathers
    its weights inside the checkpointed body (`_Gather`), whose backward
    sums the full gradients over the ranks (one all-to-all) and keeps the
    rank's own block, so every gradient comes back in its leaf's
    placement. The loss and the token counts sum over the ranks (the loss
    is the global mean), the MoE's token means too (`common.split_batch`).
    AdamW then runs on each rank's blocks; the grad norm sums each distinct
    block once, and an int8 moment whose last axis is sharded is updated
    on its gathered rows (the block absmax scales span the rows; they are
    kept whole, as the rules replicate them).
  * `serve_step` — prefill and decode against sharded caches, holding
    what the train step holds: the rank's blocks and the one layer that
    runs. A rank computes the batch rows of its cache block (its data
    coordinate). `model.serve_forward` reads the top-level leaves gathered
    once a call and each repeat's weights gathered just before its layer
    runs and freed after it (`_GatheringWeights` without autograd); each
    layer's cache for those rows is gathered just before the layer from
    the ranks that hold them (its `model` group) and the rank's own block
    written back just after, through its local tensor (`_RowCaches`).
    Prefill returns the rank's own rows of the logits (`batch_rows`;
    `gather_rows` gathers them over the batch's axis for a caller that
    wants the whole batch); decode the whole batch's next tokens, gathered
    over that axis alone.
  * `gather_tree` / `place_tree` — a state's blocks to full arrays and
    back (checkpoints hold full arrays: the files carry no topology).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import SEP, flatten_with_paths, map_leaves
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models import model as model_lib
from repro_torch.obs.clock import now_s
from repro_torch.sharding import rules as rules_lib
from repro_torch.train import optim as optim_lib


class MeshComm:
    """This rank on a DeviceMesh that spans the default process group, and
    host-staged collectives over that world. `seconds` and `bytes` count
    each collective's host time (staging included) and the bytes this rank
    sent into it."""

    def __init__(self, mesh):
        import torch.distributed as dist
        self.mesh = mesh
        self.extents = rules_lib.mesh_extents(mesh)
        self.names = list(self.extents)
        grid = np.asarray(mesh.mesh.cpu())
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        if grid.size != self.world:
            raise ValueError(f"the mesh holds {grid.size} ranks; the world "
                             f"{self.world}")
        self.coords_of = _coords_of(grid, self.names)
        self.coords = self.coords_of[self.rank]
        self.seconds = {"all_gather": 0.0, "all_to_all": 0.0}
        self.bytes = {"all_gather": 0, "all_to_all": 0}

    # -- collectives, through host buffers -------------------------------
    def peers(self, over: str | None = None) -> list[int]:
        """The ranks of this rank's group along the mesh axis `over` (the
        ranks whose coordinates differ from its own on that axis only), in
        their order in the group; None: the whole world."""
        if over is None:
            return list(range(self.world))
        import torch.distributed as dist
        return dist.get_process_group_ranks(self.mesh.get_group(over))

    def all_gather(self, t: torch.Tensor,
                   over: str | None = None) -> list[torch.Tensor]:
        """The `t` (equal shapes) of every rank of `peers(over)`, in that
        order, on t's device."""
        import torch.distributed as dist
        t0 = now_s()
        host = _bytes(t).cpu()
        group = None if over is None else self.mesh.get_group(over)
        out = [torch.empty_like(host) for _ in self.peers(over)]
        dist.all_gather(out, host, group=group)
        got = [_unbytes(o, t.dtype, t.shape).to(t.device) for o in out]
        self.seconds["all_gather"] += now_s() - t0
        self.bytes["all_gather"] += host.numel()
        return got

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """send [N, n] float32, row j for rank j -> [N, n], row i from rank
        i."""
        import torch.distributed as dist
        t0 = now_s()
        host = send.detach().float().cpu().contiguous()
        out = torch.empty_like(host)
        dist.all_to_all_single(out, host)
        got = out.to(send.device)
        self.seconds["all_to_all"] += now_s() - t0
        self.bytes["all_to_all"] += host.numel() * 4
        return got

    def sum_in_order(self, t: torch.Tensor) -> torch.Tensor:
        """Σ over ranks of t, float32, in rank order (the same bits on
        every rank)."""
        parts = self.all_gather(t.float())
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    def barrier(self) -> None:
        import torch.distributed as dist
        dist.barrier()

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """`sum_in_order`, differentiable (the backward sums the ranks'
        cotangents): `common.split_batch`'s hook."""
        return _AllSum.apply(self, x)

    # -- blocks ----------------------------------------------------------
    def index_of(self, spec: tuple, rank: int) -> tuple:
        return rules_lib.shard_index(spec, self.extents, self.coords_of[rank])

    def slices(self, spec: tuple, shape, rank: int | None = None) -> tuple:
        coords = self.coords if rank is None else self.coords_of[rank]
        return rules_lib.shard_slices(spec, tuple(shape), self.extents,
                                      coords)

    def holders(self, spec: tuple) -> list[int]:
        """One rank for each distinct block of a leaf placed by `spec`
        (the first in rank order)."""
        seen, out = set(), []
        for r in range(self.world):
            key = self.index_of(spec, r)
            if key not in seen:
                seen.add(key)
                out.append(r)
        return out


class DryComm(MeshComm):
    """One rank's view of a mesh of `extents` ({axis: extent}) with no
    process group: MeshComm's interface, for a dry count of the mesh's
    steps on "meta" (launch/roofline.py `step_flops`). Its collectives
    return tensors of the shapes MeshComm's return, on the input's device
    and with no data, and count `bytes` as MeshComm counts them (each also
    in `detail`: {"op", "bytes", "ranks"}). Ranks are numbered row-major
    over the extents, as `init_device_mesh` numbers them."""

    def __init__(self, extents, rank: int = 0):
        self.mesh = rules_lib.mesh_extents(extents)
        self.extents = dict(self.mesh)
        self.names = list(self.extents)
        grid = np.arange(math.prod(self.extents.values())).reshape(
            tuple(self.extents.values()))
        self.world = grid.size
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} is not in a world of "
                             f"{self.world}")
        self.rank = rank
        self.coords_of = _coords_of(grid, self.names)
        self.coords = self.coords_of[rank]
        self.seconds = {"all_gather": 0.0, "all_to_all": 0.0}
        self.bytes = {"all_gather": 0, "all_to_all": 0}
        self.detail: list[dict] = []

    def peers(self, over: str | None = None) -> list[int]:
        if over is None:
            return list(range(self.world))
        return [r for r, c in enumerate(self.coords_of)
                if all(c[a] == self.coords[a] for a in self.names
                       if a != over)]

    def _count(self, op: str, nbytes: int, ranks: int) -> None:
        self.bytes[op] += nbytes
        self.detail.append({"op": op, "bytes": nbytes, "ranks": ranks})

    def all_gather(self, t: torch.Tensor,
                   over: str | None = None) -> list[torch.Tensor]:
        host = _bytes(t)
        peers = self.peers(over)
        self._count("all_gather", host.numel(), len(peers))
        return [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                for _ in peers]

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        host = send.detach().float().contiguous()
        self._count("all_to_all", host.numel() * 4, self.world)
        return torch.empty(host.shape, dtype=torch.float32,
                           device=send.device)

    def barrier(self) -> None:
        pass


def _coords_of(grid: np.ndarray, names: list) -> list[dict]:
    """Each rank's coordinates {axis: index} on a grid of ranks."""
    out = [None] * grid.size
    for idx, r in np.ndenumerate(grid):
        out[int(r)] = dict(zip(names, map(int, idx)))
    return out


def _unbytes(b: torch.Tensor, dtype, shape) -> torch.Tensor:
    # a copy: a slice of a packed buffer need not sit at dtype alignment
    return b.clone().view(dtype).reshape(shape)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """t's bytes, a flat uint8 view (of a contiguous copy) on its device."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x):
        ctx.comm, ctx.dtype = comm, x.dtype
        return comm.sum_in_order(x).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm.sum_in_order(g).to(ctx.dtype)


def gather_full(comm: MeshComm, locals_: list, specs: list,
                dims: set | None = None,
                over: str | None = None) -> list[torch.Tensor]:
    """The full leaves (or, with `dims`, the leaves whole along those
    tensor dims only, the rank's own block along the others) of the
    rank-local blocks `locals_` placed by `specs`: one all-gather for the
    list (the blocks assembled on their device), among `comm.peers(over)`
    (the whole world by default; a group along one mesh axis must hold
    every block that is wanted). A leaf whose spec uses no mesh axis is
    its local block."""
    moving = [i for i, s in enumerate(specs) if rules_lib.spec_axes(s)]
    out = [t if i in moving else t.detach().clone()
           for i, t in enumerate(locals_)]
    if not moving:
        return out
    pieces = comm.all_gather(torch.cat([_bytes(locals_[i])
                                        for i in moving]), over)
    ranks = comm.peers(over)
    offset = 0
    for i in moving:
        loc, spec = locals_[i], specs[i]
        n = loc.numel() * loc.element_size()
        dd = set(range(len(spec))) if dims is None else dims
        mine = comm.index_of(spec, comm.rank)
        counts = rules_lib.shard_counts(spec, comm.extents)
        shape = [s * counts[d] if d < len(spec) and d in dd else s
                 for d, s in enumerate(loc.shape)]
        full = torch.empty(shape, dtype=loc.dtype, device=loc.device)
        seen = set()
        for r, piece in zip(ranks, pieces):
            idx = comm.index_of(spec, r)
            if any(idx[d] != mine[d] for d in range(len(spec))
                   if d not in dd):
                continue
            key = tuple(idx[d] for d in range(len(spec)) if d in dd)
            if key in seen:
                continue
            seen.add(key)
            sl = tuple(slice(idx[d] * s, (idx[d] + 1) * s)
                       if d < len(spec) and d in dd else slice(None)
                       for d, s in enumerate(loc.shape))
            full[sl] = _unbytes(piece[offset:offset + n], loc.dtype,
                                loc.shape)
        if len(seen) != math.prod(counts[d] for d in dd if d < len(spec)):
            raise ValueError(f"spec {spec}: the ranks {ranks} hold "
                             f"{len(seen)} of the blocks wanted")
        offset += n
        out[i] = full
    return out


def reduce_to_blocks(comm: MeshComm, fulls: list, specs: list,
                     dtypes: list) -> list[torch.Tensor]:
    """Each rank's block of Σ over ranks of the full tensors `fulls`
    (every rank's own), summed in float32 in rank order, cast to `dtypes`:
    one all-to-all for the list (each rank sends every other rank that
    rank's blocks)."""
    shapes = [tuple(f.shape) for f in fulls]
    rows = []
    for j in range(comm.world):
        rows.append(torch.cat([f[comm.slices(s, f.shape, j)].float()
                               .reshape(-1) for f, s in zip(fulls, specs)]))
    recv = comm.all_to_all(torch.stack(rows))
    total = recv[0]
    for i in range(1, comm.world):
        total = total + recv[i]
    out, offset = [], 0
    for shape, spec, dt in zip(shapes, specs, dtypes):
        block = rules_lib.shard_shape(spec, shape, comm.extents)
        n = math.prod(block)
        out.append(total[offset:offset + n].reshape(block).to(dt))
        offset += n
    return out


class _Gather(torch.autograd.Function):
    """Local blocks -> full leaves; backward: the full cotangents summed
    over the ranks, each rank keeping its own block."""

    @staticmethod
    def forward(ctx, comm, specs, *locals_):
        ctx.comm, ctx.specs = comm, specs
        ctx.meta = [(t.shape, t.dtype, t.device) for t in locals_]
        return tuple(gather_full(comm, list(locals_), specs))

    @staticmethod
    def backward(ctx, *grads):
        fulls = []
        for g, spec, (shape, dtype, device) in zip(grads, ctx.specs,
                                                   ctx.meta):
            if g is None:
                counts = rules_lib.shard_counts(spec, ctx.comm.extents)
                full = [s * counts[d] if d < len(counts) else s
                        for d, s in enumerate(shape)]
                g = torch.zeros(full, dtype=dtype, device=device)
            fulls.append(g)
        return (None, None, *reduce_to_blocks(
            ctx.comm, fulls, ctx.specs, [m[1] for m in ctx.meta]))


def gather_leaves(comm: MeshComm, locals_: list, specs: list) -> list:
    """`gather_full` under autograd (`_Gather`)."""
    return list(_Gather.apply(comm, list(specs), *locals_))


# ---------------------------------------------------------------------------
# The parameters on the mesh
# ---------------------------------------------------------------------------

class ShardedLM:
    """A DecoderLM's parameters placed on a mesh: `local[path]` the rank's
    block of each leaf (a leaf tensor, for autograd), `spec[path]` its
    placement, the leaf paths those of `DecoderLM.param_tree()`."""

    def __init__(self, cfg: ModelConfig, comm: MeshComm, local: dict,
                 spec: dict, shape: dict, rules):
        self.cfg, self.comm, self.rules = cfg, comm, rules
        self.local, self.spec, self.shape = local, spec, shape

    @classmethod
    def place(cls, model: model_lib.DecoderLM, comm: MeshComm, rules,
              requires_grad: bool = True) -> "ShardedLM":
        """Each leaf of `model` (the same full model on every rank, e.g.
        from one seed) cut to this rank's block."""
        axes = model.param_axes()
        local, spec, shape = {}, {}, {}
        for path, ax, p in rules_lib.leaves_with_paths(
                axes, model.param_tree()):
            s = rules_lib.logical_to_pspec(ax, tuple(p.shape), rules,
                                           comm.extents)
            t = p.detach()[comm.slices(s, p.shape)].clone()
            local[path] = t.requires_grad_(requires_grad)
            spec[path], shape[path] = s, tuple(p.shape)
        return cls(model.cfg, comm, local, spec, shape, rules)

    @property
    def device(self) -> torch.device:
        return self.local["embed"].device

    def param_tree(self) -> dict:
        """The local blocks in the tree of `DecoderLM.param_tree()`."""
        return _unflatten(self.local)

    def sharding_tree(self) -> dict:
        return _unflatten({p: rules_lib.NamedSharding(self.comm.mesh, s)
                           for p, s in self.spec.items()})

    def placed_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.local.values())


def _nest(flat: dict) -> dict:
    """{"a/b/c": leaf} -> {"a": {"b": {"c": leaf}}}."""
    tree: dict = {}
    for path, leaf in flat.items():
        *keys, last = path.split(SEP)
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def _unflatten(flat: dict) -> dict:
    """A flat {path: leaf} of the LM's leaves in the tree of
    `DecoderLM.param_tree()` (`layers` a tuple over pattern positions)."""
    tree = _nest(flat)
    tree["layers"] = tuple(tree["layers"][str(i)]
                           for i in range(len(tree["layers"])))
    return tree


class _GatheringWeights:
    """`model.train_forward`'s and `model.serve_forward`'s weights source
    on the mesh: the top-level leaves gathered at their first use (one
    collective), each repeat of a pattern position gathered where its
    layer runs; under autograd (`gather_leaves`) for training, plain
    (`gather_full`) for serving."""

    def __init__(self, params: ShardedLM, grad: bool = True):
        self.params = params
        self.comm = params.comm
        self.gather = gather_leaves if grad else gather_full
        self._top = None
        self.stacks = {}   # path -> the local stack unbound over repeats
        for path, t in params.local.items():
            if path.startswith("layers" + SEP):
                self.stacks[path] = t.unbind(0)

    def top(self, name: str) -> torch.Tensor:
        if self._top is None:
            paths = [p for p in self.params.local
                     if not p.startswith("layers" + SEP)]
            full = self.gather(self.comm,
                               [self.params.local[p] for p in paths],
                               [self.params.spec[p] for p in paths])
            self._top = dict(zip(paths, full))
        return self._top[name]

    def layer(self, i: int, r: int) -> dict:
        prefix = f"layers{SEP}{i}{SEP}"
        paths = [p for p in self.stacks if p.startswith(prefix)]
        # a stack's spec leads with its "layers" dim, replicated
        full = self.gather(self.comm, [self.stacks[p][r] for p in paths],
                           [self.params.spec[p][1:] for p in paths])
        return _nest({p[len(prefix):]: t for p, t in zip(paths, full)})


class _MeshRows(optim_lib.Rows):
    """int8 moments of a leaf whose last axis is sharded: the rows gathered
    along that axis for the update, the rank's own part kept."""

    def __init__(self, params: ShardedLM):
        self.params = params

    def _sharded_last(self, path: str):
        spec = self.params.spec[path]
        ndim = len(self.params.shape[path])
        return spec if len(spec) == ndim and spec[-1] is not None else None

    def gather(self, path, x):
        spec = self._sharded_last(path)
        if spec is None:
            return x
        return gather_full(self.params.comm, [x], [spec],
                           dims={len(spec) - 1})[0]

    def own(self, path, x):
        spec = self._sharded_last(path)
        if spec is None:
            return x
        sl = self.params.comm.slices(spec, self.params.shape[path])
        return x[..., sl[-1]]


def global_norm(params: ShardedLM, grads: dict) -> torch.Tensor:
    """√(Σ x²) over the full gradients: each leaf's distinct blocks summed
    once (in rank order), the leaves in the reference's order."""
    comm = params.comm
    paths = list(params.local)
    sums = []
    for p in paths:
        common.phase_boundary("leaf")
        sums.append(torch.sum(torch.square(grads[p].float())))
    sums = torch.stack(sums)
    parts = comm.all_gather(sums)
    total = None
    for i, path in enumerate(paths):
        leaf = None
        for r in comm.holders(params.spec[path]):
            leaf = parts[r][i] if leaf is None else leaf + parts[r][i]
        total = leaf if total is None else total + leaf
    return torch.sqrt(total)


def local_rows(n: int, comm: MeshComm) -> tuple[slice, float]:
    """Rank r's rows of a batch of n split over the whole world, and the
    share of the batch's mean they carry: n / world rows a rank; a batch
    smaller than the world (the world a multiple of n) gives each row to
    world / n ranks, each carrying 1 / world of the mean."""
    if n % comm.world == 0:
        b = n // comm.world
        return slice(comm.rank * b, (comm.rank + 1) * b), b / n
    if comm.world % n == 0:
        r = comm.rank // (comm.world // n)
        return slice(r, r + 1), 1 / comm.world
    raise ValueError(f"a batch of {n} does not split over {comm.world} "
                     f"ranks")


def loss_and_grads(params: ShardedLM, cfg: ModelConfig, batch, step_cfg,
                   grads: bool = True) -> tuple[dict, dict | None]:
    """The mesh's loss over the global `batch` (the same on every rank;
    each rank takes its rows) and the gradient of every leaf in its own
    placement: ({"loss", "ce", "aux"}, the same on every rank; {path: this
    rank's block of the full gradient}, or None with grads=False, a
    forward alone)."""
    comm = params.comm
    n = int(batch["tokens"].shape[0])
    rows, share = local_rows(n, comm)
    local = {k: v[rows].to(params.device) for k, v in batch.items()}
    paths = list(params.local)
    # every rank holds the same number of rows: the global mean is the
    # ranks' mean, each rank's loss weighted by its share
    with torch.set_grad_enabled(grads), common.split_batch(comm.all_sum):
        logits, _, aux = model_lib.train_forward(
            cfg, _GatheringWeights(params), local["tokens"],
            step_cfg.compute_dtype, step_cfg.remat and grads,
            local.get("vision"))
        ce = common.cross_entropy(logits, local["labels"])
        loss = ce + step_cfg.aux_weight * aux / max(cfg.n_layers, 1)
        g = (dict(zip(paths, torch.autograd.grad(
            loss * share, [params.local[p] for p in paths])))
             if grads else None)
    total = comm.sum_in_order(torch.stack([loss.detach().float(),
                                           ce.detach().float()]) * share)
    return ({"loss": total[0], "ce": total[1], "aux": aux.detach().float()},
            g)


def train_step(cfg: ModelConfig, opt_cfg, step_cfg):
    """The mesh counterpart of `train.step.make_train_step`'s step:
    step(params: ShardedLM, opt_state (local blocks), batch (the global
    batch, the same on every rank)) -> (params, opt_state, metrics), the
    metrics equal on every rank; a loss that is not finite leaves the
    state as it was. The step refuses a MoE config whose dispatch is not
    "grouped" when it is called, on a ShardedLM only (one device trains
    either dispatch)."""

    def step(params: ShardedLM, opt_state, batch):
        if cfg.n_experts and cfg.moe_dispatch != "grouped":
            raise ValueError("the mesh step splits the batch over ranks: a "
                             "'global' MoE dispatch buffer would span it")
        metrics, grads = loss_and_grads(params, cfg, batch, step_cfg)
        if not optim_lib.loss_is_finite(metrics["loss"]):
            return params, opt_state, metrics
        _, opt_state, om = optim_lib.adamw_update(
            _unflatten(grads), opt_state, params.param_tree(),
            step_cfg.opt_config(opt_cfg), gnorm=global_norm(params, grads),
            rows=_MeshRows(params))
        return params, opt_state, {**metrics, **om}

    return step


def init_opt_state(params: ShardedLM, opt_cfg) -> dict:
    """Zero moments in each rank's blocks of `opt_state_axes`' placements
    (an int8 leaf's scales whole along the blocks)."""
    int8 = opt_cfg.moments_dtype == "int8"
    device = params.device

    def zeros(path):
        shape, spec = params.shape[path], params.spec[path]
        block = rules_lib.shard_shape(spec, shape, params.comm.extents)
        if not int8:
            return torch.zeros(block, dtype=torch.float32, device=device)
        nb = -(-shape[-1] // opt_cfg.quant_block)
        return {"q": torch.zeros(block, dtype=torch.int8, device=device),
                "scale": torch.zeros(tuple(block[:-1]) + (nb,),
                                     dtype=torch.float32, device=device)}

    return {"m": _unflatten({p: zeros(p) for p in params.local}),
            "v": _unflatten({p: zeros(p) for p in params.local}),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def opt_sharding_tree(params: ShardedLM, opt_cfg) -> dict:
    """NamedShardings of `init_opt_state`'s tree (`opt_state_axes`)."""
    meta, axes = model_lib.abstract_params(params.cfg)
    like = optim_lib.init_opt_state(meta, opt_cfg)
    return rules_lib.tree_shardings(
        params.comm.mesh, params.rules,
        optim_lib.opt_state_axes(axes, opt_cfg), like)


def state_shardings(params: ShardedLM, opt_state) -> dict:
    """{"params", "opt"}: the NamedSharding trees of a mesh state."""
    int8 = "q" in flatten_with_paths(opt_state["m"])[0][0].split(SEP)
    return {"params": params.sharding_tree(),
            "opt": opt_sharding_tree(params, optim_lib.OptConfig(
                moments_dtype="int8" if int8 else "f32"))}


# ---------------------------------------------------------------------------
# Sharded caches
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MeshCaches:
    """A rank's blocks of `init_cache`'s tree (`local`) and their specs
    (`specs`, the same tree), placed by `cache_axes`."""
    local: tuple
    specs: tuple


def init_local_cache(params: ShardedLM, batch: int, max_len: int,
                     dtype=torch.float32) -> MeshCaches:
    """This rank's blocks of `init_cache(cfg, batch, max_len, dtype)`
    (built whole on the rank's device, then cut)."""
    cfg, comm = params.cfg, params.comm
    full = model_lib.init_cache(cfg, batch, max_len, dtype, params.device)
    axes = model_lib.cache_axes(cfg)
    specs = rules_lib.tree_pspecs(comm.extents, params.rules, axes, full)
    local = rules_lib.map_axes(
        lambda _, t, s: t[comm.slices(s, t.shape)].clone(), axes, full,
        specs)
    return MeshCaches(local, specs)


def batch_rows(params: ShardedLM, batch: int) -> tuple[tuple, slice]:
    """(the placement of a serving batch of `batch` rows by its "batch"
    logical axis, this rank's rows of it: all of them where the rows
    split over no axis)."""
    comm = params.comm
    spec = rules_lib.logical_to_pspec(("batch",), (batch,), params.rules,
                                      comm.extents)
    return spec, comm.slices(spec, (batch,))[0] if spec else slice(0, batch)


def gather_rows(params: ShardedLM, block: torch.Tensor,
                batch: int) -> torch.Tensor:
    """The whole batch of a tensor whose leading dim holds this rank's
    rows (`batch_rows`): one all-gather over the batch's mesh axis alone
    (the ranks of a `model` group hold the same rows), over the world
    where the rows span more than one axis."""
    spec, _ = batch_rows(params, batch)
    axes = rules_lib.spec_axes(spec)
    return gather_full(params.comm, [block], [spec],
                       over=axes[0] if len(axes) == 1 else None)[0]


class _RowCaches:
    """`model.serve_forward`'s caches on the mesh: `layer(i, r)` the cache
    of repeat r of pattern position i for this rank's rows, whole along
    every other dim, gathered just before the layer runs from the ranks
    that hold the same rows (the group along the one mesh axis the cache
    is split over besides the rows' `row_axes`; the world where it is
    split over more); `write` copies a recurrent mixer's new state over
    it and writes the rank's own block back into its local stack just
    after."""

    def __init__(self, comm: MeshComm, caches: MeshCaches, batch: int,
                 rows: slice, row_axes: list):
        self.comm, self.caches, self.batch = comm, caches, batch
        self.row_axes = set(row_axes)
        self.n_rows = rows.stop - rows.start

    def layer(self, i: int, r: int):
        local, specs = self.caches.local[i], self.caches.specs[i]
        if not local:
            return local   # cross-attention: no cache
        if any(s[:1] not in ((), (None,)) for s in specs):
            raise ValueError(f"pattern position {i}: a cache stack's "
                             f"layers dim is sharded ({specs})")
        split = {a for s in specs
                 for a in rules_lib.spec_axes(s)} - self.row_axes
        got = gather_full(self.comm, [t[r] for t in local],
                          [s[1:] for s in specs],
                          dims=set(range(1, max(t.dim() for t in local) - 1)),
                          over=split.pop() if len(split) == 1 else None)
        for g in got:
            if g.shape[0] != self.n_rows:
                raise ValueError(f"a cache block holds {g.shape[0]} batch "
                                 f"rows; the step computes {self.n_rows}")
        return type(local)(*got)

    def write(self, i: int, r: int, cache, new) -> None:
        for row, leaf in zip(cache, new):
            if leaf is not row:   # a recurrent mixer's new state
                row.copy_(leaf)
        for t, spec, g in zip(self.caches.local[i], self.caches.specs[i],
                              cache):
            own = list(self.comm.slices(spec[1:],
                                        (self.batch, *g.shape[1:])))
            own[:1] = [slice(None)]   # g holds this rank's rows only
            t[r].copy_(g[tuple(own)])


def serve_step(cfg: ModelConfig, step_cfg, mode: str):
    """The mesh counterpart of make_prefill_step's and make_decode_step's
    steps over a ShardedLM and MeshCaches. prefill(params, tokens, caches,
    vision) -> (this rank's block of the logits: its rows by `batch_rows`,
    every position, the whole vocabulary; caches); decode(params, tokens,
    caches, pos, vision) -> (next tokens of the whole batch, gathered over
    the batch's axis, caches); tokens (and vision) the whole batch, the
    same on every rank. A rank runs `model.serve_forward` on its rows, one
    layer's weights and one layer's cache gathered at a time (see the
    module docstring), and writes back only its own cache blocks."""

    def run(params: ShardedLM, tokens, caches: MeshCaches, pos=None,
            vision=None):
        model_lib.require_source(cfg, vision)
        batch = int(tokens.shape[0])
        row_spec, rows = batch_rows(params, batch)
        row_caches = _RowCaches(params.comm, caches, batch, rows,
                                rules_lib.spec_axes(row_spec))
        device = params.device
        vis = None if vision is None else vision[rows].to(device)
        with torch.no_grad():
            out, _ = model_lib.serve_forward(
                cfg, _GatheringWeights(params, grad=False),
                tokens[rows].to(device), mode, row_caches, pos,
                step_cfg.compute_dtype, vis)
        if mode == "prefill":
            return out, caches
        return gather_rows(params, model_lib.greedy(out), batch), caches

    if mode == "prefill":
        return lambda params, tokens, caches, vision=None: run(
            params, tokens, caches, vision=vision)
    return lambda params, tokens, caches, pos, vision=None: run(
        params, tokens, caches, pos, vision)


# ---------------------------------------------------------------------------
# Full states and their blocks
# ---------------------------------------------------------------------------

def gather_tree(comm: MeshComm, local_tree, shardings):
    """The full arrays (on every rank) of a state whose tensor leaves are
    blocks placed by the NamedSharding tree `shardings`, one leaf at a
    time; other leaves pass through."""
    specs = {path: sh.spec for path, sh in flatten_with_paths(shardings)}
    return _map_paths(
        lambda path, t: gather_full(comm, [t], [specs[path]])[0]
        if isinstance(t, torch.Tensor) else t, local_tree)


def place_tree(comm: MeshComm, full_tree, shardings):
    """This rank's blocks of a full state by the NamedSharding tree."""
    specs = {path: sh.spec for path, sh in flatten_with_paths(shardings)}
    return _map_paths(
        lambda path, t: t[comm.slices(specs[path], t.shape)].clone()
        if isinstance(t, torch.Tensor) else t, full_tree)


def _map_paths(fn, tree):
    it = iter([fn(path, leaf) for path, leaf in flatten_with_paths(tree)])
    return map_leaves(lambda _: next(it), tree)
