"""Step accounting and the three-term roofline of the port (counterpart of
`repro.launch.roofline`), with one NVIDIA H100's own peaks:

  compute    = global_FLOPs / (chips × PEAK_FLOPS)     [bf16 dense tensor]
  memory     = per_device_bytes / HBM_BW                [HBM3]
  collective = per_device_link_bytes / LINK_BW          [NVLink 4, each way]

Sources:
  * FLOPs and bytes — `count_flops`, a TorchDispatchMode over the aten ops
    a callable dispatches, and `step_flops(fn, *args)`, which runs `fn`
    under it (on "meta" arguments for a dry count: nothing allocated, no
    device). The port runs eagerly, so one dispatched op is one kernel and
    a Python loop runs every iteration: the count multiplies loop bodies by
    their true trip counts, and the bytes of each op's inputs and outputs
    are the step's true unfused traffic (the counterpart of the reference's
    HLO kernel-boundary bytes). Products are counted as the reference's
    `_dot_flops`; elementwise ops, transcendentals and reductions by its
    tables (`AtenCosts`), mapped onto aten names.
    One deliberate difference: the reference averages a `lax.cond` over its
    branches, so its causal chunk skip counts half an attend for every
    (q chunk, kv chunk) pair; the port counts the attend bodies its loop
    runs (models/attention.py `chunked_causal_attention`).
  * peak memory — the same pass tracks every device storage alive during
    the call (`StepCost.memory`: argument, output, peak temp and peak total
    bytes; the caching allocator's rounding to 512-byte blocks left out),
    the counterpart of the reference's `memory_analysis()`; and the peak
    within each phase of the step (models/common.py `phase_boundary`: a
    repeat of the pattern, a leaf of a loop over the parameters), which
    `over_repeats` extrapolates phase by phase over the repeats.
  * collective bytes — from the mesh's communicator (`sharding.lm.DryComm`
    on "meta", counting as `MeshComm` counts).

The peaks are NVIDIA's data-sheet figures for the H100 SXM5 at its full
700 W limit, the card the port's chip runs read as "NVIDIA H100 80GB HBM3,
700.00 W" (`nvidia-smi --query-gpu=name,power.limit`). The port's mesh
runs its collectives over gloo through host memory, far below NVLink: the
collective term is the card's bound, not what the port reaches today.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# NVIDIA H100 80GB HBM3 (SXM5), 700.00 W: data-sheet peaks, one card.
PEAK_FLOPS = 989.4e12      # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12           # HBM3 bytes/s
LINK_BW = 450e9            # NVLink 4 bytes/s each way (18 links)
CARD = "NVIDIA H100 80GB HBM3 (SXM5), 700.00 W"

# ======================================================================
# 1. The FLOP and byte walker
# ======================================================================


class AtenCosts:
    """The reference's FLOP tables mapped onto aten op names, in one place
    (an in-place variant `add_` takes its op's entry). Every other op
    counts zero FLOPs: `ZERO` names those the port's steps dispatch
    (copies, casts, indexing, comparisons, and ops the reference's tables
    leave out, as log1p), `VIEWS` those that launch no kernel (no bytes
    either; an `empty` makes a storage, tracked), and an op in no table
    is counted in `StepCost.unmapped`."""

    PRODUCTS = {"mm", "addmm", "bmm", "baddbmm"}
    ELEMENTWISE_1 = {          # one FLOP an output element
        "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "neg",
        "abs", "floor", "sign", "sgn", "bitwise_and", "bitwise_or",
        "bitwise_xor", "bitwise_not", "logical_and", "logical_or",
        "logical_xor", "logical_not", "where", "masked_fill", "pow",
        "remainder", "fmod",
        "reciprocal", "square", "clamp_min", "clamp_max",
        "threshold_backward"}
    ELEMENTWISE_X = {          # transcendentals: a few FLOPs an element
        "exp": 4, "log": 4, "tanh": 6, "sigmoid": 6, "rsqrt": 2, "sqrt": 2,
        "erf": 6, "sin": 4, "cos": 4, "cumsum": 1, "logcumsumexp": 8,
        "cumprod": 1, "cummax": 1, "clamp": 2,
        # the backward kernels of a transcendental, as the reference's
        # gradient writes them: g·(1 - y²) and g·y·(1 - y)
        "tanh_backward": 3, "sigmoid_backward": 3}
    REDUCE = {"sum", "amax", "amin", "prod", "any", "all", "argmax",
              "argmin", "max", "min", "mean"}
    # one kernel for several of the reference's primitives: FLOPs an input
    # element (softmax: max, sub, exp 4, sum, div)
    COMPOSITE = {"_softmax": 8, "_log_softmax": 8, "logsumexp": 7,
                 "_softmax_backward_data": 4}
    ZERO = {
        "_to_copy", "copy", "clone", "zeros", "zeros_like", "ones_like",
        "full", "new_full", "new_zeros", "arange", "scalar_tensor",
        "lift_fresh", "index", "index_put", "gather", "scatter",
        "scatter_add", "select_backward", "slice_backward", "cat", "stack",
        "constant_pad_nd", "sort", "searchsorted", "eq", "ne", "lt", "le",
        "gt", "ge", "log1p", "expm1", "round", "_local_scalar_dense"}
    VIEWS = {
        "view", "_unsafe_view", "expand", "permute", "transpose", "t",
        "unsqueeze", "squeeze", "slice", "select", "as_strided", "alias",
        "detach", "unbind", "split", "split_with_sizes", "empty",
        "empty_like"}

    @classmethod
    def name(cls, func) -> str:
        name = func.overloadpacket.__name__
        return name[:-1] if name.endswith("_") and not name.startswith(
            "_") and name[:-1] else name


def _dot_flops(name: str, args) -> float:
    """2·batch·contract·free of a product's operands."""
    if name in ("mm", "addmm"):
        a, b = (args[0], args[1]) if name == "mm" else (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    a, b = (args[0], args[1]) if name == "bmm" else (args[1], args[2])
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _distinct_bytes(t: torch.Tensor) -> int:
    """The bytes a tensor addresses: broadcast (stride 0) dims once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _held_tensors(obj, out: list, seen: set) -> None:
    """Every tensor an argument holds: tensors, mappings, sequences, a
    module's parameters and buffers, a dataclass's fields, an object's
    `local` blocks (a ShardedLM, MeshCaches)."""
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, torch.nn.Module):
        out.extend(obj.state_dict(keep_vars=True).values())
    elif isinstance(obj, dict):
        for v in obj.values():
            _held_tensors(v, out, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _held_tensors(v, out, seen)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _held_tensors(getattr(obj, f.name), out, seen)
    elif hasattr(obj, "local") and isinstance(obj.local, (dict, tuple)):
        _held_tensors(obj.local, out, seen)


class count_flops(TorchDispatchMode):
    """While active, counts every aten op dispatched: FLOPs (products
    apart), the bytes of its inputs and outputs, and the device storages
    alive (a storage's bytes from the op that made it until it is freed;
    CPU storages are host memory and not counted). Hold the call's
    arguments first (`hold`) so that they count as live from the start,
    and its result after (`returned`). Holds no tensor: storages are
    tracked by weak references."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.dot_flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.unmapped: Counter = Counter()
        self._live: dict[int, tuple] = {}    # id(storage) -> (ref, n, op)
        self._live_by_op: Counter = Counter()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.peak_by_op: dict = {}
        self.argument_bytes = 0
        self.output_bytes = 0
        # the peak within each phase and its kind: the step's start, then
        # one a `phase_boundary` (a repeat begun, or a leaf of a loop)
        self.phase_peaks = [0]
        self.phase_kinds = ["start"]

    def phase_boundary(self, kind: str) -> None:
        """A phase begins (models/common.py `phase_boundary`)."""
        self.phase_peaks.append(self.live_bytes)
        self.phase_kinds.append(kind)

    # -- storages -----------------------------------------------------
    def _track(self, t: torch.Tensor, op: str) -> bool:
        if t.device.type == "cpu":
            return False
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return False
        n = st.nbytes()

        def freed(_, key=key, n=n, op=op):
            if self._live.pop(key, None) is not None:
                self.live_bytes -= n
                self._live_by_op[op] -= n
        self._live[key] = (weakref.ref(st, freed), n, op)
        self.live_bytes += n
        self._live_by_op[op] += n
        self.phase_peaks[-1] = max(self.phase_peaks[-1], self.live_bytes)
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            self.peak_by_op = {k: v for k, v in self._live_by_op.items()
                               if v}
        return True

    def hold(self, *args) -> None:
        """The call's arguments: their storages live from the start."""
        held: list = []
        _held_tensors(args, held, set())
        for t in held:
            if self._track(t, "arguments"):
                self.argument_bytes += t.untyped_storage().nbytes()

    def returned(self, out) -> None:
        """The call's result: its storages made during the call."""
        held: list = []
        _held_tensors(out, held, set())
        made = {}
        for t in held:
            entry = self._live.get(id(t.untyped_storage()))
            if entry is not None and entry[2] != "arguments":
                made[id(t.untyped_storage())] = entry[1]
        self.output_bytes += sum(made.values())

    # -- ops ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = AtenCosts.name(func)
        if name in AtenCosts.VIEWS:   # an `empty` makes a storage
            for t in _tensors(out):
                self._track(t, name)
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        flops = 0.0
        if name in AtenCosts.PRODUCTS:
            dot = _dot_flops(name, args)
            self.dot_flops += dot
            flops = dot + (outs[0].numel()
                           if name in ("addmm", "baddbmm") else 0.0)
        elif name in AtenCosts.ELEMENTWISE_1:
            flops = float(sum(t.numel() for t in outs))
        elif name in AtenCosts.ELEMENTWISE_X:
            flops = float(sum(t.numel() for t in outs)) * \
                AtenCosts.ELEMENTWISE_X[name]
        elif name in AtenCosts.REDUCE:
            if name in ("max", "min") and len(ins) == 2:
                flops = float(outs[0].numel())        # elementwise form
            else:
                flops = float(ins[0].numel()) + (
                    outs[0].numel() if name == "mean" else 0.0)
        elif name in AtenCosts.COMPOSITE:
            flops = float(ins[0].numel()) * AtenCosts.COMPOSITE[name]
        elif name not in AtenCosts.ZERO:
            self.unmapped[str(func.overloadpacket)] += 1
        self.flops += flops
        self.ops += 1
        self.bytes += sum(_distinct_bytes(t) for t in ins) + \
            sum(_distinct_bytes(t) for t in outs)
        for t in outs:
            self._track(t, name)
        return out

    def memory(self) -> dict:
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": self.peak_bytes - self.argument_bytes,
                "peak_bytes": self.peak_bytes,
                "peak_by_op": dict(sorted(self.peak_by_op.items(),
                                          key=lambda kv: -kv[1])),
                "phase_peaks": list(self.phase_peaks),
                "phase_kinds": list(self.phase_kinds)}


@dataclasses.dataclass
class StepCost:
    """One rank's step (the counterpart of the reference's HloSummary and
    memory_analysis): FLOPs (products in `dot_flops`), op-boundary bytes,
    the ops counted, collective bytes by kind with a detail list, memory
    (argument, output, temp and peak bytes; the peak's live bytes by the op
    that made them; the peak within each phase, `count_flops.phase_peaks`),
    and the ops of no table (`unmapped`, by count)."""
    flops: float
    dot_flops: float
    bytes: float
    ops: int
    collective_bytes: dict
    collective_detail: list
    memory: dict
    unmapped: dict


def step_flops(fn, *args, comm=None) -> StepCost:
    """Run fn(*args) under `count_flops` and return its StepCost. Give
    "meta" arguments for a dry count (a meta tensor holds no data: a step
    that must read one takes its meta path); `comm`, a communicator with
    `bytes` (and `detail`) that the call's collectives count into
    (`sharding.lm.DryComm` or `MeshComm`), gives the collective bytes."""
    before = dict(comm.bytes) if comm is not None else {}
    n_detail = len(getattr(comm, "detail", ()))
    counter = count_flops()
    with counter:
        counter.hold(*args)
        out = fn(*args)
        counter.returned(out)
    del out
    coll = {k: float(v - before[k]) for k, v in comm.bytes.items()} \
        if comm is not None else {}
    detail = _grouped(getattr(comm, "detail", ())[n_detail:])
    return StepCost(counter.flops, counter.dot_flops, counter.bytes,
                    counter.ops, coll, detail, counter.memory(),
                    dict(counter.unmapped))


def _grouped(calls) -> list:
    """A communicator's calls ({"op", "bytes", "ranks"}) grouped by
    collective and group size: {"op", "ranks", "calls", "bytes"} (bytes
    summed over the calls)."""
    out: dict = {}
    for d in calls:
        g = out.setdefault((d["op"], d["ranks"]), {
            "op": d["op"], "ranks": d["ranks"], "calls": 0, "bytes": 0})
        g["calls"] += 1
        g["bytes"] += d["bytes"]
    return [out[k] for k in sorted(out)]


def _weights(n: int, at) -> list:
    """Lagrange weights of the points 1..n at `at` (integers at an
    integer `at`)."""
    out = []
    for i in range(1, n + 1):
        num, den = 1, 1
        for j in range(1, n + 1):
            if j != i:
                num, den = num * (at - j), den * (i - j)
        out.append(num // den if num % den == 0 else num / den)
    return out


def _through(values: list, weights: list):
    """Σ weights·values, through dicts (a missing key is 0); integral
    floats summed as integers, so that the result is exact."""
    if any(isinstance(v, dict) for v in values):
        keys = {k: None for v in values for k in v}
        return {k: _through([v.get(k, 0) for v in values], weights)
                for k in keys}
    total = sum(w * (int(v) if float(v).is_integer() else v)
                for w, v in zip(weights, values))
    return type(values[0])(total) if isinstance(values[0], float) else total


def extrapolate(counts: list, at) -> StepCost:
    """The cost at position `at` of the polynomial through the StepCosts
    `counts`, taken at positions 1..len(counts), each with phases of the
    same kind (`over_repeats` gives such): every count, and the peak
    within each phase, lies on it; the peak is their largest. Three cuts
    of xlstm-125m's sequence give its step (quadratic in the sequence:
    autograd sums each position's gradient into the whole sequence's);
    tests/test_torch_roofline.py holds it to a direct count."""
    w = _weights(len(counts), at)
    details = [{(d["op"], d["ranks"]): {"calls": d["calls"],
                                        "bytes": d["bytes"]}
                for d in c.collective_detail} for c in counts]
    detail = _through(details, w)
    unmapped: dict = {}
    for c in counts:
        unmapped.update(c.unmapped)
    phases = [_through(list(p), w) for p in zip(
        *(c.memory["phase_peaks"] for c in counts))]
    memory = {k: _through([c.memory[k] for c in counts], w)
              for k in ("argument_bytes", "output_bytes")}
    memory["peak_bytes"] = max(phases)
    memory["temp_bytes"] = memory["peak_bytes"] - memory["argument_bytes"]
    memory["phase_peaks"] = phases
    memory["phase_kinds"] = counts[0].memory["phase_kinds"]
    return StepCost(
        *(_through([getattr(c, f) for c in counts], w)
          for f in ("flops", "dot_flops", "bytes", "ops",
                    "collective_bytes")),
        [{"op": op, "ranks": n, **detail[op, n]}
         for op, n in sorted(detail) if detail[op, n]["calls"]],
        memory, unmapped)


def _phase_kinds(cost: StepCost, repeats: int) -> StepCost:
    """`cost` (a step of `repeats` ≥ 2 pattern periods) with its phase
    peaks cut to one of each kind: every phase outside the repeats (the
    start, each leaf of a loop over the parameters) and, of the repeats'
    phases, the first and the last of each pass (the forward; under remat
    the recompute and backward). Within a phase every live byte grows by
    the same share a repeat, so its peak is linear in the repeats; a
    middle repeat's lies between the first's and the last's of its pass
    (live bytes change by one repeat's share a repeat)."""
    kinds = cost.memory["phase_kinds"]
    reps = [i for i, k in enumerate(kinds) if k == "repeat"]
    if len(reps) % repeats:
        raise ValueError(f"{len(reps)} repeat phases for {repeats} repeats")
    ends = set()
    for start in range(0, len(reps), repeats):
        ends |= {reps[start], reps[start + repeats - 1]}
    keep = [i for i, k in enumerate(kinds) if k != "repeat" or i in ends]
    return dataclasses.replace(cost, memory={
        **cost.memory,
        "phase_peaks": [cost.memory["phase_peaks"][i] for i in keep],
        "phase_kinds": [kinds[i] for i in keep]})


def over_repeats(two: StepCost, three: StepCost, repeats: int) -> StepCost:
    """The cost of a step of `repeats` pattern periods from its counts at
    two and three: every count is linear in the repeats (they are
    identical; what lies outside them, the embedding, the head and the
    optimizer's fixed part, is the same in every cut), and so is the peak
    within each kind of phase (`_phase_kinds`); the step's peak is their
    largest at `repeats`. A max of lines is not a line: extrapolating the
    peak alone would miss a phase that overtakes past the cuts (the int8
    optimizer on llama3-405b's 126 stacked repeats does)."""
    two, three = _phase_kinds(two, 2), _phase_kinds(three, 3)
    if two.memory["phase_kinds"] != three.memory["phase_kinds"]:
        raise ValueError("the cuts' phases differ in kind")
    return extrapolate([two, three], repeats - 1)


def link_bytes(detail: list) -> dict:
    """Bytes each way over one rank's links, by collective, from a
    StepCost's collective detail ({"op", "ranks", "bytes"}, the bytes the
    rank put in): a gather of a p-byte piece over n ranks receives
    (n - 1)·p; an all-to-all of a b-byte buffer sends (n - 1)/n of it."""
    out: dict = {}
    for d in detail:
        n = d["ranks"]
        moved = d["bytes"] * (n - 1) if d["op"] == "all_gather" else \
            d["bytes"] * (n - 1) / n
        out[d["op"]] = out.get(d["op"], 0.0) + moved
    return out


# ======================================================================
# 2. Three-term roofline
# ======================================================================

@dataclasses.dataclass
class Roofline:
    """The reference's fields, with the card's peaks. `hlo_flops_raw`
    held the reference's second count beside its walker's (XLA's
    cost_analysis); here it holds the products' share of `global_flops`,
    the count `torch.utils.flop_counter.FlopCounterMode` gives.
    `collective_bytes` are a rank's link bytes each way (`link_bytes`)."""
    arch: str
    shape: str
    mesh: str
    chips: int
    global_flops: float
    hlo_flops_raw: float
    per_device_hbm_bytes: float
    collective_bytes: dict[str, float]
    model_flops: float            # 6·N·D (dense) / 6·N_active·D (MoE)

    @property
    def t_compute(self) -> float:
        return self.global_flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.per_device_hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return sum(self.collective_bytes.values()) / LINK_BW

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def usefulness(self) -> float:
        return self.model_flops / max(self.global_flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs throughput achievable at the dominant term vs
        peak."""
        if self.t_bound <= 0:
            return 0.0
        return self.model_flops / self.t_bound / (self.chips * PEAK_FLOPS)

    def fraction_at(self, seconds: float) -> float:
        """`roofline_fraction` at a measured step time: the useful FLOPs a
        second over the chips' peak (the MFU)."""
        return self.model_flops / seconds / (self.chips * PEAK_FLOPS)

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "global_flops": self.global_flops,
            "hlo_flops_raw": self.hlo_flops_raw,
            "per_device_hbm_bytes": self.per_device_hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "usefulness": self.usefulness,
            "roofline_fraction": self.roofline_fraction,
            "peaks": {"card": CARD, "flops": PEAK_FLOPS, "hbm": HBM_BW,
                      "link": LINK_BW},
        }


# ======================================================================
# 3. Analytic models (the reference's, unchanged)
# ======================================================================

def scan_bytes_per_row(streamed_dtypes) -> int:
    """Bytes/row a sample-family scan streams from device memory: the sum of
    the per-row itemsizes (`torch.dtype.itemsize`) of its streamed block
    tensors. Dtype-exact and
    machine-independent. Constant blocks (the frequency table, the query
    constants) amortize to ~0 bytes/row and are excluded; pass ONLY the
    per-row streams.

    The fused layout on a 1-atom dict-encoded template: f32 values + f32
    unit + int8 strat + bool valid + int8 atom + int8 codes = 12 B/row."""
    return int(sum(d.itemsize for d in streamed_dtypes))


def scan_hbm_seconds(n_rows: float, bytes_per_row: float,
                     chips: int = 1) -> float:
    """Bandwidth-bound scan time: the roofline memory term of a
    family-prefix scan (O(1) FLOPs a byte, so device memory binds), on the
    card's HBM_BW."""
    return n_rows * bytes_per_row / (chips * HBM_BW)


def model_flops_for(cfg, shape_kind: str, seq_len: int, global_batch: int,
                    n_new: int = 1) -> float:
    """6·N·D for train; 2·N_active per generated/processed token for serve."""
    n_active = cfg.active_param_count()
    if shape_kind == "train":
        return 6.0 * n_active * seq_len * global_batch
    if shape_kind == "prefill":
        return 2.0 * n_active * seq_len * global_batch
    return 2.0 * n_active * n_new * global_batch   # decode


def analytic_memory_bytes(cfg, shape_kind: str, seq_len: int,
                          global_batch: int, policy: str,
                          mesh_shape: dict, attn_dp: bool = False) -> float:
    """Per-device memory traffic of one step under the reference's TPU
    fusion model (flash attention keeps score blocks on chip; elementwise
    chains fuse into their producer matmuls; parameters all-gathered per
    pass under FSDP): the reference's arithmetic unchanged, a model of its
    TPU program, not a measurement of the port on the card."""
    data = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    model = mesh_shape.get("model", 1)
    # attn_dp archs run their mixers batch-sharded over (data × model):
    # activation traffic per device drops by the model extent for those
    # tensors (~2/3 of the per-layer working set).
    act_scale = (1.0 / 3.0 + 2.0 / 3.0 / model) if attn_dp else 1.0
    p_total = cfg.param_count()
    b_param = 2.0 if policy == "lowmem" else 4.0
    b_act = 2.0
    d = cfg.d_model
    v_shard = cfg.vocab_size / model
    b_local = max(global_batch / data, 1.0)

    # big activation-sized tensors per layer that hit memory (q,k,v,out,
    # mlp h/g, residuals, norms) — flash keeps S×S blocks on chip.
    act_tensors = 12.0

    if shape_kind == "train":
        # params: sharded storage P/(data·model); per pass each device reads
        # a full model-shard (P/model) via FSDP all-gather (+ write of the
        # gathered copy). fwd + remat-fwd + bwd = 3 passes.
        param_traffic = 3 * 2 * (p_total / model) * b_param
        # optimizer: grads write + m/v read/write + param read/write on the
        # fully sharded slice
        mom = 2.0 if policy == "lowmem" else 8.0   # int8 m+v vs f32 m+v
        opt_traffic = (p_total / (data * model)) * (4 + 2 * mom + 2 * b_param)
        acts = (cfg.n_layers * act_tensors * b_local * seq_len * d * b_act
                * 2.5) * act_scale  # fwd + bwd (+remat re-reads)
        logits = 3 * b_local * seq_len * v_shard * 4.0
        return param_traffic + opt_traffic + acts + logits
    if shape_kind == "prefill":
        param_traffic = (p_total / model) * b_param
        acts = cfg.n_layers * act_tensors * b_local * seq_len * d * b_act \
            * act_scale
        cache_write = _cache_bytes(cfg, b_local, seq_len, model)
        return param_traffic + acts + cache_write
    # decode: read all (model-shard) params once + read the full cache.
    param_traffic = (p_total / model) * b_param
    cache_rw = _cache_bytes(cfg, b_local, seq_len, model)
    acts = cfg.n_layers * act_tensors * b_local * 1 * d * b_act
    return param_traffic + cache_rw + acts


def _cache_bytes(cfg, b_local: float, seq_len: int, model: int) -> float:
    """KV/state cache bytes per device (bf16), honoring seq/model sharding."""
    total = 0.0
    n_rep = cfg.n_layers // len(cfg.pattern)
    for spec in cfg.pattern:
        if spec.mixer == "attn":
            kv_div = model if cfg.n_kv_heads % model == 0 else 1
            seq_div = 1 if kv_div > 1 else (model if seq_len % model == 0 else 1)
            total += (2 * b_local * cfg.n_kv_heads * seq_len * cfg.head_dim
                      * 2.0 / (kv_div * seq_div)) * n_rep
        elif spec.mixer == "mamba":
            di = cfg.mamba_expand * cfg.d_model
            total += (b_local * di * cfg.mamba_d_state * 4.0 / model) * n_rep
        elif spec.mixer in ("mlstm", "slstm"):
            di = int(cfg.xlstm_proj_factor * cfg.d_model)
            dh = di // cfg.n_heads
            total += (b_local * cfg.n_heads * dh * dh * 4.0) * n_rep
    return total
