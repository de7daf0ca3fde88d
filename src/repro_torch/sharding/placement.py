"""Fleet placement of logical sample shards (counterpart of
`repro.sharding.placement`, pure Python and numpy).

Shards are *logical*: `executor.shard_valid_mask` hashes stable stratum
ids onto [0, n_logical) so each shard is a disjoint stratum partition of a
striped family, and `executor.run_sharded_scan` re-executes failed shard
attempts as replicas. This module promotes those logical shards into
PLACEMENT — the FlameDB/ClickHouse pattern from SNIPPETS.md (a distributed
virtual table routing to sharded + replicated local tables), simulated over
processes the way the fault layer simulates kills:

* `FamilyPlacement` — the frozen placement of ONE family's shard set: every
  logical shard has a HOME process (round-robin by shard id) and an ordered
  replica chain of processes; replica attempt r of shard s executes "on"
  process `(home + r) % n_processes`, so consecutive attempts land on
  DISTINCT processes whenever the fleet has more than one. A process-kill
  fault (`FaultSpec(site="shard.scan", match=(("process", p),))`) therefore
  takes out replica-0 of every shard homed on p at once, and the scan fails
  over to the replicas homed elsewhere — exactly the machine-loss story the
  paper's 100-node deployment needs.
* `PlacementMap` — the engine-wide registry (thread-safe): lazily builds one
  `FamilyPlacement` per (table, φ, n_logical) and rebuilds it with a longer
  replica chain when the workload monitor marks the family HOT
  (`mark_hot`). Hot replication widens fail-over, it never changes which
  strata a shard owns — answers stay bit-identical.
* `route_shard_set` — conservative batch routing: when every disjunct of a
  coalesced batch's template pins every φ column with equality, the predicate
  can only match strata whose keys equal the pinned codes, so the batch's
  answer lives on a computable subset of shards. The engine records the
  route as scan-span provenance (and per-shard counters); the sharded
  executor still scans every shard because masked-out partials are NOT
  float-bit-free: dropping an all-zero partial changes the summation tree,
  and the contract of docs/FAULTS.md keeps clean answers bit-identical.

Nothing here touches device code: placement is pure host metadata layered on
the shard masks, which is what lets the fault-free path keep running the ONE
fused launch per batch unchanged.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

from repro_torch.core import executor as exec_lib
from repro_torch.core.types import CmpOp


@dataclasses.dataclass(frozen=True)
class PlacementConfig:
    """Fleet geometry: how many simulated processes hold shard replicas and
    how long the replica chains are (normal vs hot families)."""
    n_processes: int = 2
    n_replicas: int = 2
    hot_replicas: int = 3


@dataclasses.dataclass(frozen=True)
class FamilyPlacement:
    """Placement of one family's logical shard set across processes.

    `replicas[s]` is shard s's ordered replica chain: the process each
    attempt executes on, attempt r ↔ `replicas[s][r]`. Index 0 is the HOME
    process. Chains may repeat processes when the chain is longer than the
    fleet (a single-process fleet still gets n_replicas re-execution
    attempts, as without placement)."""
    table: str
    phi: tuple[str, ...]
    n_logical: int
    n_processes: int
    replicas: tuple[tuple[int, ...], ...]
    hot: bool = False

    @property
    def n_replicas(self) -> int:
        return len(self.replicas[0]) if self.replicas else 0

    def home(self, shard: int) -> int:
        return self.replicas[shard][0]

    def replicas_for(self, shard: int) -> tuple[int, ...]:
        return self.replicas[shard]

    def shards_on(self, process: int) -> tuple[int, ...]:
        """Shards whose HOME is `process` (what a process-kill fault forces
        onto fail-over replicas)."""
        return tuple(s for s in range(self.n_logical)
                     if self.replicas[s][0] == process)

    def span_attrs(self) -> dict:
        """Scan-span placement provenance (docs/OBSERVABILITY.md): compact
        JSON-able attrs, not the full chain table."""
        return {"n_processes": self.n_processes,
                "replicas": self.n_replicas,
                "homes": [self.home(s) for s in range(self.n_logical)],
                "hot": self.hot}


def build_placement(table: str, phi: tuple[str, ...], n_logical: int,
                    config: PlacementConfig, hot: bool = False
                    ) -> FamilyPlacement:
    """Round-robin striping of shard homes over the process fleet, replica
    chain walking the ring from the home. Deterministic in (shard id,
    fleet size) only — placement survives restarts and is identical across
    every family with the same geometry, so tests and fault plans can name
    processes stably."""
    n_proc = max(1, config.n_processes)
    n_rep = max(1, config.hot_replicas if hot else config.n_replicas)
    chains = tuple(
        tuple((s + r) % n_proc for r in range(n_rep))
        for s in range(n_logical))
    return FamilyPlacement(table, tuple(phi), n_logical, n_proc, chains, hot)


class PlacementMap:
    """Engine-wide shard-placement registry (thread-safe).

    Placements are derived state — (table, φ, n_logical) plus the hot set
    fully determine them — so the map builds lazily and never persists.
    `mark_hot` is monotone: once the workload monitor promotes a family its
    replica chain stays widened until the map is rebuilt (a fleet restart)."""

    def __init__(self, config: PlacementConfig | None = None):
        self.config = config or PlacementConfig()
        self._lock = threading.Lock()
        self._cache: dict[tuple[str, tuple[str, ...], int],
                          FamilyPlacement] = {}
        self._hot: set[tuple[str, tuple[str, ...]]] = set()

    def for_family(self, table: str, phi: tuple[str, ...],
                   n_logical: int) -> FamilyPlacement:
        phi = tuple(phi)
        key = (table, phi, n_logical)
        with self._lock:
            pl = self._cache.get(key)
            hot = (table, phi) in self._hot
            if pl is None or pl.hot != hot:
                pl = build_placement(table, phi, n_logical, self.config,
                                     hot=hot)
                self._cache[key] = pl
            return pl

    def mark_hot(self, table: str, phi: tuple[str, ...]) -> bool:
        """Widen the family's replica chain to `hot_replicas`. Returns True
        on first promotion (callers count promotions, not re-marks)."""
        key = (table, tuple(phi))
        with self._lock:
            if key in self._hot:
                return False
            self._hot.add(key)
            return True

    def is_hot(self, table: str, phi: tuple[str, ...]) -> bool:
        with self._lock:
            return (table, tuple(phi)) in self._hot

    def hot_families(self) -> list[tuple[str, tuple[str, ...]]]:
        with self._lock:
            return sorted(self._hot)


def route_shard_set(strata_keys: np.ndarray | None, phi: tuple[str, ...],
                    struct, consts_list, n_logical: int
                    ) -> tuple[int, ...] | None:
    """Shard subset that can possibly contribute to a batch, or None.

    Routable only when EVERY disjunct conjunction of the template pins EVERY
    φ column with equality — then a row matching the predicate has its φ
    codes fully determined, its stratum key is one of the pinned combos, and
    `shard_of_strata` names the owning shard. Any non-equality atom, an
    unpinned φ column, or a family without stable stratum keys returns None
    (all shards may contribute). Used for provenance/metrics only: the
    sharded executor still scans the full shard set (module docstring)."""
    if strata_keys is None or not phi or not len(struct):
        return None
    keys = np.asarray(strata_keys)
    shards = exec_lib.shard_of_strata(np.arange(keys.shape[0]), n_logical)
    col_idx = {c: i for i, c in enumerate(phi)}
    # Per-conjunction atom slots into the flat consts vector.
    flat_pos: list[list[tuple[str, int]]] = []
    pos = 0
    for conj in struct:
        slots = []
        for col, op in conj:
            if col in col_idx:
                if op is not CmpOp.EQ:
                    return None
                slots.append((col, pos))
            pos += 1
        if len({c for c, _ in slots}) < len(phi):
            return None     # a disjunct leaves a φ column free
        flat_pos.append(slots)
    routed: set[int] = set()
    for consts in consts_list:
        for slots in flat_pos:
            pinned = np.empty(len(phi), dtype=np.int64)
            for col, p in slots:
                pinned[col_idx[col]] = int(round(float(consts[p])))
            hit = np.flatnonzero((keys == pinned).all(axis=1))
            routed.update(int(shards[i]) for i in hit)
    return tuple(sorted(routed))


def shard_load(striped, n_logical: int) -> np.ndarray:
    """Live sample rows per logical shard (host-side balance histogram —
    placement diagnostics and the docs/SERVICE.md striping story)."""
    valid = striped.valid.cpu().numpy().reshape(-1).astype(bool)
    shards = exec_lib.shard_of_strata(striped.strat, n_logical).reshape(-1)
    return np.bincount(shards[valid], minlength=n_logical)
