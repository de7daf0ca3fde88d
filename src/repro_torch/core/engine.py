"""BlinkDB engine facade of the port (counterpart of `repro.core.engine`).

    db = BlinkDB(EngineConfig(), device="cuda")
    db.register_table("sessions", table)
    db.build_samples("sessions", templates, storage_budget_fraction=0.5)
    ans = db.query(Query(..., bound=ErrorBound(0.1, 0.95)))

The port builds sample families offline, chosen by the §3.2 optimizer
(`build_samples`) or by hand (`add_family`), and answers COUNT, SUM, AVG
and QUANTILE under ERROR WITHIN or WITHIN SECONDS on one device, one
query at a time (`query`) or as a batch that shares its scans
(`query_batch`): runtime family selection (§4.1), the ELP choice of the
resolution K (§4.2) with the a-priori ERROR WITHIN ladder (pilot, certify
at the top resolution, escalation, exact fallback), the fused scan and the
one-pass quantile scan (executor → the CUDA kernels on the card), and HT
estimation with Table-2 error bars (§4.3) or, with
`ci_method="subsampling"`, variational-subsampling CIs from the same
kernels over n_groups·B segments. Queries may join the sampled fact table
to registered dimension tables (§2.1: `Query(joins=...)`, attributes named
"dim.col"). Tables take appends, deletes and updates while they serve
(`append_rows`, `delete_rows`, `update_rows`): every family is merged or
tombstoned in place and its striped block patched, and the storage the
mutations leave behind is reclaimed by `compact_family`, `compact_table`
and `decay_family` (docs/MAINTENANCE.md; `core/maintenance.py` drives
them). Under an armed, non-empty fault plan (`repro_torch.fault`) every
scan runs shard-partitioned with replicas (executor.run_sharded_scan):
a lost shard degrades the answer (HT reweight, wider CIs) instead of
failing it; without one the single fused pass runs, bit for bit as
before. Every scan is a declared fault site ("engine.scan") and a span of
the query's trace (obs.trace) when one is active.

With `mesh=` (a torch.distributed DeviceMesh, its data axes `data_axes`)
the engine runs SPMD, one process per data shard: every rank builds the
same engine from the same config, tables and families, keeps only its own
stripe of each family on its device, scans it with the same kernels and
merges the partials in shard order (executor.merge_partials), so every
rank returns the same Answer. Host clocks that steer a decision (the
WITHIN SECONDS latency probes, the straggler deadline) are agreed as the
slowest rank's.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import elp as elp_lib
from repro_torch.core import estimators as est_lib
from repro_torch.core import executor as exec_lib
from repro_torch.core import joins as join_lib
from repro_torch.core import optimizer as opt_lib
from repro_torch.core import sampling as samp_lib
from repro_torch.core import table as table_lib
from repro_torch.core.selection import rewrite_disjuncts, select_family
from repro_torch.core.types import (AggOp, Answer, BoundUnreachableError,
                                    ColumnKind, ErrorBound, GroupResult,
                                    Query, QueryTemplate, TimeBound)
from repro_torch.fault import inject
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.sharding import placement as place_lib


def _scan_stream_bytes(striped: exec_lib.StripedFamily) -> int:
    """Bytes/row the fused scan streams (a trace attribute, computed only
    while a trace is active): the block's per-row tensors, the frequency
    table excluded. Reads dtypes only."""
    from repro_torch.launch import roofline
    return roofline.scan_bytes_per_row(
        [a.dtype for a in striped.columns.values()]
        + [striped.unit.dtype, striped.strat.dtype, striped.valid.dtype])


@dataclasses.dataclass
class EngineConfig:
    k1: float = 100_000.0        # largest stratification cap (paper §6.1: 1e5)
    c: float = 2.0               # resolution shrink factor
    m: int | None = None         # resolutions per family (None: log_c K1)
    uniform_fraction: float = 0.5
    max_strat_cols: int = 3      # §6.3: optimizer capped at 3 columns
    probe_resolutions: int = 2
    reuse_elp: bool = True       # cache ELP decisions per template (§4.4)
    seed: int = 0
    # A-priori ERROR WITHIN ladder rungs: escalate to larger families, then
    # fall back to an exact base-table scan.
    escalate_on_unreachable: bool = True
    exact_fallback: bool = True
    # CI machinery: "closed" = Table-2 / HT closed forms; "subsampling" =
    # VerdictDB-style variational subsampling (the point estimates from the
    # folded moments, the stderr from the spread of B replicates).
    ci_method: str = "closed"
    n_subsamples: int = est_lib.N_SUBSAMPLES
    # Where tables, sample blocks and scans live. "cuda" unless the caller
    # asks for the CPU; a missing card is an error, never a quiet CPU run.
    device: str = "cuda"
    # Fault-domain sharding (docs/FAULTS.md). Engages ONLY under an armed
    # non-empty FaultPlan: scans split into n_logical_shards disjoint
    # stratum partitions with shard_replicas attempts each, so a lost shard
    # degrades the answer (HT reweight, wider CIs) instead of failing it.
    # Without an armed plan the fused single pass runs unchanged.
    n_logical_shards: int = 4
    shard_replicas: int = 2
    straggler_deadline_s: float | None = None   # per-attempt deadline
    # Fleet placement (sharding/placement.py): logical shards get HOME
    # processes round-robin over n_processes simulated processes; replica
    # attempt r of shard s executes on process (s + r) % n_processes, so a
    # process-kill fault fails over to replicas placed elsewhere. Families
    # marked hot (mark_hot_family) run hot_replicas-long chains. Placement
    # is provenance and fault-domain metadata only.
    n_processes: int = 2
    hot_replicas: int = 3


def resolve_device(device) -> torch.device:
    """The engine's device; raises when CUDA is asked for and absent. A
    card without an index is pinned to the current one, so a thread that
    never called torch.cuda.set_device (the service's dispatcher) still
    allocates and launches on the engine's card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port runs on the card "
                           "by default; pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass
class AppendReport:
    """What one BlinkDB.append_rows ingested and what it invalidated."""
    delta: table_lib.TableDelta
    # family -> (LIVE stratum freqs before, after) with STABLE stratum ids,
    # aligned, so maintenance computes drift on the delta directly
    freqs: dict[tuple[str, ...], tuple[np.ndarray, np.ndarray]]
    restriped: list[tuple[str, ...]]   # families whose block outgrew padding
    epoch: int                         # 1-based append epoch of the table

    @property
    def merged(self) -> list[tuple[str, ...]]:
        """Families merged in place: every family has a freqs entry."""
        return list(self.freqs)


@dataclasses.dataclass
class MutationReport:
    """What one BlinkDB.delete_rows or update_rows changed."""
    mutation: table_lib.TableMutation
    # family -> (LIVE stratum freqs before, after), stable stratum ids
    freqs: dict[tuple[str, ...], tuple[np.ndarray, np.ndarray]] = \
        dataclasses.field(default_factory=dict)
    # family -> dead rows that were in the sample (now striped-block ghosts)
    tombstoned_sampled: dict[tuple[str, ...], int] = \
        dataclasses.field(default_factory=dict)
    restriped: list[tuple[str, ...]] = dataclasses.field(default_factory=list)
    # append epoch an update's re-insert took (None: a delete, or nothing
    # matched, so no delta units were drawn)
    epoch: int | None = None


@dataclasses.dataclass(frozen=True)
class ElpDecision:
    """One resolved a-priori contract decision, cached per ELP key (§4.4).
    `gen` pins the decided family's content generation."""
    phi: tuple[str, ...]
    k: float
    certified: bool | None        # None: query had no ErrorBound
    exact: bool = False           # exact base-table fallback
    predicted_half_width: float | None = None   # bound units; 0.0 for exact
    gen: int = 0


# Largest Q per fused scan launch (the kernel's scratch grows with Q);
# bigger groups run as back-to-back launches of at most this many queries.
_MAX_SCAN_BATCH = 64


@dataclasses.dataclass
class _BatchJob:
    """One conjunctive subquery's slot in a batched execution plan."""
    parent: int                   # index of the originating query
    order: int                    # disjunct order within the parent
    q: Query
    table: str
    phi: tuple[str, ...]
    consts: tuple[float, ...]     # predicate constants, flat_atoms order
    elp_key: tuple
    scan_key: tuple               # (table, phi, struct, value, group, G)
    confidence: float
    k: float | None = None        # resolved resolution cap
    certified: bool | None = None  # a-priori contract provenance
    predicted_half: float | None = None


class BlinkDB:
    def __init__(self, config: EngineConfig | None = None, device=None,
                 mesh=None, data_axes: Sequence[str] = ("data",)):
        self.config = config or EngineConfig()
        self.device = resolve_device(self.config.device if device is None
                                     else device)
        # The data mesh (None: one device). The engine's device stays its
        # own: on a one-card machine every rank scans on that card.
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        self._axes = (None if mesh is None
                      else exec_lib.mesh_axes(mesh, self.data_axes))
        # The engine's registry: what hangs off this engine (the service's
        # scheduler, cache and workload monitor, the sample maintainer)
        # registers its instruments here, so two engines in one process
        # never share counters.
        self.metrics = obs_metrics.MetricsRegistry()
        self._m_queries = self.metrics.counter(
            "engine_queries_total", "Queries executed, by execution path",
            labels=("path",))
        self._m_rows_read = self.metrics.counter(
            "engine_rows_read_total", "Sample/base rows scanned on device")
        self._m_escalations = self.metrics.counter(
            "engine_k_escalations_total",
            "ErrorBound plans escalated past the selected family (§4.2)")
        self._m_exact_fallbacks = self.metrics.counter(
            "engine_exact_fallbacks_total",
            "ErrorBound plans resolved to exact base-table scans")
        self._m_scan_seconds = self.metrics.histogram(
            "engine_scan_seconds", "Device scan wall time per fused pass")
        self._m_shards_lost = self.metrics.counter(
            "engine_shards_lost_total",
            "Logical shards lost (no surviving replica) across scans")
        self._m_shard_reroutes = self.metrics.counter(
            "engine_shard_reroutes_total",
            "Logical shards served by a replica > 0")
        self._m_shard_scans = self.metrics.counter(
            "engine_shard_scans_total",
            "Sharded-path scans by logical shard (per-shard serving load)",
            labels=("shard",))
        self._m_hot_promotions = self.metrics.counter(
            "engine_hot_promotions_total",
            "Families promoted to hot replication by the workload monitor")
        # Shard placement over the simulated process fleet: built lazily
        # per (table, family, n_logical), widened on hot marks.
        self.placements = place_lib.PlacementMap(place_lib.PlacementConfig(
            n_processes=self.config.n_processes,
            n_replicas=self.config.shard_replicas,
            hot_replicas=self.config.hot_replicas))
        self.metrics.gauge(
            "engine_hot_families", "Families under hot replication"
        ).labels().set_function(
            lambda: float(len(self.placements.hot_families())))
        if self.config.ci_method not in ("closed", "subsampling"):
            raise ValueError(f"ci_method={self.config.ci_method!r}: need "
                             "'closed' or 'subsampling'")
        self.tables: dict[str, table_lib.Table] = {}
        self.families: dict[str, dict[tuple[str, ...], samp_lib.SampleFamily]] = {}
        self._striped: dict[tuple[str, tuple[str, ...]], exec_lib.StripedFamily] = {}
        self._latency: dict[tuple[str, tuple[str, ...]], elp_lib.LatencyModel] = {}
        # (table, phi, template, value, group, G) -> scan program
        self._batched_programs: dict = {}
        self._quantile_programs: dict = {}
        self._quantile_ranges: dict = {}     # (table, phi, column) -> range
        # Variational-subsampling programs (keyed as their plain
        # counterparts, with B) and the subsampled group columns:
        # (table, phi, group column, B) -> int32 g·B + sub on the device.
        self._subsampled_programs: dict = {}
        self._batched_subsampled_programs: dict = {}
        self._subsampled_quantile_programs: dict = {}
        self._subsample_codes: dict = {}
        self._fk_maps: dict = {}      # (fact, dim, fk) -> np fk -> dim row
        self._elp_cache: dict = {}    # elp key -> ElpDecision
        self._append_epochs: dict[str, int] = {}  # table -> appends so far
        self._decay_epochs: dict[str, int] = {}   # table -> decay passes
        # Generations: one per (table, family), bumped wherever the family's
        # CONTENT changes (build, merge, tombstone, compaction, decay, join
        # refresh), and one per table for its SET of families. ELP
        # decisions are pinned to them; listeners hear every bump.
        self._generations: dict[tuple[str, tuple[str, ...]], int] = {}
        self._family_set_gen: dict[str, int] = {}
        self._invalidation_listeners: list[
            Callable[[str, tuple[str, ...] | None], None]] = []
        self.last_solution: opt_lib.Solution | None = None

    # ------------------------------------------------ generations & hooks
    def family_generation(self, table_name: str, phi: tuple[str, ...]) -> int:
        """Monotone content version of one sample family (0 = never built)."""
        return self._generations.get((table_name, phi), 0)

    def family_set_generation(self, table_name: str) -> int:
        """Monotone version of the SET of families on a table: bumps when a
        family is added or dropped."""
        return self._family_set_gen.get(table_name, 0)

    def add_invalidation_listener(
            self, fn: Callable[[str, tuple[str, ...] | None], None]) -> None:
        """Subscribe to generation bumps: `fn(table, phi)` fires on every
        family-content change, `fn(table, None)` on family-set changes.
        Listeners must not call back into the engine."""
        self._invalidation_listeners.append(fn)

    def remove_invalidation_listener(
            self, fn: Callable[[str, tuple[str, ...] | None], None]) -> None:
        """Unsubscribe (a no-op if not subscribed)."""
        try:
            self._invalidation_listeners.remove(fn)
        except ValueError:
            pass

    def _bump_generation(self, table_name: str,
                         phi: tuple[str, ...] | None) -> None:
        if phi is None:
            self._family_set_gen[table_name] = \
                self._family_set_gen.get(table_name, 0) + 1
        else:
            key = (table_name, phi)
            self._generations[key] = self._generations.get(key, 0) + 1
        for fn in self._invalidation_listeners:
            fn(table_name, phi)

    def _drop_programs(self, table_name: str, phi: tuple[str, ...]) -> None:
        """Forget everything calibrated against a (table, family)'s block
        but the block itself: scan programs, ELP decisions, latency models,
        quantile histogram ranges and subsampled group columns (a K chosen
        for the old sample need not meet the bound on the new one)."""
        for cache in (self._batched_programs, self._quantile_programs,
                      self._quantile_ranges, self._subsampled_programs,
                      self._batched_subsampled_programs,
                      self._subsampled_quantile_programs,
                      self._subsample_codes, self._elp_cache, self._latency):
            for k in [k for k in cache
                      if k[0] == table_name and k[1] == phi]:
                del cache[k]

    def _drop_derived(self, table_name: str, phi: tuple[str, ...]) -> None:
        """_drop_programs, and the family's striped block."""
        self._striped.pop((table_name, phi), None)
        self._drop_programs(table_name, phi)

    def _set_striped(self, table_name: str, phi: tuple[str, ...],
                     striped: exec_lib.StripedFamily) -> None:
        """Install a patched or rebuilt block. The subsampled scans' group
        column g·B + sub is computed from the block's group column VALUES,
        so it is dropped with every block it was computed from."""
        self._striped[(table_name, phi)] = striped
        for k in [k for k in self._subsample_codes
                  if k[0] == table_name and k[1] == phi]:
            del self._subsample_codes[k]

    # ------------------------------------------------------------- offline
    def register_table(self, name: str, tbl: table_lib.Table) -> None:
        """Register a table and put its columns on the engine's device (the
        exact scan reads them there). Registering another table under a
        name in use keeps the name's families, as the reference does (the
        maintainer's replacement epoch relies on it), and drops what was
        derived from the old table: striped blocks, programs, ELP
        decisions, latency models, quantile ranges, subsampled group
        columns and fk maps; it bumps every family's generation and the
        family-set generation, and strips the join columns gathered from
        the old table where it served as a dimension."""
        if name in self.tables and self.tables[name] is not tbl:
            self._invalidate_table(name)
        self.tables[name] = tbl.to(self.device)
        self.families.setdefault(name, {})

    def _invalidate_table(self, name: str) -> None:
        for cache in (self._striped, self._latency, self._batched_programs,
                      self._quantile_programs, self._quantile_ranges,
                      self._subsampled_programs,
                      self._batched_subsampled_programs,
                      self._subsampled_quantile_programs,
                      self._subsample_codes, self._elp_cache):
            for k in [k for k in cache if k[0] == name]:
                del cache[k]
        for k in [k for k in self._fk_maps if name in k[:2]]:
            del self._fk_maps[k]
        for phi in self.families.get(name, {}):
            self._bump_generation(name, phi)
        self._bump_generation(name, None)
        self._invalidate_as_dimension(name)

    def _invalidate_as_dimension(self, name: str) -> None:
        """If `name` serves as a dimension, fact tables and their families
        hold gathered "name.col" columns whose codes refer to the OLD
        dictionary: strip them so _resolve_joins regathers on next use, and
        bump the generation of every family that held one."""
        prefix = name + "."
        for fact_name, fact in self.tables.items():
            for c in [c for c in fact.columns_host if c.startswith(prefix)]:
                del fact.columns_host[c]
                fact.columns.pop(c, None)
            for p, fam in self.families.get(fact_name, {}).items():
                stale = [c for c in fam.columns_host if c.startswith(prefix)]
                for c in stale:
                    del fam.columns_host[c]
                if stale:
                    self._drop_derived(fact_name, p)
                    self._bump_generation(fact_name, p)

    def candidate_stats(self, table_name: str
                        ) -> Callable[[frozenset[str]], tuple[float, float, float]]:
        """stats(phi) -> (Store(φ), |D(φ)|, Δ(φ)) from table statistics,
        over the LIVE rows: a stratum whose rows are all dead counts neither
        in |D(φ)| nor in the tail length Δ(φ)."""
        tbl = self.tables[table_name]
        k1 = self.config.k1

        def stats(phi: frozenset[str]):
            codes, _ = table_lib.combined_codes(tbl, sorted(phi))
            nd = int(codes.max()) + 1 if len(codes) else 0
            if tbl.live is not None:
                codes = codes[tbl.live]
            freqs = table_lib.stratum_frequencies(codes, nd)
            storage = samp_lib.expected_sample_rows(freqs, k1) * \
                (tbl.row_bytes() + 8)
            nd_live = float(((freqs > 0).sum()) if tbl.live is not None
                            else nd)
            delta = float(((freqs > 0) & (freqs < k1)).sum())
            return storage, nd_live, delta
        return stats

    def build_samples(self, table_name: str,
                      templates: Sequence[QueryTemplate],
                      storage_budget_fraction: float = 0.5,
                      change_fraction: float = 1.0,
                      exact: bool = False,
                      seed: int | None = None,
                      units: Mapping[tuple[str, ...], np.ndarray] | None = None
                      ) -> opt_lib.Solution:
        """Offline sample creation (§2.2.1): solve §3.2, drop the families
        the solution no longer wants, build the new ones in sorted φ order,
        and keep the always-present uniform family. `seed` overrides the
        config seed for this build only; `units` maps φ (() for the uniform
        family) to per-row priorities, and a φ it lacks draws from the
        seed."""
        seed = self.config.seed if seed is None else seed
        units = units or {}
        tbl = self.tables[table_name]
        # A template's own column set is also a candidate: compute each φ's
        # statistics (a pass over the whole table) once.
        stats = functools.lru_cache(maxsize=None)(
            self.candidate_stats(table_name))
        cands = opt_lib.enumerate_candidates(templates, stats,
                                             self.config.max_strat_cols)
        deltas, distincts = [], []
        for t in templates:
            _, nd, dl = stats(t.columns)
            deltas.append(dl)
            distincts.append(nd)
        wl = opt_lib.Workload(tuple(templates), tuple(deltas),
                              tuple(distincts))
        budget = storage_budget_fraction * tbl.row_bytes() * tbl.n_live
        fams = self.families.setdefault(table_name, {})
        existing = frozenset(frozenset(p) for p in fams if p)
        solver = opt_lib.solve_exact if exact else opt_lib.solve_greedy
        sol = solver(cands, wl, budget, existing=existing,
                     change_fraction=change_fraction)
        self.last_solution = sol

        wanted = {tuple(sorted(c.phi)) for c in sol.chosen}
        current = {p for p in fams if p}
        for phi in current - wanted:
            del fams[phi]
            self._drop_derived(table_name, phi)
            self._bump_generation(table_name, phi)
        for phi in sorted(wanted - current):
            self._install_family(table_name, phi, seed, units.get(phi))
        set_changed = bool((current - wanted) or (wanted - current))
        if () not in fams:
            self._install_family(table_name, (), seed, units.get(()))
            set_changed = True
        if set_changed:
            self._bump_generation(table_name, None)
        return sol

    def add_family(self, table_name: str, phi: Sequence[str],
                   seed: int | None = None,
                   units: np.ndarray | None = None) -> None:
        """Add (or rebuild) a family. `seed` overrides the config seed;
        `units` overrides the per-row priorities outright (see
        repro_torch.state, which carries the reference's units across)."""
        seed = self.config.seed if seed is None else seed
        phi_t = tuple(sorted(phi))
        is_new = phi_t not in self.families.setdefault(table_name, {})
        self._install_family(table_name, phi_t, seed, units)
        if is_new:
            self._bump_generation(table_name, None)

    def _install_family(self, table_name: str, phi: tuple[str, ...],
                        seed: int, units: np.ndarray | None) -> None:
        """Build family φ (the uniform one for φ = ()) and put it in place
        of any earlier one: its derived state drops, its generation bumps."""
        tbl = self.tables[table_name]
        if phi == ():
            fam = samp_lib.build_uniform_family(
                tbl, self.config.uniform_fraction, self.config.c,
                self.config.m, seed=seed, units=units)
        else:
            fam = samp_lib.build_family(tbl, phi, self.config.k1,
                                        self.config.c, self.config.m,
                                        seed=seed, units=units)
        self.families.setdefault(table_name, {})[phi] = fam
        self._drop_derived(table_name, phi)
        self._bump_generation(table_name, phi)

    # ------------------------------------------------------------ mutation
    def append_rows(self, table_name: str, raw: Mapping[str, np.ndarray],
                    seed: int | None = None) -> AppendReport:
        """Append-only ingestion with delta-based sample maintenance
        (§3.2.3/§4.5): encode the delta against the existing dictionaries,
        merge every family in place (exact HT rates under the grown
        frequencies, sampling.merge_family), and scatter only the kept
        delta rows into the striped blocks.

        Invalidation follows docs/MAINTENANCE.md's matrix: a family whose
        block outgrew its padding (or a narrow dtype) is restriped and its
        programs, ELP decisions and latency model drop; programs grouped by
        a column whose dictionary grew drop; quantile ranges drop; other
        ELP decisions and latency models are kept (their families'
        generations bump, which retires the decisions pinned to them).
        """
        tbl = self.tables[table_name]
        epoch = self._append_epochs.get(table_name, 0) + 1
        self._append_epochs[table_name] = epoch
        unit_seed = self.config.seed if seed is None else seed
        self._pre_delta_invalidation(table_name)
        delta = tbl.append(raw)
        self._post_delta_invalidation(table_name, delta)
        freqs, restriped = self._merge_delta_into_families(
            table_name, delta, epoch, unit_seed)
        return AppendReport(delta, freqs, restriped, epoch)

    def _pre_delta_invalidation(self, table_name: str) -> None:
        """Before a delta lands: gathered join attributes cannot ride a
        schema-only delta (the table strips its own in Table.append), so
        strip the families' copies (regathered on next use); where this
        table serves as a dimension, its fact tables' fk maps and gathered
        columns go stale."""
        for phi, fam in self.families.get(table_name, {}).items():
            gathered = [c for c in fam.columns_host if "." in c]
            for c in gathered:
                del fam.columns_host[c]
            if gathered:
                self._drop_derived(table_name, phi)
        for k in [k for k in self._fk_maps if k[1] == table_name]:
            del self._fk_maps[k]
        self._invalidate_as_dimension(table_name)

    def _post_delta_invalidation(self, table_name: str,
                                 delta: table_lib.TableDelta) -> None:
        """After a delta landed (an append or an update's re-insert): fk
        maps where this table is the fact are sized by the fk column's
        dictionary, stale once it grew; the quantile ranges may no longer
        hold the value columns; programs grouped by a column whose
        dictionary grew are keyed by the old group count and unreachable."""
        for k in [k for k in self._fk_maps
                  if k[0] == table_name
                  and len(delta.new_dict_values.get(k[2], ()))]:
            del self._fk_maps[k]
        for k in [k for k in self._quantile_ranges if k[0] == table_name]:
            del self._quantile_ranges[k]
        for col, vals in delta.new_dict_values.items():
            if not len(vals):
                continue
            for cache in (self._batched_programs, self._quantile_programs,
                          self._subsampled_programs,
                          self._batched_subsampled_programs,
                          self._subsampled_quantile_programs):
                for k in [k for k in cache
                          if k[0] == table_name and k[4] == col]:
                    del cache[k]

    def _merge_delta_into_families(self, table_name: str,
                                   delta: table_lib.TableDelta, epoch: int,
                                   unit_seed: int):
        """Merge a landed delta into every family in place and patch the
        striped blocks (one delta-unit draw per stream, shared by every
        family on it) → (freqs, restriped)."""
        fams = self.families.get(table_name, {})
        strat_units = samp_lib.delta_units(delta.n_rows, unit_seed, epoch)
        unif_units = samp_lib.delta_units(delta.n_rows, unit_seed, epoch,
                                          uniform=True)
        freqs: dict[tuple[str, ...], tuple[np.ndarray, np.ndarray]] = {}
        restriped: list[tuple[str, ...]] = []
        for phi, fam in list(fams.items()):
            old_freqs = fam.live_freqs
            if phi == ():
                # The uniform family keeps K_1 = p·N as N grows, N the
                # PHYSICAL (inclusion) count: every row's rate stays
                # exactly p through any delete/append interleaving.
                n_phys = max(int(fam.stratum_freqs[0]), 1)
                frac = fam.ks[0] / n_phys
                merged, block = samp_lib.merge_family(
                    fam, delta.columns, unif_units,
                    new_k1=frac * (n_phys + delta.n_rows),
                    c=self.config.c, start_row=delta.start_row)
            else:
                merged, block = samp_lib.merge_family(
                    fam, delta.columns, strat_units, c=self.config.c,
                    start_row=delta.start_row)
            fams[phi] = merged
            freqs[phi] = (old_freqs, merged.live_freqs)
            self._bump_generation(table_name, phi)
            striped = self._striped.get((table_name, phi))
            if striped is not None:
                upd = exec_lib.stripe_append(striped, merged, block)
                if upd is None:   # outgrew its padding or a narrow dtype
                    self._set_striped(table_name, phi, self._stripe(merged))
                    self._drop_programs(table_name, phi)
                    restriped.append(phi)
                else:
                    self._set_striped(table_name, phi, upd)
        return freqs, restriped

    def delete_rows(self, table_name: str, predicate) -> MutationReport:
        """Delete (tombstone) every live row matching `predicate` while the
        families keep serving: the table marks the rows dead in place, each
        family drops its sampled copies on the host and ghosts their slots
        in its striped block; live stratum counts drop, inclusion
        frequencies (and every surviving row's key and HT rate) stay.
        Programs, ELP decisions and latency models are kept; join state is
        refreshed where this table serves as a dimension."""
        tbl = self.tables[table_name]
        mutation = tbl.delete(predicate)
        report = MutationReport(mutation)
        if mutation.n_tombstoned == 0:
            return report
        self._apply_tombstones_to_families(table_name, mutation, report)
        for k in [k for k in self._fk_maps if k[1] == table_name]:
            del self._fk_maps[k]
        self._invalidate_as_dimension(table_name)
        return report

    def update_rows(self, table_name: str, predicate, assignments,
                    seed: int | None = None) -> MutationReport:
        """Update matching live rows: tombstone the old versions and ingest
        the new ones as an ordinary append delta, through the whole merge
        and scatter path and the append's invalidation."""
        tbl = self.tables[table_name]
        unit_seed = self.config.seed if seed is None else seed
        mutation = tbl.update(predicate, assignments)
        report = MutationReport(mutation)
        if mutation.n_tombstoned == 0:
            return report   # nothing matched: invalidate nothing
        self._pre_delta_invalidation(table_name)
        self._apply_tombstones_to_families(table_name, mutation, report)
        epoch = self._append_epochs.get(table_name, 0) + 1
        self._append_epochs[table_name] = epoch
        report.epoch = epoch
        self._post_delta_invalidation(table_name, mutation.delta)
        freqs, restriped = self._merge_delta_into_families(
            table_name, mutation.delta, epoch, unit_seed)
        report.restriped = restriped
        for phi, (_, after) in freqs.items():
            before = report.freqs.get(phi, (after, after))[0]
            report.freqs[phi] = (before, after)
        return report

    def _apply_tombstones_to_families(self, table_name: str, mutation,
                                      report: MutationReport) -> None:
        fams = self.families.get(table_name, {})
        for phi, fam in list(fams.items()):
            fam2, tblock = samp_lib.apply_tombstones(
                fam, mutation.tombstoned, mutation.tombstoned_columns)
            fams[phi] = fam2
            report.freqs[phi] = (fam.live_freqs, fam2.live_freqs)
            report.tombstoned_sampled[phi] = tblock.n_sampled
            self._bump_generation(table_name, phi)
            striped = self._striped.get((table_name, phi))
            if striped is not None:
                self._set_striped(table_name, phi, exec_lib.stripe_tombstone(
                    striped, tblock.row_ids, table_rows=fam2.table_rows))

    # ------------------------------------------------- ghost-slot compaction
    def ghost_fractions(self, table_name: str) -> dict[tuple[str, ...], float]:
        """Per-family ghost share of the striped blocks (the compaction
        trigger)."""
        return {phi: s.ghost_fraction
                for (t, phi), s in self._striped.items() if t == table_name}

    def compact_family(self, table_name: str, phi: tuple[str, ...]) -> bool:
        """Compacting restripe: rebuild the family's block from the
        ghost-free host family with the old block's slot count pinned, so
        its shape class normally survives; if it does not, the family's
        programs, ELP decisions and latency model drop. True if a block was
        compacted."""
        striped = self._striped.get((table_name, phi))
        if striped is None:
            return False   # nothing striped: the next stripe is compact
        fam = self.families[table_name][phi]
        fresh = self._stripe(fam, min_local=striped.n_local)
        self._set_striped(table_name, phi, fresh)
        if fresh.shape_class != striped.shape_class:
            self._drop_programs(table_name, phi)
        self._bump_generation(table_name, phi)
        return True

    # --------------------------------------------- storage reclamation epochs
    def dead_fraction(self, table_name: str) -> float:
        """Share of the base table's physical rows that are tombstoned (the
        base-compaction trigger)."""
        tbl = self.tables[table_name]
        return 1.0 - tbl.n_live / max(tbl.n_rows, 1)

    def compact_table(self, table_name: str
                      ) -> table_lib.TableCompaction | None:
        """Base-table compaction: physically drop the tombstoned rows and
        ship the old → new row-id remap to every layer keyed on physical
        ids. Sample content is untouched, so families re-key `row_ids` and
        blocks `slot_row_ids`, host mirrors only: nothing moves on the
        device. Inclusion frequencies keep counting the reclaimed rows (only
        decay resets them). Every family's generation bumps; fk maps drop
        where this table serves as a dimension. Returns the
        TableCompaction, None when nothing was reclaimed."""
        tbl = self.tables[table_name]
        fams = self.families.get(table_name, {})
        # Validate before the table changes: a family that cannot be
        # remapped must fail the epoch with the engine untouched.
        for phi, fam in fams.items():
            if (fam.row_ids < 0).any():
                raise ValueError(
                    f"family {phi!r} has sentinel row_ids — rebuild it to "
                    "enable base compaction")
        comp = tbl.compact()
        if comp is None:
            return None
        for phi, fam in list(fams.items()):
            fams[phi] = samp_lib.remap_family_row_ids(fam, comp.remap)
            self._bump_generation(table_name, phi)
            striped = self._striped.get((table_name, phi))
            if striped is not None:
                self._set_striped(table_name, phi, exec_lib.remap_slot_row_ids(
                    striped, comp.remap))
        for k in [k for k in self._fk_maps if k[1] == table_name]:
            del self._fk_maps[k]
        self._invalidate_as_dimension(table_name)
        return comp

    def decay_family(self, table_name: str, phi: tuple[str, ...],
                     strata, seed: int | None = None
                     ) -> samp_lib.DecayBlock | None:
        """Inclusion-frequency decay of one family: reset the named
        strata's inclusion frequencies to their live counts and resample
        them from the base table (sampling.decay_strata) under units of the
        table's decay stream, deterministic in (seed, decay epoch). The
        block is rebuilt with its slot count pinned; if its shape class
        changes anyway, the family's programs, ELP decisions and latency
        model drop. Returns the DecayBlock (None for no strata)."""
        strata = np.unique(np.asarray(strata, dtype=np.int64))
        if not strata.size:
            return None
        tbl = self.tables[table_name]
        phi = tuple(phi)
        fam = self.families[table_name][phi]
        # Gathered join attributes cannot be resampled from the base table.
        gathered = [c for c in fam.columns_host if "." in c]
        for c in gathered:
            del fam.columns_host[c]
        epoch = self._decay_epochs.get(table_name, 0) + 1
        self._decay_epochs[table_name] = epoch
        unit_seed = self.config.seed if seed is None else seed
        units = samp_lib.decay_units(tbl.n_rows, unit_seed, epoch)
        new_fam, block = samp_lib.decay_strata(fam, tbl, strata, units)
        block.epoch = epoch
        self.families[table_name][phi] = new_fam
        self._bump_generation(table_name, phi)
        striped = self._striped.get((table_name, phi))
        if striped is not None:
            fresh = self._stripe(new_fam, min_local=striped.n_local)
            self._set_striped(table_name, phi, fresh)
            if fresh.shape_class != striped.shape_class:
                self._drop_programs(table_name, phi)
        elif gathered:
            self._drop_programs(table_name, phi)
        return block

    def storage_stats(self, table_name: str) -> dict:
        """Host-side storage accounting of a table (§3.2 budget arithmetic,
        docs/MAINTENANCE.md): live base bytes, the dead base bytes that
        tombstoned rows still hold, sample bytes, and the ghost sample
        bytes dead slots still occupy in striped blocks."""
        tbl = self.tables[table_name]
        rb = tbl.row_bytes()
        sample_rb = rb + 8
        sample_rows = sum(f.n_rows
                          for f in self.families.get(table_name, {}).values())
        ghost_rows = sum(s.n_ghosts for (t, _), s in self._striped.items()
                         if t == table_name)
        return {"live_bytes": rb * tbl.n_live,
                "dead_base_bytes": rb * (tbl.n_rows - tbl.n_live),
                "sample_bytes": sample_rb * sample_rows,
                "ghost_sample_bytes": sample_rb * ghost_rows,
                "dead_bytes": rb * (tbl.n_rows - tbl.n_live)
                + sample_rb * ghost_rows}

    # ------------------------------------------- fault domains and placement
    def _fault_sharding_active(self) -> bool:
        """Engagement rule for the sharded scan path: an armed, NON-EMPTY
        FaultPlan and more than one configured logical shard. Off otherwise,
        so the single fused pass and its bit-exact summation order serve
        every fault-free query (docs/FAULTS.md)."""
        plan = inject.active()
        return (plan is not None and bool(plan)
                and self.config.n_logical_shards > 1)

    def _placement_for(self, table_name: str, phi: tuple[str, ...]
                       ) -> place_lib.FamilyPlacement:
        return self.placements.for_family(table_name, phi,
                                          self.config.n_logical_shards)

    def _set_placement_attrs(self, sp, table_name: str,
                             phi: tuple[str, ...], fam, struct,
                             consts_list) -> None:
        """Scan-span placement provenance (docs/OBSERVABILITY.md): the
        family's placement over the process fleet, and the routed shard
        subset when the template pins every φ column by equality
        (placement.route_shard_set; provenance only, the sharded scan
        always runs every shard so clean answers keep their bits).
        `consts_list` holds each query's flat constants."""
        pl = self._placement_for(table_name, phi)
        route = place_lib.route_shard_set(
            fam.strata_keys, phi, struct, list(consts_list),
            self.config.n_logical_shards)
        sp.set(placement=pl.span_attrs(),
               shard_set=("all" if route is None else list(route)))

    def _count_shard_report(
            self, report: exec_lib.ShardScanReport | None) -> None:
        if report is None:
            return
        self._m_shards_lost.inc(len(report.lost))
        self._m_shard_reroutes.inc(len(report.rerouted))
        for s in range(report.n_shards):
            if s not in report.lost:
                self._m_shard_scans.labels(str(s)).inc()

    def mark_hot_family(self, table_name: str, phi: tuple[str, ...]
                        ) -> bool:
        """Promote one family to hot replication: its shard placement is
        rebuilt with the longer `hot_replicas` chain, widening fail-over
        (replicas are re-executions, so this changes the fault path only,
        never which strata a shard owns, never a clean answer). Driven by
        the service's workload monitor; True on first promotion."""
        phi = tuple(phi)
        if phi not in self.families.get(table_name, {}):
            return False
        newly = self.placements.mark_hot(table_name, phi)
        if newly:
            self._m_hot_promotions.inc()
        return newly

    def _observe_scan(self, dt: float, rows: int) -> None:
        self._m_scan_seconds.observe(dt)
        self._m_rows_read.inc(rows)

    # ------------------------------------------------------------- runtime
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _n_shards(self) -> int:
        """Data shards of the mesh (the product of its data axes' sizes);
        1 without a mesh."""
        return 1 if self._axes is None else self._axes.n_shards

    def _shard(self) -> int:
        """This rank's data shard; 0 without a mesh."""
        return 0 if self._axes is None else self._axes.shard

    def _stripe(self, fam: samp_lib.SampleFamily,
                min_local: int | None = None) -> exec_lib.StripedFamily:
        """The rank's stripe of a family on the engine's device."""
        return exec_lib.stripe_family(fam, self.device, self._n_shards(),
                                      self._shard(), min_local=min_local)

    def _mesh_kw(self) -> dict:
        return {"mesh": self.mesh, "data_axes": self.data_axes}

    def _striped_for(self, table_name: str,
                     phi: tuple[str, ...]) -> exec_lib.StripedFamily:
        key = (table_name, phi)
        if key not in self._striped:
            self._striped[key] = self._stripe(self.families[table_name][phi])
        return self._striped[key]

    def _table_of(self, table_name: str, col: str
                  ) -> tuple[table_lib.Table, str]:
        """(table, column) holding `col`: a joined attribute "dim.col" lives
        on the dimension table."""
        if "." in col:
            dim_name, dim_col = col.split(".", 1)
            return self.tables[dim_name], dim_col
        return self.tables[table_name], col

    def _encode(self, table_name: str):
        def encode(col: str, value):
            tbl, c = self._table_of(table_name, col)
            if tbl.schema.column(c).kind is ColumnKind.CATEGORICAL:
                return tbl.encode_value(c, value)
            return float(value)
        return encode

    def _column_card(self, table_name: str, col: str) -> int:
        tbl, c = self._table_of(table_name, col)
        return tbl.cardinality(c)

    def _decode_col_value(self, table_name: str, col: str, code: int):
        tbl, c = self._table_of(table_name, col)
        return tbl.decode_value(c, code)

    # ------------------------------------------------------------ joins
    def _resolve_joins(self, table_name: str, q: Query) -> None:
        """Materialize the joined dimension attributes q names as extra
        columns "dim.col" of the fact table (the exact path) and of every
        family of it (the sampled path): §2.1 case ii, the dimension fits
        in memory and the join is a gather. A family that gains a column
        is restriped at its next scan, and its derived state dropped."""
        if not q.joins:
            return
        wanted = [c for c in (q.where_group_columns |
                              ({q.value_column} if q.value_column else set()))
                  if "." in c]
        if not wanted:
            return
        fact = self.tables[table_name]
        by_dim = {j.dim_table: j for j in q.joins}
        for col in sorted(wanted):
            dim_name, dim_col = col.split(".", 1)
            join = by_dim[dim_name]
            dim = self.tables[dim_name]
            mkey = (table_name, dim_name, join.fact_key)
            if mkey not in self._fk_maps:
                self._fk_maps[mkey] = join_lib.build_fk_map(fact, dim, join)
            fk_map = self._fk_maps[mkey]
            if col not in fact.columns_host:
                fact.columns[col] = join_lib.gather_dim_column(
                    fk_map, dim, dim_col, fact.columns[join.fact_key])
                fact.columns_host[col] = fact.columns[col].cpu().numpy()
            for p, fam in self.families[table_name].items():
                if col not in fam.columns_host:
                    fam.columns_host[col] = join_lib.gather_dim_column(
                        fk_map, dim, dim_col,
                        fam.host_column(join.fact_key))
                    self._drop_derived(table_name, p)

    def _run_at_k(self, table_name: str, q: Query, phi: tuple[str, ...],
                  k: float) -> tuple[est_lib.GroupedMoments, int, float,
                                     exec_lib.ShardScanReport | None]:
        """One fused scan at resolution k: the batched scan at Q = 1, timed
        with the device synchronised (the WITHIN SECONDS latency model is
        fitted on these times). Under an armed fault plan it runs
        shard-partitioned and the report carries the loss provenance;
        otherwise the report is None."""
        key, vals = self._scan_key(table_name, q, phi)
        mom, dt, report, rows = self._batched_scan(
            key, [k], [exec_lib.flatten_pred_vals(vals)], False)
        return est_lib.moments_slice(mom, 0), rows, dt, report

    def _scan_key(self, table_name: str, q: Query, phi: tuple[str, ...]
                  ) -> tuple[tuple, tuple]:
        """(program key (table, phi, struct, value, group, G), the query's
        nested predicate constants)."""
        bound_pred = exec_lib.bind_predicate(q.predicate, self._encode(table_name))
        struct, vals = exec_lib.pred_structure(bound_pred)
        group_col = q.group_by[0] if q.group_by else None
        n_groups = self._column_card(table_name, group_col) if group_col else 1
        return (table_name, phi, struct, q.value_column, group_col,
                n_groups), vals

    def _answer_from_moments(self, q: Query, table_name: str,
                             phi: tuple[str, ...], k: float,
                             mom: est_lib.GroupedMoments, rows_read: int,
                             elapsed: float, confidence: float,
                             faults: exec_lib.ShardScanReport | None = None,
                             qpair=None, certified: bool | None = None,
                             predicted_half_width: float | None = None,
                             est: est_lib.Estimate | None = None) -> Answer:
        """An Answer from a scan's moments; `est` is the estimate when the
        caller has it (the subsampled scans), else it is computed here.
        `faults` is the sharded scan's report: a lost shard makes the
        answer degraded."""
        tbl = self.tables[table_name]
        degraded = faults is not None and faults.degraded
        with obs_trace.span("estimate", agg=q.agg.name,
                            degraded=bool(degraded)):
            if est is None:
                est = self._estimate_for(q, table_name, phi, k, mom, qpair)
            stderr, lo, hi = est_lib.ci(est, confidence)
        group_col = q.group_by[0] if q.group_by else None
        vals = est.value.cpu().numpy()
        errs = stderr.cpu().numpy()
        los, his = lo.cpu().numpy(), hi.cpu().numpy()
        wsum = mom.wsum.cpu().numpy()
        nsel = mom.n.cpu().numpy()
        groups = []
        realized_half = 0.0   # worst realized CI half-width, bound units
        for g in range(len(vals)):
            if nsel[g] == 0 and wsum[g] == 0:
                continue  # missing subgroup (paper §3.1 "subset error")
            key = ((self._decode_col_value(table_name, group_col, g),)
                   if group_col else ())
            # A degraded answer never claims exactness: the stratum may be
            # whole among the SURVIVORS yet miss lost-shard rows.
            exact = (not degraded and
                     bool(abs(nsel[g] - wsum[g]) < 1e-6 * max(wsum[g], 1.0)))
            if not exact and isinstance(q.bound, ErrorBound):
                half = est_lib.z_value(confidence) * float(errs[g])
                if q.bound.relative:
                    half = (abs(half / vals[g]) if vals[g]
                            else (0.0 if half == 0.0 else float("inf")))
                realized_half = max(realized_half, half)
            groups.append(GroupResult(key, float(vals[g]), float(errs[g]),
                                      float(los[g]), float(his[g]),
                                      float(nsel[g]), exact))
        # Contract verdict: certified a-priori AND realized post-hoc; a
        # degraded scan's wider CIs can demote a certified answer.
        bound_met = None
        if isinstance(q.bound, ErrorBound):
            bound_met = bool(certified
                             and realized_half <= q.bound.eps + 1e-12)
        return Answer(q, groups, phi, k, rows_read, tbl.n_live, elapsed,
                      confidence, degraded=degraded,
                      shards_lost=len(faults.lost) if faults else 0,
                      shards_total=faults.n_shards if faults else 0,
                      bound_met=bound_met, certified=certified,
                      predicted_half_width=predicted_half_width)

    def _family_range(self, table_name: str, phi: tuple[str, ...],
                      value_col: str | None) -> tuple[float, float]:
        """Host-cached [min, max] (float32) of a family's value column: the
        fixed histogram range of the quantile scan. Dropped with the
        family's other derived state."""
        key = (table_name, phi, value_col)
        rng = self._quantile_ranges.get(key)
        if rng is None:
            fam = self.families[table_name][phi]
            if value_col is None:
                rng = (0.0, 1.0)  # COUNT-style: values are all ones
            else:
                col = np.asarray(fam.host_column(value_col), np.float32)
                rng = ((float(np.min(col)), float(np.max(col)))
                       if col.size else (0.0, 1.0))
            self._quantile_ranges[key] = rng
        return rng

    def _quantile_scan(self, q: Query, table_name: str, phi: tuple[str, ...],
                       k: float) -> tuple[est_lib.GroupedMoments,
                                          tuple[torch.Tensor, torch.Tensor]]:
        """ONE quantile-scan launch producing the grouped moments and the
        histogram quantile (value, density) over the family's range (the
        selected rows' range for a template of 126 atoms or more)."""
        striped = self._striped_for(table_name, phi)
        key, vals = self._scan_key(table_name, q, phi)
        pkey = key + (self._n_shards(),)
        fn = self._quantile_programs.get(pkey)
        if fn is None:
            fn = exec_lib.make_quantile_fn(*key[2:], **self._mesh_kw())
            self._quantile_programs[pkey] = fn
        lo, hi = self._family_range(table_name, phi, q.value_column)
        mom, qv, dens = fn(k, vals, q.quantile, lo, hi,
                           *exec_lib.scan_args(striped))
        return mom, (qv, dens)

    def _run_quantile_at_k(self, table_name: str, q: Query,
                           phi: tuple[str, ...], k: float):
        """QUANTILE analogue of _run_at_k, timed the same way (device
        synchronised): → (mom, rows_read, dt, qpair). Callers keep it off
        the fault-sharded path."""
        fam = self.families[table_name][phi]
        inject.site("engine.scan", table=table_name)
        with obs_trace.span("scan", table=table_name, k=float(k),
                            quantile=True) as sp:
            self._sync()
            t0 = time.perf_counter()
            mom, qpair = self._quantile_scan(q, table_name, phi, k)
            self._sync()
            dt = time.perf_counter() - t0
            rows = fam.prefix_for_k(k)
            sp.set(rows_read=rows, elapsed_s=dt)
        self._observe_scan(dt, rows)
        return mom, rows, dt, qpair

    def _estimate_for(self, q: Query, table_name: str, phi: tuple[str, ...],
                      k: float, mom: est_lib.GroupedMoments,
                      qpair=None) -> est_lib.Estimate:
        """Estimate from moments. QUANTILE also needs the histogram
        quantile: `qpair` when the caller's scan produced it, else one
        quantile scan at k supplies it (its moments are discarded)."""
        if q.agg is not AggOp.QUANTILE:
            return est_lib.estimate(q.agg, mom)
        if qpair is None:
            _, qpair = self._quantile_scan(q, table_name, phi, k)
        return est_lib.estimate(AggOp.QUANTILE, mom, quantile_value=qpair[0],
                                quantile_density=qpair[1], q=q.quantile)

    def _scan_for_query(self, table_name: str, q: Query,
                        phi: tuple[str, ...], k: float):
        """One scan at k → (mom, rows_read, dt, fault report, qpair): on the
        clean path a QUANTILE query runs the one-pass quantile scan (report
        None); every other aggregate, and the fault-sharded path (whose
        per-shard partials are plain moments), runs the fused scan (qpair
        None: a QUANTILE's histogram then comes from one unsharded quantile
        scan in _estimate_for)."""
        if q.agg is AggOp.QUANTILE and not self._fault_sharding_active():
            mom, rows, dt, qpair = self._run_quantile_at_k(table_name, q,
                                                           phi, k)
            return mom, rows, dt, None, qpair
        return self._run_at_k(table_name, q, phi, k) + (None,)

    # ------------------------------------- variational subsampling CIs
    def _subsample_codes_for(self, table_name: str, phi: tuple[str, ...],
                             striped: exec_lib.StripedFamily,
                             group_col: str | None) -> torch.Tensor:
        """The subsampled scans' int32 group column g·B + sub over a
        family's striped block (sub alone when ungrouped; on a mesh the
        rank's row of the reference's [S, n_local] codes), cached per
        (table, family, group column, B) and dropped with the block."""
        b = self.config.n_subsamples
        key = (table_name, phi, group_col, b)
        gsub = self._subsample_codes.get(key)
        if gsub is None or gsub.shape != striped.unit.shape:
            if group_col is None:
                gsub = torch.from_numpy(exec_lib.subsample_codes(
                    self._n_shards(), striped.n_local, b)[self._shard()]
                ).to(self.device)
            else:
                gsub = exec_lib.subsample_group_column(
                    striped.columns[group_col],
                    self._subsample_codes_for(table_name, phi, striped, None),
                    b)
            self._subsample_codes[key] = gsub
        return gsub

    def _subsampled_answer(self, q: Query, table_name: str,
                           phi: tuple[str, ...], k: float, confidence: float,
                           certified: bool | None = None,
                           predicted_half_width: float | None = None
                           ) -> Answer:
        """Scan at K with per-subsample segments (ci_method="subsampling"):
        the point estimates come from the FOLDED moments, the CI from the
        spread of the B replicate estimates. COUNT/SUM/AVG launch the fused
        scan (the wide path's agg_scan over 127 atoms) with the G·B group
        column; QUANTILE two quantile scans over the selection."""
        fam = self.families[table_name][phi]
        striped = self._striped_for(table_name, phi)
        key, vals = self._scan_key(table_name, q, phi)
        group_col, n_groups = key[4], key[5]
        b = self.config.n_subsamples
        gsub = self._subsample_codes_for(table_name, phi, striped, group_col)
        pkey = key + (self._n_shards(), b)
        args = exec_lib.scan_args(striped)
        inject.site("engine.scan", table=table_name)
        with obs_trace.span("scan", table=table_name, k=float(k),
                            subsampled=True) as sp:
            if obs_trace.tracing_active():
                sp.set(bytes_per_row=_scan_stream_bytes(striped))
            self._sync()
            t0 = time.perf_counter()
            if q.agg is AggOp.QUANTILE:
                fn = self._subsampled_quantile_programs.get(pkey)
                if fn is None:
                    fn = exec_lib.make_subsampled_quantile_fn(
                        *key[2:], b, **self._mesh_kw())
                    self._subsampled_quantile_programs[pkey] = fn
                mom_sub, qv, dens, qsub = fn(k, vals, q.quantile, gsub, *args)
                est = est_lib.subsampling_estimate(
                    AggOp.QUANTILE, mom_sub, n_groups, b, quantile_value=qv,
                    quantile_density=dens, quantile_values_sub=qsub,
                    q=q.quantile)
            else:
                fn = self._subsampled_programs.get(pkey)
                if fn is None:
                    fn = exec_lib.make_subsampled_query_fn(
                        *key[2:], b, **self._mesh_kw())
                    self._subsampled_programs[pkey] = fn
                mom_sub = fn(k, vals, gsub, *args)
                est = est_lib.subsampling_estimate(q.agg, mom_sub, n_groups,
                                                   b)
            self._sync()
            dt = time.perf_counter() - t0
            rows = fam.prefix_for_k(k)
            sp.set(rows_read=rows, elapsed_s=dt)
        self._observe_scan(dt, rows)
        mom = est_lib.fold_subsamples(mom_sub, n_groups, b)
        return self._answer_from_moments(
            q, table_name, phi, k, mom, rows, dt, confidence,
            certified=certified, predicted_half_width=predicted_half_width,
            est=est)

    def _scan_and_answer(self, q: Query, table_name: str,
                         phi: tuple[str, ...], k: float, confidence: float,
                         certified: bool | None = None,
                         predicted_half_width: float | None = None
                         ) -> Answer:
        """One scan at K → Answer, routed by CI method. Subsampling CIs run
        only while no fault plan is armed: the sharded path reduces
        per-shard moment partials that carry no subsample segments, so it
        uses the closed forms."""
        if self.config.ci_method == "subsampling" and inject.active() is None:
            return self._subsampled_answer(q, table_name, phi, k, confidence,
                                           certified, predicted_half_width)
        mom, rows_read, dt, rep, qpair = self._scan_for_query(table_name, q,
                                                              phi, k)
        return self._answer_from_moments(
            q, table_name, phi, k, mom, rows_read, dt, confidence,
            faults=rep, qpair=qpair, certified=certified,
            predicted_half_width=predicted_half_width)

    # --------------------------- a-priori ERROR WITHIN contracts (§4.2)
    def _pilot_certify(self, table_name: str, q: Query,
                       phi: tuple[str, ...], confidence: float
                       ) -> tuple[float | None, float | None]:
        """Pilot scan on the family's smallest resolution → (K or None,
        predicted CI half-width in bound units). The pilot variance is
        inflated by the finite-sample chi-square factor before the §4.2
        projection."""
        fam = self.families[table_name][phi]
        k_probe = min(fam.ks)
        mom, _, _, _, qpair = self._scan_for_query(table_name, q, phi,
                                                   k_probe)
        est = self._estimate_for(q, table_name, phi, k_probe, mom, qpair)
        return self._certify_from_pilot(q, fam, k_probe, est, confidence)

    def _certify_from_pilot(self, q: Query, fam: samp_lib.SampleFamily,
                            k_probe: float, est: est_lib.Estimate,
                            confidence: float
                            ) -> tuple[float | None, float | None]:
        """(K or None, predicted half-width) from a pilot scan at k_probe:
        the smallest K projected to give each group the selected rows the
        bound needs, the pilot variance inflated."""
        n_pilot = est.n.cpu().numpy().astype(np.float64)
        infl = est_lib.pilot_inflation(n_pilot, confidence)
        n_req = est_lib.required_n_for_error(
            q.agg, est, q.bound.eps, confidence, q.bound.relative
        ).cpu().numpy()
        k_q = elp_lib.pick_k_for_error(fam, n_pilot, n_req * infl, k_probe)
        k_half = k_q if k_q is not None else fam.ks[0]
        return k_q, self._predicted_half(q, est, infl, k_probe, k_half,
                                         confidence)

    def _certify_at_top(self, table_name: str, q: Query,
                        phi: tuple[str, ...], confidence: float
                        ) -> tuple[float | None, float | None]:
        """Certify at the family's LARGEST resolution from the realized
        (inflated) CI of a scan there."""
        fam = self.families[table_name][phi]
        k_top = fam.ks[0]
        mom, _, _, _, qpair = self._scan_for_query(table_name, q, phi, k_top)
        est = self._estimate_for(q, table_name, phi, k_top, mom, qpair)
        infl = est_lib.pilot_inflation(
            est.n.cpu().numpy().astype(np.float64), confidence)
        half = self._predicted_half(q, est, infl, k_top, k_top, confidence)
        if half is not None and half <= q.bound.eps + 1e-12 and (
                q.agg is not AggOp.QUANTILE
                or est_lib.quantile_sample_suffices(mom, q.quantile)):
            return k_top, half
        return None, half

    def _quantile_floor_met(self, table_name: str, q: Query,
                            phi: tuple[str, ...], k: float) -> bool:
        """For QUANTILE, whether a scan at the certified K gives every group
        the effective sample its closed-form CI needs
        (estimators.quantile_sample_suffices). The reference skips this
        check and can certify a tail quantile from a handful of heavily
        weighted rows; other aggregates always pass."""
        if q.agg is not AggOp.QUANTILE:
            return True
        mom, _ = self._quantile_scan(q, table_name, phi, k)
        return est_lib.quantile_sample_suffices(mom, q.quantile)

    def _predicted_half(self, q: Query, est: est_lib.Estimate, infl,
                        k_probe: float, k: float,
                        confidence: float) -> float | None:
        """Pilot-projected CI half-width at resolution k, in the bound's
        units, max over the groups the pilot saw (None when it saw none).
        Variance scales ∝ k_probe/k (§4.2), held at 1 below the probe."""
        vals = np.atleast_1d(est.value.cpu().numpy().astype(np.float64))
        var = np.atleast_1d(est.variance.cpu().numpy().astype(np.float64))
        n = np.atleast_1d(est.n.cpu().numpy().astype(np.float64))
        infl = np.broadcast_to(np.atleast_1d(infl), n.shape)
        seen = n > 0
        if not seen.any():
            return None
        z = est_lib.z_value(confidence)
        scale = min(k_probe / k, 1.0)
        half = z * np.sqrt(np.maximum(var * infl * scale, 0.0))
        if q.bound.relative:
            with np.errstate(divide="ignore", invalid="ignore"):
                half = np.where(np.abs(vals) > 0.0, np.abs(half / vals),
                                np.where(half > 0.0, np.inf, 0.0))
        return float(np.max(half[seen]))

    def _plan_error_bound(self, table_name: str, q: Query,
                          phi: tuple[str, ...], confidence: float,
                          first: tuple[float | None, float | None]
                          | None = None) -> ElpDecision:
        """Resolve an ErrorBound query by walking the ladder:
          1. certify a K on the §4.1-selected family (pilot + inflation),
             refined by one scan at the top resolution;
          2. escalate: pilot strictly LARGER families, ascending by size;
          3. exact base-table fallback — bound met by construction;
          4. best-effort annotated certified=False, or BoundUnreachableError
             for a strict bound (`... OR FAIL`).
        `first` injects a pilot result for the selected family (the shared
        pilot scan of query_batch)."""
        fams = self.families[table_name]

        def decide(p, k, certified, half, exact=False):
            return ElpDecision(p, k, certified, exact=exact,
                               predicted_half_width=half,
                               gen=self.family_generation(table_name, p))

        if first is None:
            with obs_trace.span("plan.pilot", family=list(phi)):
                k_q, half = self._pilot_certify(table_name, q, phi,
                                                confidence)
        else:
            k_q, half = first
        if k_q is not None and not self._quantile_floor_met(table_name, q,
                                                            phi, k_q):
            k_q = None
        if k_q is None and half is not None:
            # Containment refinement: the top prefix may fully contain the
            # strata the predicate touches (rate 1 ⇒ zero variance).
            with obs_trace.span("plan.certify_top", family=list(phi)):
                k_q, half = self._certify_at_top(table_name, q, phi,
                                                 confidence)
        if k_q is not None:
            return decide(phi, k_q, True, half)
        best_phi, best_half = phi, half
        if self.config.escalate_on_unreachable:
            def size(p):
                return max(fams[p].prefix_sizes)
            for p2 in sorted((p for p in fams
                              if p != phi and size(p) > size(phi)),
                             key=size):
                with obs_trace.span("plan.escalate", family=list(p2)):
                    k2, half2 = self._pilot_certify(table_name, q, p2,
                                                    confidence)
                if k2 is not None and self._quantile_floor_met(
                        table_name, q, p2, k2):
                    self._m_escalations.inc()
                    return decide(p2, k2, True, half2)
                if half2 is not None and (best_half is None
                                          or half2 < best_half):
                    best_phi, best_half = p2, half2
        if best_half is None:
            # Zero signal: no pilot saw a selected row. Serve the most
            # accurate sample uncertified; a strict bound still refuses (or
            # takes the exact fallback).
            if q.bound.strict:
                if self.config.exact_fallback:
                    self._m_exact_fallbacks.inc()
                    return decide(phi, float(fams[phi].ks[0]), True, 0.0,
                                  exact=True)
                raise BoundUnreachableError(
                    f"ERROR WITHIN {q.bound.eps} cannot be certified on "
                    f"table {table_name!r}: no pilot scan selected any "
                    f"row (nothing to project from)", None)
            return decide(phi, fams[phi].ks[0], False, None)
        if self.config.exact_fallback:
            self._m_exact_fallbacks.inc()
            return decide(phi, float(fams[phi].ks[0]), True, 0.0, exact=True)
        if q.bound.strict:
            raise BoundUnreachableError(
                f"ERROR WITHIN {q.bound.eps} AT CONFIDENCE {confidence} is "
                f"unreachable on table {table_name!r}: best predicted CI "
                f"half-width {best_half} (escalation/exact fallback "
                f"disabled or exhausted)", best_half)
        return decide(best_phi, fams[best_phi].ks[0], False, best_half)

    def _execute_decision(self, q: Query, table_name: str,
                          dec: ElpDecision, confidence: float) -> Answer:
        """Run one resolved contract decision to an Answer."""
        if dec.exact:
            ans = self.exact_query(q)
            return dataclasses.replace(ans, bound_met=True, certified=True,
                                       predicted_half_width=0.0)
        if (isinstance(q.bound, ErrorBound) and q.bound.strict
                and dec.certified is False):
            raise BoundUnreachableError(
                f"ERROR WITHIN {q.bound.eps} unreachable (predicted CI "
                f"half-width {dec.predicted_half_width})",
                dec.predicted_half_width)
        return self._scan_and_answer(
            q, table_name, dec.phi, dec.k, confidence,
            certified=dec.certified,
            predicted_half_width=dec.predicted_half_width)

    def _cached_decision(self, elp_key: tuple,
                         table_name: str) -> ElpDecision | None:
        """§4.4 cache lookup with generation pinning: a decision whose
        family was dropped or rebuilt is retired, not replayed."""
        dec = self._elp_cache.get(elp_key)
        if dec is None:
            return None
        if dec.exact:
            return dec
        fams = self.families.get(table_name, {})
        if dec.phi not in fams or \
                dec.gen != self.family_generation(table_name, dec.phi):
            del self._elp_cache[elp_key]
            return None
        return dec

    def _selection_cat_cols(self, table_name: str, q: Query) -> frozenset[str]:
        """Family selection columns (§4.1): the query's categorical WHERE and
        GROUP BY columns, a joined dimension attribute mapped to its fk
        column (a family stratified on the join key serves it, §2.1 case
        i)."""
        tbl = self.tables[table_name]
        fk_of = {j.dim_table: j.fact_key for j in q.joins}
        cols = {fk_of[c.split(".", 1)[0]] if "." in c else c
                for c in q.where_group_columns}
        return frozenset(c for c in cols
                         if tbl.schema.column(c).kind is ColumnKind.CATEGORICAL)

    def _select_phi(self, table_name: str, q: Query) -> tuple[str, ...]:
        """§4.1 runtime family selection (superset rule, else probe)."""
        fams = self.families[table_name]
        cat_cols = self._selection_cat_cols(table_name, q)

        def probe(phi: tuple[str, ...]) -> tuple[float, float]:
            mom, rows_read, _, _ = self._run_at_k(table_name, q, phi,
                                                  min(fams[phi].ks))
            return float(mom.n.sum()), float(rows_read)

        return select_family(cat_cols, fams, probe).phi

    def query(self, q: Query) -> Answer:
        """Execute with §4.1 family selection + §4.2 ELP resolution choice.
        ErrorBound queries walk the a-priori contract ladder, so every
        ErrorBound answer carries bound_met / certified /
        predicted_half_width, and a strict bound raises
        BoundUnreachableError instead of serving a best-effort answer."""
        subqueries = rewrite_disjuncts(q)
        if len(subqueries) > 1:
            return _union_answers(q, [self.query(sq) for sq in subqueries])

        self._m_queries.labels("query").inc()
        table_name = q.table
        self._resolve_joins(table_name, q)
        with obs_trace.span("plan", table=table_name) as sp:
            phi = self._select_phi(table_name, q)
            confidence = q.bound.confidence if q.bound else 0.95
            if isinstance(q.bound, TimeBound):
                # The reuse unit is the LatencyModel, re-projected per call.
                k_q = self._pick_k_for_time(table_name, q, phi)
                sp.set(bound="time", family=list(phi), k=float(k_q))
                dec = None
            else:
                struct, _ = exec_lib.pred_structure(exec_lib.bind_predicate(
                    q.predicate, self._encode(table_name)))
                elp_key = (table_name, phi, struct, q.agg, q.value_column,
                           q.group_by, repr(q.bound))
                cached = (self._cached_decision(elp_key, table_name)
                          if self.config.reuse_elp else None)
                dec = cached
                if dec is None:
                    if isinstance(q.bound, ErrorBound):
                        dec = self._plan_error_bound(table_name, q, phi,
                                                     confidence)
                    else:   # no bound: most accurate available sample
                        dec = ElpDecision(
                            phi, self.families[table_name][phi].ks[0], None,
                            gen=self.family_generation(table_name, phi))
                    self._elp_cache[elp_key] = dec
                sp.set(family=list(dec.phi), k=float(dec.k),
                       certified=dec.certified, exact=dec.exact,
                       cached=cached is not None)
        if dec is None:
            return self._scan_and_answer(q, table_name, phi, k_q, confidence)
        return self._execute_decision(q, table_name, dec, confidence)

    def _pick_k_for_time(self, table_name: str, q: Query,
                         phi: tuple[str, ...],
                         headroom_s: float = 0.0) -> float:
        """§4.2 latency profile: calibrate t(rows) on the smallest
        resolutions (scan times with the device synchronised), then pick
        the largest K inside the bound. The fitted model is cached per
        (table, family) and re-projected against each call's budget."""
        fam = self.families[table_name][phi]
        model = self._latency.get((table_name, phi))
        if model is None:
            def run_at_k(k):
                mom, _, dt, _ = self._run_at_k(table_name, q, phi, k)
                return float(mom.n.sum()), dt
            probes = elp_lib.run_probes(
                fam, run_at_k, n_probes=self.config.probe_resolutions)
            # On a mesh every rank fits the slowest rank's times, so all
            # pick the same K.
            model = elp_lib.fit_latency(
                [p.rows_read for p in probes],
                exec_lib.agree_max([p.elapsed_s for p in probes], self._axes))
            self._latency[(table_name, phi)] = model
        return elp_lib.pick_k_for_time(fam, model, q.bound.seconds,
                                       headroom_s=headroom_s)

    # ------------------------------------------------- batched shared scans
    def _plan_batch_job(self, parent: int, order: int, q: Query,
                        sel_cache: dict) -> _BatchJob:
        """Joins and family selection for one conjunctive subquery. One
        selection per distinct (table, selection columns, template,
        constants) serves every query of the batch that maps to it."""
        table_name = q.table
        self._resolve_joins(table_name, q)
        cat_cols = self._selection_cat_cols(table_name, q)
        struct, vals = exec_lib.pred_structure(
            exec_lib.bind_predicate(q.predicate, self._encode(table_name)))
        consts = exec_lib.flatten_pred_vals(vals)
        skey = (table_name, cat_cols, struct, consts)
        phi = sel_cache.get(skey)
        if phi is None:
            phi = self._select_phi(table_name, q)
            sel_cache[skey] = phi
        scan_key, _ = self._scan_key(table_name, q, phi)
        return _BatchJob(
            parent=parent, order=order, q=q, table=table_name, phi=phi,
            consts=consts,
            elp_key=(table_name, phi, struct, q.agg, q.value_column,
                     q.group_by, repr(q.bound)),
            scan_key=scan_key,
            confidence=q.bound.confidence if q.bound else 0.95)

    def _run_batched(self, scan_key, ks: Sequence[float],
                     consts_list: Sequence[tuple[float, ...]]
                     ) -> tuple[est_lib.GroupedMoments, float,
                                exec_lib.ShardScanReport | None]:
        """One fused multi-query scan over a family block → (moments with
        leaves [Q, G], seconds, fault report), the device synchronised
        around it. Batches over _MAX_SCAN_BATCH run as back-to-back
        launches; each query's moments have the bits of the same query
        scanned alone. Under an armed fault plan the scan is
        shard-partitioned as in _run_at_k; the report (None when clean)
        applies to every query of the batch."""
        return self._batched_scan(scan_key, ks, consts_list, False)[:3]

    def _run_batched_subsampled(self, scan_key, ks: Sequence[float],
                                consts_list: Sequence[tuple[float, ...]]
                                ) -> tuple[est_lib.GroupedMoments, float,
                                           None]:
        """_run_batched with per-subsample segments (ci_method=
        "subsampling"): the same launches with the G·B group column, leaves
        [Q, G·B], each query's the bits of query()'s subsampled scan. Never
        fault-sharded: query_batch routes armed-plan scans to the
        closed-form path."""
        return self._batched_scan(scan_key, ks, consts_list, True)[:3]

    def _batched_scan(self, scan_key, ks, consts_list, subsampled: bool):
        """→ (moments, seconds, fault report, rows read)."""
        run = (self._run_batched_subsampled if subsampled
               else self._run_batched)
        table_name, phi, struct, _, group_col = scan_key[:5]
        fam = self.families[table_name][phi]
        n_q = len(ks)
        if n_q > _MAX_SCAN_BATCH:
            parts = [run(scan_key, ks[i:i + _MAX_SCAN_BATCH],
                         consts_list[i:i + _MAX_SCAN_BATCH])
                     for i in range(0, n_q, _MAX_SCAN_BATCH)]
            mom = est_lib.GroupedMoments.from_stacked(
                torch.cat([m.stacked() for m, _, _ in parts]))
            return (mom, sum(d for _, d, _ in parts),
                    exec_lib.merge_shard_reports([r for _, _, r in parts]),
                    fam.prefix_for_k(max(ks)))
        striped = self._striped_for(table_name, phi)
        if subsampled:
            b = self.config.n_subsamples
            lead = (self._subsample_codes_for(table_name, phi, striped,
                                              group_col),)
            programs = self._batched_subsampled_programs
            pkey = scan_key + (self._n_shards(), b)
            make = functools.partial(exec_lib.make_batched_subsampled_query_fn,
                                     n_subsamples=b, **self._mesh_kw())
        else:
            lead = ()
            programs = self._batched_programs
            pkey = scan_key + (self._n_shards(),)
            make = functools.partial(exec_lib.make_batched_query_fn,
                                     **self._mesh_kw())
        fn = programs.get(pkey)
        if fn is None:
            fn = make(*scan_key[2:])
            programs[pkey] = fn
        n_atoms = len(exec_lib.flat_atoms(struct))
        ks_t = torch.tensor(list(ks), dtype=torch.float32).to(self.device)
        consts_t = torch.tensor([list(c) for c in consts_list],
                                dtype=torch.float32
                                ).reshape(n_q, n_atoms).to(self.device)
        args = exec_lib.scan_args(striped)
        inject.site("engine.scan", table=table_name)
        attrs = {"subsampled": True} if subsampled else {}
        with obs_trace.span("scan", table=table_name, batch=n_q,
                            k=float(max(ks)), **attrs) as sp:
            if obs_trace.tracing_active():
                sp.set(bytes_per_row=_scan_stream_bytes(striped))
                if not subsampled:
                    self._set_placement_attrs(sp, table_name, phi, fam,
                                              struct, consts_list)
            report = None
            self._sync()
            t0 = time.perf_counter()
            if not subsampled and self._fault_sharding_active():
                def call(mask):
                    # The shard's mask in the `valid` slot; synchronised,
                    # so the straggler deadline measures the attempt.
                    m = fn(ks_t, consts_t, *args[:-1], mask)
                    self._sync()
                    return m
                mom, report = exec_lib.run_sharded_scan(
                    call, striped,
                    n_logical=self.config.n_logical_shards,
                    n_replicas=self.config.shard_replicas,
                    site_ctx={"table": table_name},
                    deadline_s=self.config.straggler_deadline_s,
                    placement=self._placement_for(table_name, phi),
                    axes=self._axes)
            else:
                mom = fn(ks_t, consts_t, *lead, *args)
            self._sync()
            dt = time.perf_counter() - t0
            rows = fam.prefix_for_k(max(ks))
            sp.set(rows_read=rows, elapsed_s=dt)
            if report is not None:
                sp.set(shards=report.n_shards, lost=list(report.lost),
                       rerouted=list(report.rerouted),
                       reweight=report.reweight)
        self._observe_scan(dt, rows)
        self._count_shard_report(report)
        return mom, dt, report, rows

    def query_batch(self, queries: Sequence[Query],
                    deadline_headroom_s: float = 0.0) -> list[Answer]:
        """Execute N queries, sharing one fused scan per (table, family,
        template) group. Disjunctive queries split into conjunctive
        subqueries that join the batch individually; family selection and
        the ELP pilot scans are shared across the batch; the final pass is
        one multi-query scan per group, whose per-query slices unpack into
        ordinary Answers. A QUANTILE job takes its moments from the shared
        scan and its quantile from one quantile scan at its K. With
        ci_method="subsampling" the final scan of a group without QUANTILE
        has per-subsample segments, as query()'s; a group with one keeps
        the closed-form CIs, as the reference's does.

        Answers equal query()'s on the same engine bit for bit: a query's
        scan sums in the same order alone as in a batch, and later query()
        calls replay the decisions the batch cached.

        `deadline_headroom_s` (an admission scheduler's batching window)
        tightens every TimeBound query's scan budget by that amount.
        ErrorBound jobs the shared pilot cannot certify escalate, fall back
        to an exact scan or annotate bound_met=False out of band, as in
        query(); a strict bound raises BoundUnreachableError."""
        queries = list(queries)
        if not queries:
            return []
        self._m_queries.labels("batch").inc(len(queries))
        sel_cache: dict = {}
        jobs: list[_BatchJob] = []
        n_subs = [0] * len(queries)
        with obs_trace.span("plan", batch=len(queries), stage="select"):
            for pi, q in enumerate(queries):
                for sq in rewrite_disjuncts(q):
                    jobs.append(self._plan_batch_job(pi, n_subs[pi], sq,
                                                     sel_cache))
                    n_subs[pi] += 1

        # Decisions that cannot join the shared scan (exact fallback, or
        # escalation onto another family) run out of band.
        oob: dict[int, ElpDecision] = {}

        def apply_decision(job: _BatchJob, dec: ElpDecision) -> None:
            if dec.exact or dec.phi != job.phi:
                oob[id(job)] = dec
                return
            job.k = dec.k
            job.certified = dec.certified
            job.predicted_half = dec.predicted_half_width

        # ELP resolution (§4.2/§4.4): cached templates replay their
        # decision; uncached ErrorBound jobs share one pilot scan per group;
        # TimeBound jobs need timed probes (one model fit per family).
        probe_groups: dict[tuple, list[_BatchJob]] = {}
        for job in jobs:
            fam = self.families[job.table][job.phi]
            if isinstance(job.q.bound, TimeBound):
                job.k = self._pick_k_for_time(job.table, job.q, job.phi,
                                              headroom_s=deadline_headroom_s)
                continue
            dec = (self._cached_decision(job.elp_key, job.table)
                   if self.config.reuse_elp else None)
            if dec is not None:
                apply_decision(job, dec)
            elif isinstance(job.q.bound, ErrorBound):
                probe_groups.setdefault(job.scan_key, []).append(job)
            else:   # no bound: most accurate available sample
                dec = ElpDecision(
                    job.phi, fam.ks[0], None,
                    gen=self.family_generation(job.table, job.phi))
                self._elp_cache[job.elp_key] = dec
                apply_decision(job, dec)

        for scan_key, group in probe_groups.items():
            fam = self.families[group[0].table][group[0].phi]
            k_probe = min(fam.ks)
            with obs_trace.span("plan.pilot", batch=len(group)):
                mom, _, _ = self._run_batched(scan_key,
                                              [k_probe] * len(group),
                                              [j.consts for j in group])
            for i, job in enumerate(group):
                # Later jobs of one elp_key replay the first one's decision,
                # as sequential query() calls would.
                dec = (self._cached_decision(job.elp_key, job.table)
                       if self.config.reuse_elp else None)
                if dec is None:
                    mi = est_lib.moments_slice(mom, i)
                    est = self._estimate_for(job.q, job.table, job.phi,
                                             k_probe, mi)
                    first = self._certify_from_pilot(job.q, fam, k_probe, est,
                                                     job.confidence)
                    dec = self._plan_error_bound(job.table, job.q, job.phi,
                                                 job.confidence, first=first)
                    self._elp_cache[job.elp_key] = dec
                apply_decision(job, dec)

        # Final scan: one multi-query launch per (table, family, template).
        final_groups: dict[tuple, list[_BatchJob]] = {}
        for job in jobs:
            if id(job) not in oob:
                final_groups.setdefault(job.scan_key, []).append(job)
        sub_answers: list[list[tuple[int, Answer]]] = [[] for _ in queries]
        # Subsampling CIs as in query(): only with no fault plan armed.
        use_sub = (self.config.ci_method == "subsampling"
                   and inject.active() is None)
        b = self.config.n_subsamples
        for scan_key, group in final_groups.items():
            n_groups = scan_key[5]
            # QUANTILE replicates need the per-subsample histogram pass:
            # a scan group holding one keeps the closed-form CIs.
            sub_mode = use_sub and all(j.q.agg is not AggOp.QUANTILE
                                       for j in group)
            runner = (self._run_batched_subsampled if sub_mode
                      else self._run_batched)
            mom, dt, rep = runner(scan_key, [j.k for j in group],
                                  [j.consts for j in group])
            for i, job in enumerate(group):
                fam = self.families[job.table][job.phi]
                mi = est_lib.moments_slice(mom, i)
                est = None
                if sub_mode:
                    est = est_lib.subsampling_estimate(job.q.agg, mi,
                                                       n_groups, b)
                    mi = est_lib.fold_subsamples(mi, n_groups, b)
                ans = self._answer_from_moments(
                    job.q, job.table, job.phi, job.k, mi,
                    fam.prefix_for_k(job.k), dt / len(group), job.confidence,
                    faults=rep, certified=job.certified,
                    predicted_half_width=job.predicted_half, est=est)
                sub_answers[job.parent].append((job.order, ans))

        for job in jobs:
            dec = oob.get(id(job))
            if dec is not None:
                ans = self._execute_decision(job.q, job.table, dec,
                                             job.confidence)
                sub_answers[job.parent].append((job.order, ans))

        out = []
        for pi, subs in enumerate(sub_answers):
            subs = [a for _, a in sorted(subs, key=lambda t: t[0])]
            out.append(subs[0] if len(subs) == 1
                       else _union_answers(queries[pi], subs))
        return out

    def exact_query(self, q: Query) -> Answer:
        """Ground truth: the aggregation over the live rows of the FULL base
        table (rate=1) on the engine's device. A plain segment sum (no
        sample kernel), summed in float64 so counts past 2^24 rows stay
        exact; QUANTILE bins the selected rows over their own range
        (executor.grouped_quantile). Tombstoned rows are masked out; rows
        whose group code lies outside [0, G) (a join's dangling key) land
        in no group. Only the columns the query names are read, so a
        column an append left stale on the device is uploaded here."""
        self._m_queries.labels("exact").inc()
        tbl = self.tables[q.table]
        self._resolve_joins(q.table, q)
        bound_pred = exec_lib.bind_predicate(q.predicate, self._encode(q.table))
        struct, vals = exec_lib.pred_structure(bound_pred)
        group_col = q.group_by[0] if q.group_by else None
        n_groups = self._column_card(q.table, group_col) if group_col else 1
        names = {c for c, _ in exec_lib.flat_atoms(struct)} | \
            {q.value_column, group_col}
        names = sorted(c for c in names if c is not None) or \
            [tbl.schema.column_names[0]]
        cols = {c: tbl.columns[c] for c in names}
        live = tbl.live_mask_device()
        with obs_trace.span("scan.exact", table=q.table) as sp:
            self._sync()
            t0 = time.perf_counter()
            mask = exec_lib.eval_pred(struct, cols, vals) & live
            ones = torch.ones(tbl.n_rows, dtype=torch.float32,
                              device=self.device)
            values = (cols[q.value_column].to(torch.float32)
                      if q.value_column else ones)
            g = (cols[group_col] if group_col
                 else torch.zeros(tbl.n_rows, dtype=torch.int32,
                                  device=self.device))
            mom = est_lib.grouped_moments(values, ones, mask, g, n_groups,
                                          accumulate=torch.float64)
            if q.agg is AggOp.QUANTILE:
                # Histogram counts summed in float64 and rounded to float32:
                # the reference's float32 counts wherever no bin passes
                # 2^24.
                qv, dens = exec_lib.grouped_quantile(
                    values, mask.to(torch.float32), g, n_groups, q.quantile,
                    accumulate=torch.float64)
                est = est_lib.estimate(AggOp.QUANTILE, mom,
                                       quantile_value=qv,
                                       quantile_density=dens, q=q.quantile)
            else:
                est = est_lib.estimate(q.agg, mom)
            vals_h = est.value.cpu().numpy()
            ns = est.n.cpu().numpy()
            dt = time.perf_counter() - t0
            sp.set(rows_read=tbl.n_rows, elapsed_s=dt)
        self._observe_scan(dt, tbl.n_rows)
        groups = []
        for gidx in range(len(vals_h)):
            if ns[gidx] == 0:
                continue
            key = ((self._decode_col_value(q.table, group_col, gidx),)
                   if group_col else ())
            groups.append(GroupResult(key, float(vals_h[gidx]), 0.0,
                                      float(vals_h[gidx]), float(vals_h[gidx]),
                                      float(ns[gidx]), True))
        return Answer(q, groups, ("<exact>",), float("inf"), tbl.n_rows,
                      tbl.n_live, dt, 1.0)


def _union_answers(q: Query, answers: list[Answer]) -> Answer:
    """Combine disjunct sub-answers (§4.1.2): sums/counts add; variances
    add (the disjoint-disjunct case). Only ADDITIVE aggregates may be
    unioned; rewrite_disjuncts rejects AVG/QUANTILE before execution.
    Sub-answer GroupResults are copied before the union mutates them."""
    if q.agg not in (AggOp.COUNT, AggOp.SUM):
        raise ValueError(
            f"disjunct union is only defined for additive aggregates "
            f"(COUNT/SUM), not {q.agg}")
    by_key: dict[tuple, GroupResult] = {}
    for a in answers:
        for g in a.groups:
            if g.key in by_key:
                prev = by_key[g.key]
                var = prev.stderr ** 2 + g.stderr ** 2
                by_key[g.key] = GroupResult(
                    g.key, prev.estimate + g.estimate, var ** 0.5, 0.0, 0.0,
                    prev.n_selected + g.n_selected, prev.exact and g.exact)
            else:
                by_key[g.key] = dataclasses.replace(g)
    z = est_lib.z_value(answers[0].confidence)
    groups = []
    for g in by_key.values():
        g.ci_low = g.estimate - z * g.stderr
        g.ci_high = g.estimate + z * g.stderr
        groups.append(g)
    mets = [a.bound_met for a in answers]
    certs = [a.certified for a in answers]
    preds = [a.predicted_half_width for a in answers
             if a.predicted_half_width is not None]
    return Answer(q, groups, answers[0].sample_phi, answers[0].sample_k,
                  sum(a.rows_read for a in answers), answers[0].rows_total,
                  sum(a.elapsed_s for a in answers), answers[0].confidence,
                  # One degraded disjunct makes the union degraded (the
                  # widest loss across sub-answers is reported).
                  degraded=any(a.degraded for a in answers),
                  shards_lost=max(a.shards_lost for a in answers),
                  shards_total=max(a.shards_total for a in answers),
                  staleness_s=max(a.staleness_s for a in answers),
                  # The union claims the bound only when EVERY disjunct did.
                  bound_met=(None if all(m is None for m in mets)
                             else all(bool(m) for m in mets)),
                  certified=(None if all(c is None for c in certs)
                             else all(bool(c) for c in certs)),
                  predicted_half_width=max(preds) if preds else None)
