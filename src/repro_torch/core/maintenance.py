"""Sample maintenance (paper §4.5 + §3.2.3; counterpart of
`repro.core.maintenance`).

Periodically: (1) detect data/workload drift, (2) re-run the §3.2 optimizer
with the Eq.-5 change budget r, (3) regenerate affected families with fresh
randomness in a low-priority background task and atomically swap them in.

Two ingestion modes (docs/MAINTENANCE.md):

* `run_epoch(delta=...)` — the serving-compatible path: the epoch is an
  APPEND of new rows. Families merge in place (engine.append_rows: exact HT
  rates under the grown frequencies, compiled programs preserved), and only
  when the delta drifts a family's stratum distribution past the threshold
  does the epoch fall back to the §3.2 optimizer + fresh resample for the
  drifted families.
* `run_epoch(new_table=...)` — full replacement (the original batch path):
  every derived cache is invalidated and families rebuild from scratch.

Deletes/updates flow through `BlinkDB.delete_rows`/`update_rows` (tombstone
protocol, docs/MAINTENANCE.md); every epoch additionally runs the
storage-reclamation pass (`reclaim()`): (1) base-table compaction once the
dead-row fraction passes `base_compact_threshold` (physically drop
tombstoned base rows, remap row ids everywhere), (2) inclusion-frequency
decay of strata whose cumulative/live ratio passes `decay_ratio` (re-key +
resample under reset inclusion freqs), and (3) the ghost-slot compaction
policy (`compact()`): families whose striped blocks accumulated more than
`compact_threshold` self-excluded slots (rescale ghosts + tombstoned rows)
are restriped into their existing geometry.

Epoch randomness is threaded explicitly (base_seed + epoch number) — the
shared EngineConfig.seed is never mutated.

The scheduler is a thread, so the mechanics (atomic swap, change budget,
drift triggers) are testable; every scan and patched block it produces
lives on the engine's device.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Sequence

import numpy as np

from repro_torch.core import table as table_lib
from repro_torch.core.engine import BlinkDB
from repro_torch.core.types import QueryTemplate


def distribution_drift(old_freqs: np.ndarray, new_freqs: np.ndarray) -> float:
    """Total-variation distance between two stratum-frequency histograms
    (aligned by truncation/padding). Drift trigger metric."""
    n = max(len(old_freqs), len(new_freqs))
    a = np.zeros(n); a[: len(old_freqs)] = old_freqs
    b = np.zeros(n); b[: len(new_freqs)] = new_freqs
    pa = a / max(a.sum(), 1.0)
    pb = b / max(b.sum(), 1.0)
    return float(0.5 * np.abs(pa - pb).sum())


def strata_to_decay(fam, ratio: float) -> np.ndarray:
    """Stable stratum ids whose cumulative inclusion frequency reached
    `ratio` × the live count (and strictly exceeds it — equal means no dead
    weight to forgive). A fully-dead stratum (live 0, cumulative > 0) always
    qualifies: its inclusion count is pure dead weight."""
    if fam.stratum_live is None or not fam.phi:
        return np.zeros(0, dtype=np.int64)   # append-only / uniform: no decay
    freqs = fam.stratum_freqs
    live = fam.live_freqs
    return np.flatnonzero((freqs >= ratio * live)
                          & (freqs > live)).astype(np.int64)


@dataclasses.dataclass
class MaintenanceConfig:
    drift_threshold: float = 0.05     # TV distance triggering re-optimization
    change_fraction: float = 0.3      # Eq. 5 r: ≤30% of sample bytes may churn
    storage_budget_fraction: float = 0.5   # §3.2 Eq. 3 budget per epoch
    period_s: float = 86400.0         # paper: daily
    # Ghost+tombstone slot fraction past which a family's striped block is
    # compacted (periodic restripe — not only on block growth). Rescale
    # ghosts and tombstoned rows self-exclude from every scan but still
    # occupy slots, so scan efficiency decays with churn until reclaimed.
    compact_threshold: float = 0.3
    # Dead-row fraction of the BASE table past which an epoch runs the
    # base-table compaction (Table.compact + row-id remap to every family —
    # docs/MAINTENANCE.md). Tombstones reclaim sample slots but base columns
    # keep holding dead rows forever without this.
    base_compact_threshold: float = 0.3
    # Cumulative-vs-live inclusion-frequency ratio past which a stratum is
    # decayed (re-keyed + resampled under reset inclusion freqs). Churn
    # inflates F_cum while live rows dwindle, thinning the stratum's sample
    # to live·K/F_cum; decay restores it toward min(live, K). <= 1 disables.
    decay_ratio: float = 3.0
    # Fleet-wide storage-budget reclaim trigger (docs/MAINTENANCE.md): fires a FORCED reclamation pass across every
    # table once TOTAL dead bytes (tombstoned base rows + ghost sample
    # slots, summed fleet-wide) exceed this fraction of the fleet's §3.2
    # storage budget (storage_budget_fraction × total live base bytes).
    # Catches the many-tables-each-slightly-dirty regime the per-table
    # thresholds above never see. <= 0 disables.
    reclaim_pressure: float = 0.5


class SampleMaintainer:
    """Background maintenance driver for one BlinkDB instance.

    One maintainer runs the whole FLEET: construct with either
    the classic single-table signature `(db, table_name, templates)` or with
    `tables={name: templates, ...}` to put every table under one scheduler.
    All per-table operations take `table=None` (defaulting to the primary —
    first — table), so single-table callers are untouched and the per-table
    reclamation sequence is IDENTICAL whether the maintainer owns one table
    or ten (tests/test_torch_maintenance.py pins this bit for bit). On top
    of the per-table passes, `maybe_reclaim_fleet` watches TOTAL dead bytes
    against the §3.2 storage budget and forces a fleet-wide reclamation when
    the aggregate — invisible to any per-table threshold — grows past
    `MaintenanceConfig.reclaim_pressure` of the budget."""

    def __init__(self, db: BlinkDB, table_name: str | None = None,
                 templates: Sequence[QueryTemplate] = (),
                 config: MaintenanceConfig | None = None,
                 base_seed: int | None = None,
                 tables: "dict[str, Sequence[QueryTemplate]] | None" = None):
        if tables is not None and table_name is not None:
            raise ValueError("pass table_name+templates OR tables, not both")
        if tables is None:
            if table_name is None:
                raise ValueError("a table_name or a tables mapping required")
            tables = {table_name: templates}
        self.db = db
        self._templates: dict[str, list[QueryTemplate]] = {
            t: list(ts) for t, ts in tables.items()}
        if not self._templates:
            raise ValueError("tables mapping must name at least one table")
        self.config = config or MaintenanceConfig()
        # Per-epoch resample seeds derive from base_seed + epoch — the shared
        # EngineConfig.seed stays immutable (other engines/tables may read it).
        self.base_seed = db.config.seed if base_seed is None else base_seed
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.epochs = 0
        # Maintainer plane of the engine's metrics registry: epoch durations
        # by kind, reclamation work items by kind.
        self._m_epoch_s = db.metrics.histogram(
            "maintenance_epoch_seconds", "Maintenance epoch wall time",
            labels=("kind",))
        self._m_reclaim = db.metrics.counter(
            "maintenance_reclaim_total",
            "Storage-reclamation work items by kind",
            labels=("kind",))
        self._m_fleet_reclaims = db.metrics.counter(
            "maintenance_fleet_reclaims_total",
            "Forced fleet-wide reclaims (total dead bytes over budget)")
        db.metrics.gauge(
            "maintenance_storage_pressure",
            "Fleet dead bytes / reclaim_pressure share of the §3.2 budget"
        ).labels().set_function(lambda: self.storage_pressure())

    # -- fleet views ---------------------------------------------------------
    @property
    def tables(self) -> list[str]:
        """Tables under this maintainer, primary first."""
        return list(self._templates)

    @property
    def table_name(self) -> str:
        """Primary table (single-table compatibility)."""
        return next(iter(self._templates))

    @property
    def templates(self) -> list[QueryTemplate]:
        """Primary table's templates (single-table compatibility)."""
        return self._templates[self.table_name]

    @templates.setter
    def templates(self, ts: Sequence[QueryTemplate]) -> None:
        self._templates[self.table_name] = list(ts)

    def templates_for(self, table: str) -> list[QueryTemplate]:
        return list(self._templates[table])

    def _table(self, table: str | None) -> str:
        if table is None:
            return self.table_name
        if table not in self._templates:
            raise KeyError(f"table {table!r} is not under this maintainer "
                           f"(tables: {self.tables})")
        return table

    # -- drift detection -----------------------------------------------------
    def check_drift(self, new_table: table_lib.Table,
                    table: str | None = None
                    ) -> dict[tuple[str, ...], float]:
        """TV drift per existing family between old stats and the new data.

        The new histogram is built in the family's STABLE stratum-id order
        (map_codes_stable on fam.strata_keys, new combinations appended) —
        a positional comparison against combined_codes' lexicographic
        numbering would misalign once delta epochs have introduced strata,
        reporting spurious drift / masking real drift. A replacement table
        re-encodes its dictionaries from scratch, so its codes are first
        translated by dictionary VALUE onto the engine table's codes (a new
        table whose dictionary merely gained a value must not shift every
        code after it).

        Both sides of the comparison are LIVE histograms: the family's
        stratum_live (inclusion freqs still count tombstoned rows — a
        delete-heavy epoch would otherwise under-report drift, since dead
        rows pad both marginals toward the stale distribution) and the new
        table's non-tombstoned rows.
        """
        table = self._table(table)
        out = {}
        old_tbl = self.db.tables.get(table)
        live = new_table.live
        for phi, fam in self.db.families[table].items():
            if not phi:
                continue
            if fam.strata_keys is not None:
                mat = np.stack(
                    [self._align_codes(new_table, old_tbl, c) for c in phi],
                    axis=1)
                codes, keys = table_lib.map_codes_stable(mat, fam.strata_keys)
                nd = len(keys)
            else:
                codes, _ = table_lib.combined_codes(new_table, phi)
                nd = int(codes.max()) + 1 if len(codes) else 0
            if live is not None:
                codes = codes[live]
            new_f = table_lib.stratum_frequencies(codes, nd)
            out[phi] = distribution_drift(fam.live_freqs, new_f)
        return out

    @staticmethod
    def _align_codes(new_table: table_lib.Table,
                     old_tbl: table_lib.Table | None, col: str) -> np.ndarray:
        """Codes of new_table[col] re-expressed in old_tbl's dictionary
        (values unseen by the old dictionary get fresh codes past its
        cardinality, i.e. guaranteed-new strata)."""
        codes = new_table.host_column(col).astype(np.int32)
        if old_tbl is None or new_table is old_tbl:
            return codes
        old_vals = old_tbl.dictionaries[col]
        lookup = {v: i for i, v in enumerate(old_vals.tolist())}
        trans, _ = table_lib.get_or_assign_codes(
            new_table.dictionaries[col].tolist(), lookup)
        return trans[codes].astype(np.int32)

    # -- ghost-slot compaction (periodic restripe) -----------------------------
    def compact(self, table: str | None = None,
                threshold: float | None = None) -> list[tuple[str, ...]]:
        """Compact every family whose striped block's ghost+tombstone slot
        fraction exceeds the threshold (docs/MAINTENANCE.md): rescale ghosts
        and tombstoned rows self-exclude from scans but still occupy slots,
        so without this periodic restripe a churn-heavy workload degrades
        scan efficiency until a block happens to outgrow its padding. The
        compacting restripe pins the old block geometry, so compiled query
        programs normally stay valid. Returns the compacted families."""
        table = self._table(table)
        thr = (self.config.compact_threshold if threshold is None
               else threshold)
        compacted = []
        for phi, frac in self.db.ghost_fractions(table).items():
            if frac > thr:
                if self.db.compact_family(table, phi):
                    compacted.append(phi)
        return compacted

    # -- storage-reclamation epochs (base compaction + inclusion decay) --------
    def decay(self, table: str | None = None
              ) -> dict[tuple[str, ...], list[int]]:
        """Decay every stratum whose cumulative inclusion frequency exceeds
        `decay_ratio` × its live count (docs/MAINTENANCE.md): churn-heavy
        strata thin their samples under the monotone inclusion freqs; the
        decay pass re-keys + resamples them under reset freqs, restoring
        utilization with HT rates exact by construction. Returns
        {family: [stable stratum ids decayed]}."""
        table = self._table(table)
        ratio = self.config.decay_ratio
        out: dict[tuple[str, ...], list[int]] = {}
        if ratio is None or ratio <= 1.0:
            return out
        for phi, fam in list(self.db.families[table].items()):
            strata = strata_to_decay(fam, ratio)
            if strata.size:
                block = self.db.decay_family(table, phi, strata)
                if block is not None:
                    out[phi] = [int(s) for s in block.strata]
        return out

    def reclaim(self, table: str | None = None,
                base_threshold: float | None = None,
                compact_threshold: float | None = None) -> dict:
        """One storage-reclamation pass, run by every epoch: (1) base-table
        compaction once the dead-row fraction passes the threshold — the
        row-id remap ships to every family/striped mirror with zero device
        traffic; (2) inclusion-frequency decay of over-ratio strata; (3) the
        existing ghost-slot compaction of striped blocks (decay restripes
        its families itself, so it runs first). The threshold overrides are
        the forced-reclaim hook (`reclaim_fleet`); defaults reproduce the
        single-table pass exactly."""
        table = self._table(table)
        base_thr = (self.config.base_compact_threshold
                    if base_threshold is None else base_threshold)
        report = {"base_compacted": 0, "decayed": {}}
        if self.db.dead_fraction(table) > base_thr:
            comp = self.db.compact_table(table)
            if comp is not None:
                report["base_compacted"] = comp.n_dropped
        report["decayed"] = self.decay(table)
        report["compacted"] = self.compact(table,
                                           threshold=compact_threshold)
        if report["base_compacted"]:
            self._m_reclaim.labels("base_rows_dropped").inc(
                report["base_compacted"])
        n_decayed = sum(len(s) for s in report["decayed"].values())
        if n_decayed:
            self._m_reclaim.labels("strata_decayed").inc(n_decayed)
        if report["compacted"]:
            self._m_reclaim.labels("families_compacted").inc(
                len(report["compacted"]))
        return report

    # -- fleet storage budget ---------------------------------------------------
    def storage_status(self) -> dict:
        """Fleet storage accounting against the §3.2 budget: per-table
        live/dead bytes (engine.storage_stats), fleet totals, the budget in
        bytes (`storage_budget_fraction` × total live base bytes — the same
        arithmetic the optimizer's Eq.-3 constraint uses), and the pressure
        ratio `maybe_reclaim_fleet` triggers on."""
        per_table = {t: self.db.storage_stats(t) for t in self.tables}
        live = sum(s["live_bytes"] for s in per_table.values())
        dead = sum(s["dead_bytes"] for s in per_table.values())
        budget = self.config.storage_budget_fraction * live
        return {"tables": per_table, "live_bytes": live, "dead_bytes": dead,
                "budget_bytes": budget,
                "pressure": dead / budget if budget > 0 else 0.0}

    def storage_pressure(self) -> float:
        """TOTAL dead bytes across every table, as a fraction of the fleet's
        §3.2 storage budget. ≥ reclaim_pressure means dead storage is
        crowding out sample budget and a forced fleet reclaim fires."""
        return self.storage_status()["pressure"]

    def reclaim_fleet(self, force: bool = False) -> dict:
        """Storage reclamation across EVERY table. `force` drops the
        per-table thresholds to zero — every table with any dead base row
        compacts, every striped block with any ghost slot restripes — which
        is what the storage-budget trigger needs: the fleet got here
        precisely because no single table crossed its own threshold."""
        status = self.storage_status()
        kw = ({"base_threshold": 0.0, "compact_threshold": 0.0}
              if force else {})
        out = {"pressure_before": status["pressure"],
               "tables": {t: self.reclaim(t, **kw) for t in self.tables}}
        out["pressure_after"] = self.storage_pressure()
        return out

    def maybe_reclaim_fleet(self) -> dict | None:
        """The storage-budget-driven trigger: when total dead bytes exceed
        `reclaim_pressure` × budget, run a forced fleet-wide reclaim.
        Returns the reclaim report, or None when under pressure. Wired into
        the background loop and multi-table epochs; single-table epochs keep
        their exact historical behavior (per-table thresholds only)."""
        if self.config.reclaim_pressure <= 0.0:
            return None
        if self.storage_pressure() < self.config.reclaim_pressure:
            return None
        self._m_fleet_reclaims.inc()
        t0 = time.perf_counter()
        out = self.reclaim_fleet(force=True)
        self._m_epoch_s.labels("fleet_reclaim").observe(
            time.perf_counter() - t0)
        return out

    # -- workload-only epoch (template churn, no data delta) -------------------
    def run_workload_epoch(self, new_templates: Sequence[QueryTemplate],
                           seed: int | None = None,
                           table: str | None = None) -> dict:
        """§3.2 re-optimization driven purely by OBSERVED workload drift
        (service WorkloadMonitor): the template set/weights changed but the
        data did not, so the optimizer re-solves under the Eq.-5 change
        budget and only the family SET moves — surviving families keep their
        rows untouched (no data delta ⇒ no staleness, nothing to resample),
        dropped ones free budget, newly chosen ones build fresh with the
        epoch seed: the §3.2 framework reacts to template churn end to end,
        not only to data deltas."""
        table = self._table(table)
        t0 = time.perf_counter()
        self.epochs += 1
        epoch_seed = (self.base_seed + self.epochs) if seed is None else seed
        before = set(self.db.families[table])
        new_templates = list(new_templates)
        sol = self.db.build_samples(
            table, new_templates,
            storage_budget_fraction=self.config.storage_budget_fraction,
            change_fraction=self.config.change_fraction,
            seed=epoch_seed)
        # Commit only on optimizer success: a failed epoch must not leave
        # the maintainer switched onto templates the optimizer never
        # consumed (later data-delta epochs would silently adopt them while
        # the monitor's drift baseline says they were never adopted).
        self._templates[table] = new_templates
        after = set(self.db.families[table])
        out = {"added": sorted(after - before),
               "dropped": sorted(before - after),
               "kept": sorted(after & before),
               "objective": sol.objective, "storage": sol.storage_used,
               **self.reclaim(table)}
        self._m_epoch_s.labels("workload").observe(time.perf_counter() - t0)
        return out

    # -- one maintenance epoch -------------------------------------------------
    def run_epoch(self, new_table: table_lib.Table | None = None,
                  new_templates: Sequence[QueryTemplate] | None = None,
                  delta=None, seed: int | None = None,
                  table: str | None = None) -> dict:
        """One maintenance epoch.

        `delta` (host columns, append-only) takes the incremental path: merge
        every family in place via BlinkDB.append_rows, measure drift on the
        STABLE stratum histograms it reports, and only if some family drifted
        past the threshold re-run the §3.2 optimizer (change budget) and
        resample the drifted families with the fresh epoch seed. Low-drift
        epochs therefore never recompile, rebuild, or resample anything —
        maintenance becomes a serving-compatible operation.

        `new_table` replaces the table wholesale (batch path): full
        invalidation + optimizer re-run, as before.
        """
        if delta is not None and new_table is not None:
            raise ValueError("pass either delta (append) or new_table "
                             "(replacement), not both")
        table = self._table(table)
        if new_templates is not None:
            self._templates[table] = list(new_templates)
        t0 = time.perf_counter()
        self.epochs += 1
        epoch_seed = (self.base_seed + self.epochs) if seed is None else seed

        if delta is not None:
            report = self.db.append_rows(table, delta, seed=epoch_seed)
            drift = {phi: distribution_drift(old, new)
                     for phi, (old, new) in report.freqs.items() if phi}
            stale = [phi for phi, d in drift.items()
                     if d > self.config.drift_threshold]
            sol = None
            if stale or new_templates is not None:
                # Fallback past the drift threshold: §3.2 re-optimization
                # under the change budget + fresh resample of drifted
                # families (offline-sampling staleness fix, §2.1).
                sol = self.db.build_samples(
                    table, self._templates[table],
                    storage_budget_fraction=self.config.storage_budget_fraction,
                    change_fraction=self.config.change_fraction,
                    seed=epoch_seed)
                for phi in stale:
                    if phi in self.db.families[table]:
                        self.db.add_family(table, phi, seed=epoch_seed)
            out = {"drift": drift, "rebuilt": stale,
                   "merged": report.merged, "restriped": report.restriped,
                   "appended_rows": report.delta.n_rows,
                   **self.reclaim(table),
                   "objective": sol.objective if sol else None,
                   "storage": sol.storage_used if sol else None}
            self._m_epoch_s.labels("delta").observe(
                time.perf_counter() - t0)
            return out

        tbl = new_table if new_table is not None else self.db.tables[table]
        drift = self.check_drift(tbl, table) if new_table is not None else {}
        dicts_changed = False
        if new_table is not None:
            # A replacement table re-encodes its dictionaries from scratch;
            # families that survive selection hold rows coded under the OLD
            # dictionaries and would silently answer with wrong strata/groups
            # unless every dictionary round-trips identically.
            old_tbl = self.db.tables.get(table)
            dicts_changed = old_tbl is not None and (
                set(old_tbl.dictionaries) != set(new_table.dictionaries)
                or any(not np.array_equal(old_tbl.dictionaries[c],
                                          new_table.dictionaries[c])
                       for c in old_tbl.dictionaries))
            # register_table invalidates every cache derived from the old
            # table's columns (striped views, compiled programs, ELP state).
            self.db.register_table(table, new_table)

        stale = [phi for phi, d in drift.items()
                 if d > self.config.drift_threshold]
        sol = self.db.build_samples(
            table, self._templates[table],
            storage_budget_fraction=self.config.storage_budget_fraction,
            change_fraction=self.config.change_fraction,
            seed=epoch_seed)
        if dicts_changed:
            # Rebuild EVERY surviving family: their rows are coded under the
            # replaced dictionaries (encoding staleness is systematic
            # wrongness, unlike the accepted §4.5 data staleness).
            stale = sorted(self.db.families[table], key=len)
        # Force-regenerate drifted (or re-encoded) surviving families.
        for phi in stale:
            if phi in self.db.families[table]:
                self.db.add_family(table, phi, seed=epoch_seed)
        out = {"drift": drift, "rebuilt": stale,
               **self.reclaim(table), "objective": sol.objective,
               "storage": sol.storage_used}
        self._m_epoch_s.labels(
            "replace" if new_table is not None else "refresh").observe(
            time.perf_counter() - t0)
        return out

    def run_fleet_epoch(self, seed: int | None = None) -> dict:
        """One maintenance sweep of the whole fleet: a refresh epoch per
        table (per-table reclaim included, identical to the single-table
        pass) followed by the storage-budget check — the aggregate trigger
        that fires when total dead bytes threaten the §3.2 budget even
        though no individual table crossed its own thresholds."""
        out = {"tables": {t: self.run_epoch(seed=seed, table=t)
                          for t in self.tables}}
        out["fleet_reclaim"] = self.maybe_reclaim_fleet()
        return out

    # -- background thread (low-priority task per §4.5) -----------------------
    def start(self, period_s: float | None = None) -> None:
        period = period_s if period_s is not None else self.config.period_s

        def loop():
            while not self._stop.wait(period):
                if len(self._templates) > 1:
                    self.run_fleet_epoch()
                else:
                    self.run_epoch()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5.0)
