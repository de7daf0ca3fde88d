"""BlinkDB engine facade of the port (counterpart of `repro.core.engine`).

    db = BlinkDB(EngineConfig(), device="cuda")
    db.register_table("sessions", table)
    db.build_samples("sessions", templates, storage_budget_fraction=0.5)
    ans = db.query(Query(..., bound=ErrorBound(0.1, 0.95)))

The port builds sample families offline, chosen by the §3.2 optimizer
(`build_samples`) or by hand (`add_family`), and answers COUNT, SUM, AVG
and QUANTILE under ERROR WITHIN or WITHIN SECONDS on one device with
closed-form CIs, one query at a time (`query`) or as a batch that shares
its scans (`query_batch`): runtime family selection (§4.1), the ELP choice
of the resolution K (§4.2) with the a-priori ERROR WITHIN ladder (pilot,
certify at the top resolution, escalation, exact fallback), the fused scan
and the one-pass quantile scan (executor → the CUDA kernels on the card),
and HT estimation with Table-2 error bars (§4.3). Joins, subsampling CIs,
mutation and fault handling come with later slices and raise
NotImplementedError here.
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
from repro_torch.core import optimizer as opt_lib
from repro_torch.core import sampling as samp_lib
from repro_torch.core import table as table_lib
from repro_torch.core.selection import rewrite_disjuncts, select_family
from repro_torch.core.types import (AggOp, Answer, BoundUnreachableError,
                                    ColumnKind, ErrorBound, GroupResult,
                                    Query, QueryTemplate, TimeBound)


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
    ci_method: str = "closed"    # "subsampling" comes with a later slice
    # Where tables, sample blocks and scans live. "cuda" unless the caller
    # asks for the CPU; a missing card is an error, never a quiet CPU run.
    device: str = "cuda"


def resolve_device(device) -> torch.device:
    """The engine's device; raises when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: BlinkDB runs on the card "
                           "by default; pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


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
    def __init__(self, config: EngineConfig | None = None, device=None):
        self.config = config or EngineConfig()
        self.device = resolve_device(self.config.device if device is None
                                     else device)
        if self.config.ci_method != "closed":
            raise NotImplementedError(
                f"ci_method={self.config.ci_method!r}: variational-subsampling "
                "CIs come with the subsampling-CI slice of the port")
        self.tables: dict[str, table_lib.Table] = {}
        self.families: dict[str, dict[tuple[str, ...], samp_lib.SampleFamily]] = {}
        self._striped: dict[tuple[str, tuple[str, ...]], exec_lib.StripedFamily] = {}
        self._latency: dict[tuple[str, tuple[str, ...]], elp_lib.LatencyModel] = {}
        # (table, phi, template, value, group, G) -> scan program
        self._batched_programs: dict = {}
        self._quantile_programs: dict = {}
        self._quantile_ranges: dict = {}     # (table, phi, column) -> range
        self._elp_cache: dict = {}    # elp key -> ElpDecision
        self._generations: dict[tuple[str, tuple[str, ...]], int] = {}
        self.last_solution: opt_lib.Solution | None = None

    def family_generation(self, table_name: str, phi: tuple[str, ...]) -> int:
        """Monotone content version of one sample family (0 = never built)."""
        return self._generations.get((table_name, phi), 0)

    def _drop_derived(self, table_name: str, phi: tuple[str, ...] | None) -> None:
        """Forget everything calibrated against a (table, family), or the
        whole table when phi is None: striped blocks, scan programs, ELP
        decisions, latency models and quantile histogram ranges."""
        for cache in (self._striped, self._latency, self._batched_programs,
                      self._quantile_programs, self._quantile_ranges,
                      self._elp_cache):
            for k in [k for k in cache
                      if k[0] == table_name and (phi is None or k[1] == phi)]:
                del cache[k]

    # ------------------------------------------------------------- offline
    def register_table(self, name: str, tbl: table_lib.Table) -> None:
        """Register a table and put its columns on the engine's device (the
        exact scan reads them there)."""
        if name in self.tables and self.tables[name] is not tbl:
            self._drop_derived(name, None)
            for phi in self.families.get(name, {}):
                self._generations[(name, phi)] = \
                    self.family_generation(name, phi) + 1
            self.families[name] = {}
        self.tables[name] = tbl.to(self.device)
        self.families.setdefault(name, {})

    def candidate_stats(self, table_name: str
                        ) -> Callable[[frozenset[str]], tuple[float, float, float]]:
        """stats(phi) -> (Store(φ), |D(φ)|, Δ(φ)) from table statistics.
        Every row is live until deletes come with a later slice."""
        tbl = self.tables[table_name]
        k1 = self.config.k1

        def stats(phi: frozenset[str]):
            codes, _ = table_lib.combined_codes(tbl, sorted(phi))
            nd = int(codes.max()) + 1 if len(codes) else 0
            freqs = table_lib.stratum_frequencies(codes, nd)
            storage = samp_lib.expected_sample_rows(freqs, k1) * \
                (tbl.row_bytes() + 8)
            delta = float(((freqs > 0) & (freqs < k1)).sum())
            return storage, nd, delta
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
            self._generations[(table_name, phi)] = \
                self.family_generation(table_name, phi) + 1
        for phi in sorted(wanted - current):
            self.add_family(table_name, phi, seed=seed, units=units.get(phi))
        if () not in fams:
            self.add_family(table_name, (), seed=seed, units=units.get(()))
        return sol

    def add_family(self, table_name: str, phi: Sequence[str],
                   seed: int | None = None,
                   units: np.ndarray | None = None) -> None:
        """Add (or rebuild) a family. `seed` overrides the config seed;
        `units` overrides the per-row priorities outright (see
        repro_torch.state, which carries the reference's units across)."""
        seed = self.config.seed if seed is None else seed
        tbl = self.tables[table_name]
        phi_t = tuple(sorted(phi))
        if phi_t == ():
            fam = samp_lib.build_uniform_family(
                tbl, self.config.uniform_fraction, self.config.c,
                self.config.m, seed=seed, units=units)
        else:
            fam = samp_lib.build_family(tbl, phi_t, self.config.k1,
                                        self.config.c, self.config.m,
                                        seed=seed, units=units)
        self.families.setdefault(table_name, {})[phi_t] = fam
        self._drop_derived(table_name, phi_t)
        self._generations[(table_name, phi_t)] = \
            self.family_generation(table_name, phi_t) + 1

    # ------------------------------------------------------------- runtime
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _striped_for(self, table_name: str,
                     phi: tuple[str, ...]) -> exec_lib.StripedFamily:
        key = (table_name, phi)
        if key not in self._striped:
            fam = self.families[table_name][phi]
            self._striped[key] = exec_lib.stripe_family(fam, self.device)
        return self._striped[key]

    def _encode(self, table_name: str):
        tbl = self.tables[table_name]

        def encode(col: str, value):
            if tbl.schema.column(col).kind is ColumnKind.CATEGORICAL:
                return tbl.encode_value(col, value)
            return float(value)
        return encode

    def _column_card(self, table_name: str, col: str) -> int:
        return self.tables[table_name].cardinality(col)

    def _decode_col_value(self, table_name: str, col: str, code: int):
        return self.tables[table_name].decode_value(col, code)

    def _check_supported(self, q: Query) -> None:
        if q.joins:
            raise NotImplementedError(
                "joins come with the joins slice of the port")

    def _run_at_k(self, table_name: str, q: Query, phi: tuple[str, ...],
                  k: float) -> tuple[est_lib.GroupedMoments, int, float]:
        """One fused scan at resolution k: the batched scan at Q = 1, timed
        with the device synchronised (the WITHIN SECONDS latency model is
        fitted on these times)."""
        key, vals = self._scan_key(table_name, q, phi)
        mom, dt = self._run_batched(key, [k], [exec_lib.flatten_pred_vals(vals)])
        return (est_lib.moments_slice(mom, 0),
                self.families[table_name][phi].prefix_for_k(k), dt)

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
                             qpair=None, certified: bool | None = None,
                             predicted_half_width: float | None = None
                             ) -> Answer:
        tbl = self.tables[table_name]
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
            exact = bool(abs(nsel[g] - wsum[g]) < 1e-6 * max(wsum[g], 1.0))
            if not exact and isinstance(q.bound, ErrorBound):
                half = est_lib.z_value(confidence) * float(errs[g])
                if q.bound.relative:
                    half = (abs(half / vals[g]) if vals[g]
                            else (0.0 if half == 0.0 else float("inf")))
                realized_half = max(realized_half, half)
            groups.append(GroupResult(key, float(vals[g]), float(errs[g]),
                                      float(los[g]), float(his[g]),
                                      float(nsel[g]), exact))
        # Contract verdict: certified a-priori AND realized post-hoc.
        bound_met = None
        if isinstance(q.bound, ErrorBound):
            bound_met = bool(certified
                             and realized_half <= q.bound.eps + 1e-12)
        return Answer(q, groups, phi, k, rows_read, tbl.n_live, elapsed,
                      confidence, bound_met=bound_met, certified=certified,
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
        fn = self._quantile_programs.get(key)
        if fn is None:
            fn = exec_lib.make_quantile_fn(*key[2:])
            self._quantile_programs[key] = fn
        lo, hi = self._family_range(table_name, phi, q.value_column)
        mom, qv, dens = fn(k, vals, q.quantile, lo, hi,
                           *exec_lib.scan_args(striped))
        return mom, (qv, dens)

    def _run_quantile_at_k(self, table_name: str, q: Query,
                           phi: tuple[str, ...], k: float):
        """QUANTILE analogue of _run_at_k, timed the same way (device
        synchronised): → (mom, rows_read, dt, qpair)."""
        fam = self.families[table_name][phi]
        self._sync()
        t0 = time.perf_counter()
        mom, qpair = self._quantile_scan(q, table_name, phi, k)
        self._sync()
        dt = time.perf_counter() - t0
        return mom, fam.prefix_for_k(k), dt, qpair

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
        """One scan at k → (mom, rows_read, dt, qpair): a QUANTILE query
        runs the one-pass quantile scan, every other aggregate the fused
        scan (qpair None)."""
        self._check_supported(q)
        if q.agg is AggOp.QUANTILE:
            return self._run_quantile_at_k(table_name, q, phi, k)
        return self._run_at_k(table_name, q, phi, k) + (None,)

    def _scan_and_answer(self, q: Query, table_name: str,
                         phi: tuple[str, ...], k: float, confidence: float,
                         certified: bool | None = None,
                         predicted_half_width: float | None = None
                         ) -> Answer:
        mom, rows_read, dt, qpair = self._scan_for_query(table_name, q,
                                                         phi, k)
        return self._answer_from_moments(
            q, table_name, phi, k, mom, rows_read, dt, confidence,
            qpair=qpair, certified=certified,
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
        mom, _, _, qpair = self._scan_for_query(table_name, q, phi, k_probe)
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
        mom, _, _, qpair = self._scan_for_query(table_name, q, phi, k_top)
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

        k_q, half = (self._pilot_certify(table_name, q, phi, confidence)
                     if first is None else first)
        if k_q is not None and not self._quantile_floor_met(table_name, q,
                                                            phi, k_q):
            k_q = None
        if k_q is None and half is not None:
            # Containment refinement: the top prefix may fully contain the
            # strata the predicate touches (rate 1 ⇒ zero variance).
            k_q, half = self._certify_at_top(table_name, q, phi, confidence)
        if k_q is not None:
            return decide(phi, k_q, True, half)
        best_phi, best_half = phi, half
        if self.config.escalate_on_unreachable:
            def size(p):
                return max(fams[p].prefix_sizes)
            for p2 in sorted((p for p in fams
                              if p != phi and size(p) > size(phi)),
                             key=size):
                k2, half2 = self._pilot_certify(table_name, q, p2, confidence)
                if k2 is not None and self._quantile_floor_met(
                        table_name, q, p2, k2):
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
                    return decide(phi, float(fams[phi].ks[0]), True, 0.0,
                                  exact=True)
                raise BoundUnreachableError(
                    f"ERROR WITHIN {q.bound.eps} cannot be certified on "
                    f"table {table_name!r}: no pilot scan selected any "
                    f"row (nothing to project from)", None)
            return decide(phi, fams[phi].ks[0], False, None)
        if self.config.exact_fallback:
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
        GROUP BY columns."""
        tbl = self.tables[table_name]
        return frozenset(c for c in q.where_group_columns
                         if tbl.schema.column(c).kind is ColumnKind.CATEGORICAL)

    def _select_phi(self, table_name: str, q: Query) -> tuple[str, ...]:
        """§4.1 runtime family selection (superset rule, else probe)."""
        fams = self.families[table_name]
        cat_cols = self._selection_cat_cols(table_name, q)

        def probe(phi: tuple[str, ...]) -> tuple[float, float]:
            mom, rows_read, _ = self._run_at_k(table_name, q, phi,
                                               min(fams[phi].ks))
            return float(mom.n.sum()), float(rows_read)

        return select_family(cat_cols, fams, probe).phi

    def query(self, q: Query) -> Answer:
        """Execute with §4.1 family selection + §4.2 ELP resolution choice.
        ErrorBound queries walk the a-priori contract ladder, so every
        ErrorBound answer carries bound_met / certified /
        predicted_half_width, and a strict bound raises
        BoundUnreachableError instead of serving a best-effort answer."""
        self._check_supported(q)
        subqueries = rewrite_disjuncts(q)
        if len(subqueries) > 1:
            return _union_answers(q, [self.query(sq) for sq in subqueries])

        table_name = q.table
        phi = self._select_phi(table_name, q)
        confidence = q.bound.confidence if q.bound else 0.95
        if isinstance(q.bound, TimeBound):
            # The reuse unit is the LatencyModel, re-projected per call.
            k_q = self._pick_k_for_time(table_name, q, phi)
            return self._scan_and_answer(q, table_name, phi, k_q, confidence)
        struct, _ = exec_lib.pred_structure(
            exec_lib.bind_predicate(q.predicate, self._encode(table_name)))
        elp_key = (table_name, phi, struct, q.agg, q.value_column,
                   q.group_by, repr(q.bound))
        dec = (self._cached_decision(elp_key, table_name)
               if self.config.reuse_elp else None)
        if dec is None:
            if isinstance(q.bound, ErrorBound):
                dec = self._plan_error_bound(table_name, q, phi, confidence)
            else:   # no bound: most accurate available sample
                dec = ElpDecision(phi, self.families[table_name][phi].ks[0],
                                  None,
                                  gen=self.family_generation(table_name, phi))
            self._elp_cache[elp_key] = dec
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
                mom, _, dt = self._run_at_k(table_name, q, phi, k)
                return float(mom.n.sum()), dt
            probes = elp_lib.run_probes(
                fam, run_at_k, n_probes=self.config.probe_resolutions)
            model = elp_lib.fit_latency([p.rows_read for p in probes],
                                        [p.elapsed_s for p in probes])
            self._latency[(table_name, phi)] = model
        return elp_lib.pick_k_for_time(fam, model, q.bound.seconds,
                                       headroom_s=headroom_s)

    # ------------------------------------------------- batched shared scans
    def _plan_batch_job(self, parent: int, order: int, q: Query,
                        sel_cache: dict) -> _BatchJob:
        """Family selection for one conjunctive subquery. One selection per
        distinct (table, selection columns, template, constants) serves
        every query of the batch that maps to it."""
        self._check_supported(q)
        table_name = q.table
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
                     ) -> tuple[est_lib.GroupedMoments, float]:
        """One fused multi-query scan over a family block → (moments with
        leaves [Q, G], seconds), the device synchronised around it. Batches
        over _MAX_SCAN_BATCH run as back-to-back launches; each query's
        moments have the bits of the same query scanned alone."""
        n_q = len(ks)
        if n_q > _MAX_SCAN_BATCH:
            parts = [self._run_batched(scan_key, ks[i:i + _MAX_SCAN_BATCH],
                                       consts_list[i:i + _MAX_SCAN_BATCH])
                     for i in range(0, n_q, _MAX_SCAN_BATCH)]
            mom = est_lib.GroupedMoments.from_stacked(
                torch.cat([m.stacked() for m, _ in parts]))
            return mom, sum(d for _, d in parts)
        table_name, phi, struct = scan_key[:3]
        striped = self._striped_for(table_name, phi)
        fn = self._batched_programs.get(scan_key)
        if fn is None:
            fn = exec_lib.make_batched_query_fn(*scan_key[2:])
            self._batched_programs[scan_key] = fn
        n_atoms = len(exec_lib.flat_atoms(struct))
        ks_t = torch.tensor(list(ks), dtype=torch.float32).to(self.device)
        consts_t = torch.tensor([list(c) for c in consts_list],
                                dtype=torch.float32
                                ).reshape(n_q, n_atoms).to(self.device)
        self._sync()
        t0 = time.perf_counter()
        mom = fn(ks_t, consts_t, *exec_lib.scan_args(striped))
        self._sync()
        return mom, time.perf_counter() - t0

    def query_batch(self, queries: Sequence[Query],
                    deadline_headroom_s: float = 0.0) -> list[Answer]:
        """Execute N queries, sharing one fused scan per (table, family,
        template) group. Disjunctive queries split into conjunctive
        subqueries that join the batch individually; family selection and
        the ELP pilot scans are shared across the batch; the final pass is
        one multi-query scan per group, whose per-query slices unpack into
        ordinary Answers. A QUANTILE job takes its moments from the shared
        scan and its quantile from one quantile scan at its K.

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
        sel_cache: dict = {}
        jobs: list[_BatchJob] = []
        n_subs = [0] * len(queries)
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
            mom, _ = self._run_batched(scan_key, [k_probe] * len(group),
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
        for scan_key, group in final_groups.items():
            mom, dt = self._run_batched(scan_key, [j.k for j in group],
                                        [j.consts for j in group])
            for i, job in enumerate(group):
                fam = self.families[job.table][job.phi]
                ans = self._answer_from_moments(
                    job.q, job.table, job.phi, job.k,
                    est_lib.moments_slice(mom, i), fam.prefix_for_k(job.k),
                    dt / len(group), job.confidence,
                    certified=job.certified,
                    predicted_half_width=job.predicted_half)
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
        """Ground truth: the aggregation over the FULL base table (rate=1) on
        the engine's device. A plain segment sum (no sample kernel), summed
        in float64 so counts past 2^24 rows stay exact; QUANTILE bins the
        selected rows over their own range (executor.grouped_quantile)."""
        self._check_supported(q)
        tbl = self.tables[q.table]
        bound_pred = exec_lib.bind_predicate(q.predicate, self._encode(q.table))
        struct, vals = exec_lib.pred_structure(bound_pred)
        group_col = q.group_by[0] if q.group_by else None
        n_groups = self._column_card(q.table, group_col) if group_col else 1
        cols = tbl.columns
        self._sync()
        t0 = time.perf_counter()
        mask = exec_lib.eval_pred(struct, cols, vals)
        ones = torch.ones(tbl.n_rows, dtype=torch.float32, device=self.device)
        values = (cols[q.value_column].to(torch.float32)
                  if q.value_column else ones)
        g = (cols[group_col] if group_col
             else torch.zeros(tbl.n_rows, dtype=torch.int32, device=self.device))
        mom = est_lib.grouped_moments(values, ones, mask, g, n_groups,
                                      accumulate=torch.float64)
        if q.agg is AggOp.QUANTILE:
            # Histogram counts summed in float64 and rounded to float32:
            # the reference's float32 counts wherever no bin passes 2^24.
            qv, dens = exec_lib.grouped_quantile(
                values, mask.to(torch.float32), g, n_groups, q.quantile,
                accumulate=torch.float64)
            est = est_lib.estimate(AggOp.QUANTILE, mom, quantile_value=qv,
                                   quantile_density=dens, q=q.quantile)
        else:
            est = est_lib.estimate(q.agg, mom)
        vals_h = est.value.cpu().numpy()
        ns = est.n.cpu().numpy()
        dt = time.perf_counter() - t0
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
                  # The union claims the bound only when EVERY disjunct did.
                  bound_met=(None if all(m is None for m in mets)
                             else all(bool(m) for m in mets)),
                  certified=(None if all(c is None for c in certs)
                             else all(bool(c) for c in certs)),
                  predicted_half_width=max(preds) if preds else None)
