"""Generation-validated answer cache (counterpart of `repro.service.cache`,
pure Python).

Keys are NORMALIZED queries (types.Query.normalized — canonical atom/conjunct
order, hashable), so syntactic permutations of one query share an entry.
Values carry the sample generations the answer was computed under:

* the generation of the family the answer ran on (`Answer.sample_phi`), and
* the table's FAMILY-SET generation (a family added/dropped since could make
  §4.1 selection pick a different family for the same query).

Invalidation rides the engine's per-family invalidation matrix
(docs/MAINTENANCE.md): every point where the matrix retires derived state —
delta merges, tombstone passes, compactions, rebuilds, dimension-driven
join-gather refreshes, and the storage-reclamation epochs (base-table
compaction relabels the physical rows a family's ids point at; an
inclusion-frequency decay changes which rows are sampled at all) — bumps
that family's generation counter and fires the engine's invalidation hooks.
The cache subscribes, so appends/deletes/compactions/decays evict exactly
the entries whose family changed; entries on untouched families keep
serving. (A base compaction's bump is conservative — answers over live rows
are numerically unchanged by relabeling — but the cache deliberately does
not special-case it: one contract, "generation moved ⇒ revalidate", beats a
second code path that must stay correct forever.) Generations are re-checked
on every `get` as well, so even a cache that missed a hook (constructed
without one) can never serve a stale answer.

Disjunctive (multi-conjunct) queries union sub-answers that may come from
several families; their entries conservatively depend on every family of the
table.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict

from repro_torch.core.types import Answer, Query
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.clock import now_s


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    invalidations: int = 0    # entries evicted by generation bumps
    evictions: int = 0        # entries evicted by LRU capacity
    stale_serves: int = 0     # demoted entries served by get_stale


@dataclasses.dataclass
class _Entry:
    answer: Answer
    table: str
    # (phi, generation) dependencies + the table's family-set generation
    fam_deps: tuple[tuple[tuple[str, ...], int], ...]
    set_gen: int
    t_put: float = 0.0        # monotonic stamp at insertion (staleness age)


class AnswerCache:
    """LRU answer cache over one BlinkDB instance. Thread-safe; `get`/`put`
    take normalized queries (the caller normalizes once for cache + workload
    keys)."""

    def __init__(self, db, capacity: int = 1024, subscribe: bool = True):
        self.db = db
        self.capacity = int(capacity)
        self.stats = CacheStats()
        # CacheStats stays the tests' plain-int source of truth; every
        # increment is mirrored onto the engine's metrics registry so
        # metrics_snapshot() exports the cache plane without a second
        # bookkeeping path.
        reg = (getattr(db, "metrics", None)
               or obs_metrics.default_registry())
        self._m = reg.counter("cache_events_total",
                              "Answer-cache events by kind",
                              labels=("kind",))
        reg.gauge("cache_entries", "Live answer-cache entries"
                  ).labels().set_function(lambda: float(len(self)))
        reg.gauge("cache_stale_entries", "Demoted (stale-rung) entries"
                  ).labels().set_function(lambda: float(len(self._stale)))
        self._lock = threading.Lock()
        self._entries: OrderedDict[Query, _Entry] = OrderedDict()
        # Invalidated entries demoted here instead of discarded: the
        # degradation ladder's stale rung (docs/FAULTS.md) serves them — with
        # DECLARED staleness — when live execution fails. Never consulted by
        # `get`; bounded by the same capacity.
        self._stale: OrderedDict[Query, _Entry] = OrderedDict()
        self._subscribed = subscribe
        if subscribe:
            db.add_invalidation_listener(self._on_invalidate)

    def __len__(self) -> int:
        return len(self._entries)

    def detach(self) -> None:
        """Unhook from the engine and drop entries — a closed service's cache
        must not keep paying eviction scans on every future mutation."""
        if self._subscribed:
            self.db.remove_invalidation_listener(self._on_invalidate)
            self._subscribed = False
        with self._lock:
            self._entries.clear()
            self._stale.clear()

    # -- engine hook ---------------------------------------------------------
    def _on_invalidate(self, table: str, phi: tuple[str, ...] | None) -> None:
        """Eager eviction on a generation bump: exactly the entries that
        depend on (table, phi) — or, for a family-set change (phi None),
        every entry on the table (selection could now differ)."""
        with self._lock:
            stale = [
                q for q, e in self._entries.items()
                if e.table == table
                and (phi is None or any(p == phi for p, _ in e.fam_deps))
            ]
            for q in stale:
                self._demote(q, self._entries.pop(q))
            self.stats.invalidations += len(stale)
            self._m.labels("invalidation").inc(len(stale))

    # -- lookup / insert -----------------------------------------------------
    def _current(self, entry: _Entry) -> bool:
        if self.db.family_set_generation(entry.table) != entry.set_gen:
            return False
        return all(self.db.family_generation(entry.table, p) == g
                   for p, g in entry.fam_deps)

    def _demote(self, key: Query, entry: _Entry) -> None:
        """Move an invalidated entry to the stale store (lock held)."""
        self._stale[key] = entry
        self._stale.move_to_end(key)
        while len(self._stale) > self.capacity:
            self._stale.popitem(last=False)

    def get(self, key: Query) -> Answer | None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.stats.misses += 1
                self._m.labels("miss").inc()
                return None
            if not self._current(entry):   # belt-and-braces vs missed hooks
                self._demote(key, self._entries.pop(key))
                self.stats.invalidations += 1
                self.stats.misses += 1
                self._m.labels("invalidation").inc()
                self._m.labels("miss").inc()
                return None
            self._entries.move_to_end(key)
            self.stats.hits += 1
            self._m.labels("hit").inc()
            return entry.answer

    def get_stale(self, key: Query) -> tuple[Answer, float] | None:
        """Last-resort lookup for the degradation ladder: the most recent
        INVALIDATED answer for this query, with its age in seconds (time
        since it was computed). The caller annotates the answer
        (degraded=True, staleness_s=age) before serving — a stale answer
        must never masquerade as fresh. A live current entry is also served
        (age still declared) so the ladder needs only one lookup."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or not self._current(entry):
                entry = self._stale.get(key)
            if entry is None:
                return None
            self.stats.stale_serves += 1
            self._m.labels("stale_serve").inc()
            return entry.answer, max(0.0, now_s() - entry.t_put)

    def snapshot(self, table: str) -> dict:
        """Generations of a table's family set as of NOW — taken by the
        scheduler BEFORE executing a batch, so an answer computed against
        pre-mutation samples can never be stamped with post-mutation
        generations (a put-time read would validate it as current and serve
        stale forever if a mutation landed mid-execution)."""
        return {
            "set": self.db.family_set_generation(table),
            "fams": {p: self.db.family_generation(table, p)
                     for p in self.db.families.get(table, {})},
        }

    def put(self, key: Query, answer: Answer,
            snapshot: dict | None = None) -> None:
        table = key.table
        snap = snapshot if snapshot is not None else self.snapshot(table)
        if len(key.predicate.disjuncts) > 1:
            # Union answer: sub-answers may span several families.
            phis = list(snap["fams"])
        else:
            phis = [tuple(answer.sample_phi)]
        entry = _Entry(
            answer=answer, table=table,
            fam_deps=tuple((p, snap["fams"].get(p, 0)) for p in phis),
            set_gen=snap["set"], t_put=now_s())
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            # A fresh answer supersedes any demoted one for the same query.
            self._stale.pop(key, None)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.stats.evictions += 1
                self._m.labels("eviction").inc()
