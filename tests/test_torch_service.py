"""Port parity and contracts: the BlinkQL service layer.

Against the reference (`repro`; the port on the CPU with the reference's
sample units): the reference tests' BlinkQL strings parse to equal queries,
field by field with enums by name, and to equal normalized() keys; both
packages refuse the same statements with the same message (a fractional
literal on an int dictionary among them); and BlinkQLService answers the
same strings equally (rtol 1e-4), with the same cache hits, invalidation
on append, stale serves, degraded answers, shedding and exhausted ladder,
counted the same.

Then the reference's tests/test_service.py contracts on the port: the
parser, normalization, the answer cache, the workload monitor, the
scheduler (coalesced answers bit-identical to BlinkDB.query on the same
engine, from eight sessions; admission control; error isolation; the solo
bypass; the workload-driven re-optimization epoch), the TimeBound headroom
and the stale serve's demoted verdict.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import sampling as ref_samp
from repro.core import table as ref_table
from repro.data import synth as ref_synth
from repro.fault import inject as ref_inject
from repro.service import BlinkQLError as RefBlinkQLError
from repro.service import BlinkQLService as RefService
from repro.service import ServiceConfig as RefServiceConfig
from repro.service import parse_blinkql as ref_parse
from repro_torch import state
from repro_torch.core import (AggOp, Atom, BlinkDB, CmpOp, Conjunction,
                              EngineConfig, ErrorBound, Predicate, Query,
                              QueryTemplate, TimeBound)
from repro_torch.core import elp as elp_lib
from repro_torch.core import table as table_lib
from repro_torch.core.maintenance import MaintenanceConfig, SampleMaintainer
from repro_torch.core.types import Answer, GroupResult
from repro_torch.data import synth
from repro_torch.fault import inject
from repro_torch.fault.inject import FaultError
from repro_torch.service import (AdmissionError, BlinkQLError,
                                 BlinkQLService, DeadlineShedError,
                                 DegradedServiceError, ServiceConfig,
                                 WorkloadConfig, WorkloadMonitor,
                                 parse_blinkql)
from repro_torch.service.cache import AnswerCache
from repro_torch.service.workload import _met_bound

N_ROWS, DATA_SEED, SEED = 20_000, 2, 1
FAMILIES = (("City",), ("OS",), ())


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _db(n_rows=N_ROWS, seed=DATA_SEED, k1=400.0):
    db = BlinkDB(EngineConfig(k1=k1, m=3, seed=SEED), device="cpu")
    db.register_table("sessions", table_lib.from_columns(
        "sessions", synth.sessions_table(n_rows, seed=seed)))
    state.install_families(db, "sessions", {
        phi: ref_samp.base_units(n_rows, SEED, uniform=(phi == ()))
        for phi in FAMILIES})
    return db


def _ref_db(n_rows=N_ROWS, seed=DATA_SEED, k1=400.0):
    db = R.BlinkDB(R.EngineConfig(k1=k1, m=3, seed=SEED))
    db.register_table("sessions", ref_table.from_columns(
        "sessions", ref_synth.sessions_table(n_rows, seed=seed)))
    for phi in FAMILIES:
        db.add_family("sessions", phi)
    return db


@pytest.fixture(scope="module")
def parsers():
    """A table registered in each package (no families): what the parser
    resolves against."""
    ref = R.BlinkDB(R.EngineConfig())
    ref.register_table("sessions", ref_table.from_columns(
        "sessions", ref_synth.sessions_table(5_000, seed=DATA_SEED)))
    port = BlinkDB(EngineConfig(), device="cpu")
    port.register_table("sessions", table_lib.from_columns(
        "sessions", synth.sessions_table(5_000, seed=DATA_SEED)))
    for db, m in ((ref, ref_table), (port, table_lib)):
        db.register_table("ints", m.from_columns(
            "ints", {"k": np.array([17, 18, 17], np.int64),
                     "v": np.array([1.0, 2.0, 3.0], np.float32)},
            categorical=["k"]))
    return ref, port


def _assert_bit_identical(a, b):
    assert a.sample_phi == b.sample_phi
    assert a.sample_k == b.sample_k
    ka = {g.key: g for g in a.groups}
    kb = {g.key: g for g in b.groups}
    assert ka.keys() == kb.keys()
    for key in ka:
        assert ka[key].estimate == kb[key].estimate
        assert ka[key].stderr == kb[key].stderr
        assert ka[key].ci_low == kb[key].ci_low
        assert ka[key].ci_high == kb[key].ci_high


# ------------------------------------------------------ parity: the parser

def _fields(q):
    """A query as plain data: enums by name, bounds by type and fields."""
    def value(v):
        return (type(v).__name__, v)
    bound = (None if q.bound is None else
             (type(q.bound).__name__, dataclasses.astuple(q.bound)))
    return (q.table, q.agg.name, q.value_column,
            tuple(tuple((a.column, a.op.name, value(a.value))
                        for a in c.atoms) for c in q.predicate.disjuncts),
            q.group_by, q.quantile, bound, q.joins)


PARSED = [
    "SELECT AVG(SessionTime) FROM sessions WHERE City = 'city003' AND "
    "Bitrate >= 700 GROUP BY OS ERROR WITHIN 10% AT CONFIDENCE 99%",
    "SELECT COUNT(*) FROM sessions WHERE OS = 'os1' AND Bitrate > 900 "
    "OR OS = 'os2' WITHIN 2 SECONDS",
    "SELECT QUANTILE(SessionTime, 0.9) FROM sessions",
    "SELECT SUM(Bitrate) FROM sessions ERROR WITHIN 500 CONFIDENCE 90%",
    r"SELECT COUNT(*) FROM sessions WHERE City = 'O\'Hare'",
    "SELECT COUNT(*) FROM sessions GROUP BY OS "
    "ERROR WITHIN 5% AT CONFIDENCE 99% OR FAIL",
    "SELECT COUNT(*) FROM sessions WHERE OS = 'os1' OR OS = 'os2' "
    "ERROR WITHIN 5% OR FAIL",
    "select count(*) FROM sessions WHERE City = 'city000' ERROR WITHIN 10%",
    "SELECT AVG(SessionTime) FROM sessions WHERE City = 'city003' "
    "ERROR WITHIN 10% CONFIDENCE 95%",
    "SELECT COUNT(SessionTime) FROM sessions WHERE City = 'city001' "
    "WITHIN 0.05 SECONDS",
    "SELECT PERCENTILE(Bitrate, 0.5) FROM sessions WHERE dt < 15 "
    "AND Genre != 'genre03' GROUP BY City",
    "SELECT SUM(v) FROM ints WHERE k = 17",
    "SELECT COUNT(*) FROM sessions WHERE OS = 'os1' AND URL = 'url003' "
    "ERROR WITHIN 20%",
]


@pytest.mark.parametrize("text", PARSED)
def test_parse_matches_the_reference(parsers, text):
    ref, port = parsers
    a, b = ref_parse(text, ref), parse_blinkql(text, port)
    assert _fields(b) == _fields(a)
    assert _fields(b.normalized()) == _fields(a.normalized())
    assert _fields(b.normalized().normalized()) == _fields(b.normalized())


REFUSED = [
    "SELECT COUNT(*) FROM nope",
    "SELECT COUNT(*) FROM sessions WHERE Cty = 'x'",
    "SELECT AVG(SessionTime) FROM sessions GROUP BY SessionTime",
    "SELECT AVG(SessionTime) FROM sessions GROUP BY City, OS",
    "SELECT MEDIAN(SessionTime) FROM sessions",
    "SELECT AVG(*) FROM sessions",
    "SELECT COUNT(*) FROM sessions WHERE SessionTime = 'fast'",
    "SELECT COUNT(*) FROM sessions WHERE SessionTime = fast",
    "SELECT COUNT(*) FROM sessions WHERE City ",
    "SELECT COUNT(*) FROM sessions ERROR WITHIN -5%",
    "SELECT COUNT(*) FROM sessions WITHIN 2",
    "SELECT COUNT(*) FROM sessions trailing",
    "SELECT QUANTILE(SessionTime, 1.5) FROM sessions",
    "SELECT AVG(City) FROM sessions",
    "SELECT SUM(v) FROM ints WHERE k = 17.9",
    "SELECT COUNT(*) FROM sessions WHERE sessions.City = 'x'",
    "SELECT COUNT(*) FROM sessions WHERE City = 'x' @",
    "SHOW METRICS",
]


@pytest.mark.parametrize("text", REFUSED)
def test_parse_refuses_what_the_reference_refuses(parsers, text):
    ref, port = parsers
    with pytest.raises(RefBlinkQLError) as want:
        ref_parse(text, ref)
    with pytest.raises(BlinkQLError) as got:
        parse_blinkql(text, port)
    assert str(got.value) == str(want.value)


# ------------------------------------------- parity: the service end to end

SERVED = [
    "SELECT SUM(SessionTime) FROM sessions WHERE City = 'city002' "
    "ERROR WITHIN 10% CONFIDENCE 95%",
    "SELECT AVG(SessionTime) FROM sessions GROUP BY OS ERROR WITHIN 10%",
    "SELECT COUNT(*) FROM sessions WHERE OS = 'os1' OR OS = 'os2'",
    "SELECT COUNT(*) FROM sessions WHERE City = 'city000' ERROR WITHIN 10%",
    "SELECT AVG(SessionTime) FROM sessions WHERE City = 'city003' "
    "ERROR WITHIN 0.0001% CONFIDENCE 95%",
]


def _same_answer(a, b):
    assert b.sample_phi == a.sample_phi and b.sample_k == a.sample_k
    assert (b.degraded, b.shards_lost, b.shards_total) == \
        (a.degraded, a.shards_lost, a.shards_total)
    assert (b.staleness_s > 0) == (a.staleness_s > 0)
    assert (b.bound_met, b.certified) == (a.bound_met, a.certified)
    assert [g.key for g in b.groups] == [g.key for g in a.groups]
    for ga, gb in zip(a.groups, b.groups):
        for f in ("estimate", "stderr", "ci_low", "ci_high"):
            np.testing.assert_allclose(getattr(gb, f), getattr(ga, f),
                                       rtol=1e-4, atol=1e-9, err_msg=f)


def _script(svc, db, m_inject, m_synth, cities):
    """One scripted service session → [(step, answer or error name)]."""
    out = []

    def submit(step, text):
        try:
            out.append((step, svc.submit(text)))
        except Exception as e:   # noqa: BLE001 — compared by name
            out.append((step, type(e).__name__))

    for i, text in enumerate(SERVED):
        submit(f"first{i}", text)
    for i, text in enumerate(SERVED[:2]):
        submit(f"repeat{i}", text)                    # cache hits
    raw = {c: np.asarray(v)[:300] for c, v in
           m_synth.sessions_table(300, seed=7).items()}
    db.append_rows("sessions", raw)                    # invalidates
    submit("after_append", SERVED[0])
    svc.cache._on_invalidate("sessions", None)         # demote to stale
    kill = m_inject.FaultPlan([m_inject.FaultSpec(site="engine.scan",
                                                  kind="kill")], seed=0)
    with m_inject.arm(kill):
        submit("stale", SERVED[0])
        submit("exhausted", SERVED[2].replace("os2", "os3"))
    lose = m_inject.FaultPlan([m_inject.FaultSpec(
        site="shard.scan", kind="kill", match=(("shard", 1),))], seed=0)
    with m_inject.arm(lose):
        submit("degraded", SERVED[1].replace("10%", "20%"))
    svc._exec_ewma = 10.0
    submit("shed", "SELECT COUNT(*) FROM sessions WHERE City = "
                   f"'{cities[1]}' WITHIN 0.05 SECONDS")
    return out


def test_service_matches_the_reference():
    ref, port = _ref_db(), _db()
    cities = port.tables["sessions"].dictionaries["City"]
    # The queued path: the solo bypass skips admission, and so shedding.
    cfg = dict(use_cache=True, solo_bypass=False, batch_window_s=0.0)
    with RefService(ref, config=RefServiceConfig(**cfg)) as a, \
            BlinkQLService(port, config=ServiceConfig(**cfg)) as b:
        want = _script(a, ref, ref_inject, ref_synth, cities)
        got = _script(b, port, inject, synth, cities)
        stats_a, stats_b = a.stats(), b.stats()
    assert [s for s, _ in got] == [s for s, _ in want]
    for (step, x), (_, y) in zip(want, got):
        if isinstance(x, str):
            assert y == x, step
        else:
            assert not isinstance(y, str), (step, y)
            _same_answer(x, y)
    assert dict(got)["exhausted"] == "DegradedServiceError"
    assert dict(got)["shed"] == "DeadlineShedError"
    assert dict(got)["stale"].staleness_s > 0
    assert dict(got)["degraded"].degraded
    assert stats_b == stats_a
    # Admission: a full queue refuses, with the same message.
    full = dict(solo_bypass=False, max_queue=0)
    with RefService(ref, config=RefServiceConfig(**full)) as a, \
            BlinkQLService(port, config=ServiceConfig(**full)) as b:
        with pytest.raises(AdmissionError) as err_b:
            b.submit(SERVED[0])
        with pytest.raises(Exception) as err_a:
            a.submit(SERVED[0])
    assert type(err_a.value).__name__ == "AdmissionError"
    assert str(err_b.value) == str(err_a.value)


# ---------------------------------------------------------------- parser

def test_parse_full_statement():
    db = _db(5_000)
    city = db.tables["sessions"].dictionaries["City"][3]
    q = parse_blinkql(
        f"SELECT AVG(SessionTime) FROM sessions WHERE City = '{city}' "
        f"AND Bitrate >= 700 GROUP BY OS ERROR WITHIN 10% AT CONFIDENCE 99%",
        db)
    assert q.table == "sessions" and q.agg is AggOp.AVG
    assert q.value_column == "SessionTime" and q.group_by == ("OS",)
    assert q.predicate == Predicate.where(Atom("City", CmpOp.EQ, str(city)),
                                          Atom("Bitrate", CmpOp.GE, 700.0))
    assert q.bound == ErrorBound(0.10, 0.99, relative=True)


def test_parse_dnf_time_bound_and_quantile():
    db = _db(5_000)
    q = parse_blinkql(
        "SELECT COUNT(*) FROM sessions WHERE OS = 'os1' AND Bitrate > 900 "
        "OR OS = 'os2' WITHIN 2 SECONDS", db)
    assert q.agg is AggOp.COUNT and q.value_column is None
    assert len(q.predicate.disjuncts) == 2
    assert q.predicate.disjuncts[0].atoms == (
        Atom("OS", CmpOp.EQ, "os1"), Atom("Bitrate", CmpOp.GT, 900.0))
    assert q.bound == TimeBound(2.0, 0.95)
    q2 = parse_blinkql("SELECT QUANTILE(SessionTime, 0.9) FROM sessions", db)
    assert q2.agg is AggOp.QUANTILE and q2.quantile == 0.9
    assert q2.bound is None and q2.predicate == Predicate.true()


def test_parse_absolute_error_bound():
    db = _db(5_000)
    q = parse_blinkql(
        "SELECT SUM(Bitrate) FROM sessions ERROR WITHIN 500 CONFIDENCE 90%",
        db)
    assert q.bound == ErrorBound(500.0, 0.90, relative=False)


@pytest.mark.parametrize("text,fragment", [
    ("SELECT COUNT(*) FROM nope", "unknown table"),
    ("SELECT COUNT(*) FROM sessions WHERE Cty = 'x'", "did you mean 'City'"),
    ("SELECT AVG(SessionTime) FROM sessions GROUP BY SessionTime",
     "must be categorical"),
    ("SELECT AVG(SessionTime) FROM sessions GROUP BY City, OS",
     "single column"),
    ("SELECT MEDIAN(SessionTime) FROM sessions", "unknown aggregate"),
    ("SELECT AVG(*) FROM sessions", "only valid for COUNT"),
    ("SELECT COUNT(*) FROM sessions WHERE SessionTime = 'fast'",
     "is numeric"),
    ("SELECT COUNT(*) FROM sessions WHERE SessionTime = fast",
     "does not parse as a number"),
    ("SELECT COUNT(*) FROM sessions WHERE City ", "comparison operator"),
    ("SELECT COUNT(*) FROM sessions ERROR WITHIN -5%", "must be positive"),
    ("SELECT COUNT(*) FROM sessions WITHIN 2", "expected SECONDS"),
    ("SELECT COUNT(*) FROM sessions trailing", "trailing"),
    ("SELECT QUANTILE(SessionTime, 1.5) FROM sessions", "in (0, 1)"),
    ("SELECT AVG(City) FROM sessions", "categorical column"),
])
def test_parse_errors_are_precise(parsers, text, fragment):
    _, db = parsers
    with pytest.raises(BlinkQLError) as ei:
        parse_blinkql(text, db)
    assert fragment in str(ei.value)


def test_parse_unescapes_string_literals(parsers):
    q = parse_blinkql(r"SELECT COUNT(*) FROM sessions WHERE City = 'O\'Hare'",
                      parsers[1])
    assert q.predicate.disjuncts[0].atoms[0].value == "O'Hare"


def test_parse_rejects_fractional_literal_on_int_dictionary(parsers):
    db = parsers[1]
    q = parse_blinkql("SELECT SUM(v) FROM ints WHERE k = 17", db)
    assert q.predicate.disjuncts[0].atoms[0].value == 17
    with pytest.raises(BlinkQLError, match="fractional"):
        parse_blinkql("SELECT SUM(v) FROM ints WHERE k = 17.9", db)


def test_parsed_int_literal_encodes_through_the_port_dictionary(parsers):
    """The parser coerces to the dictionary's dtype and the engine's encode
    maps it to its code: SUM(v) WHERE k = 17 is the two rows of 17."""
    db = parsers[1]
    db.add_family("ints", ())
    ans = db.exact_query(parse_blinkql("SELECT SUM(v) FROM ints "
                                       "WHERE k = 17", db))
    assert [g.estimate for g in ans.groups] == [4.0]


def test_normalized_is_permutation_invariant_and_hashable():
    a1 = Atom("City", CmpOp.EQ, np.str_("x"))
    a2 = Atom("OS", CmpOp.NE, "os1")
    a3 = Atom("Bitrate", CmpOp.GT, np.float32(700.0))
    p = Predicate((Conjunction((a1, a2, a3)), Conjunction((a2,))))
    p_perm = Predicate((Conjunction((a2,)), Conjunction((a3, a2, a1))))
    q1 = Query("t", AggOp.COUNT, "x", p).normalized()
    q2 = Query("t", AggOp.COUNT, None, p_perm).normalized()
    assert q1 == q2 and hash(q1) == hash(q2)
    assert q1.normalized() == q1
    q3 = Query("t", AggOp.SUM, "x", p).normalized()
    q4 = Query("t", AggOp.SUM, "y", p).normalized()
    assert q3 != q4


# ------------------------------------------------------- answer cache

def test_cache_hit_and_per_family_invalidation():
    db = _db()
    cache = AnswerCache(db)
    cities = db.tables["sessions"].dictionaries["City"]
    q_city = Query("sessions", AggOp.COUNT,
                   predicate=Predicate.where(Atom("City", CmpOp.EQ,
                                                  cities[0])),
                   bound=ErrorBound(0.15)).normalized()
    q_os = Query("sessions", AggOp.AVG, "SessionTime",
                 group_by=("OS",), bound=ErrorBound(0.1)).normalized()
    a_city, a_os = db.query(q_city), db.query(q_os)
    assert a_city.sample_phi == ("City",) and a_os.sample_phi == ("OS",)
    cache.put(q_city, a_city)
    cache.put(q_os, a_os)
    assert cache.get(q_city) is a_city and cache.get(q_os) is a_os
    assert db.compact_family("sessions", ("City",))
    assert cache.get(q_city) is None
    assert cache.get(q_os) is a_os
    assert cache.stats.invalidations == 1


def test_cache_rides_append_delete_invalidation():
    db = _db()
    cache = AnswerCache(db)
    db.register_table("other", table_lib.from_columns(
        "other", {"k": np.array(["a", "b", "a", "c"]),
                  "v": np.array([1.0, 2.0, 3.0, 4.0], np.float32)}))
    db.add_family("other", ())
    q1 = Query("sessions", AggOp.COUNT, bound=ErrorBound(0.2)).normalized()
    q2 = Query("other", AggOp.SUM, "v").normalized()
    cache.put(q1, db.query(q1))
    cache.put(q2, db.query(q2))
    raw = {c: np.asarray(v)[:200]
           for c, v in synth.sessions_table(200, seed=9).items()}
    db.append_rows("sessions", raw)
    assert cache.get(q1) is None
    assert cache.get(q2) is not None
    cache.put(q1, db.query(q1))
    db.delete_rows("sessions", Predicate.where(Atom("OS", CmpOp.EQ, "os1")))
    assert cache.get(q1) is None
    assert cache.get(q2) is not None


@pytest.mark.parametrize("subscribe", [True, False])
def test_cache_never_serves_an_answer_a_mutation_outdated(subscribe):
    """An answer stored under the generations of a snapshot taken before a
    mutation is born stale (the scheduler's race); and a cache without the
    engine hook re-checks generations on get."""
    db = _db(8_000)
    cache = AnswerCache(db, subscribe=subscribe)
    q = Query("sessions", AggOp.COUNT, bound=ErrorBound(0.2)).normalized()
    snap = cache.snapshot("sessions")
    ans = db.query(q)
    raw = {c: np.asarray(v)[:100]
           for c, v in synth.sessions_table(100, seed=5).items()}
    db.append_rows("sessions", raw)
    cache.put(q, ans, snapshot=snap if subscribe else None)
    if not subscribe:
        db.append_rows("sessions", raw)
    assert cache.get(q) is None


# ------------------------------------------------------- workload monitor

def test_workload_monitor_drift_and_templates():
    mon = WorkloadMonitor.from_templates(
        [QueryTemplate(frozenset({"City"}), 1.0)],
        WorkloadConfig(window=64, min_queries=8, drift_threshold=0.4))
    q_city = Query("sessions", AggOp.COUNT,
                   predicate=Predicate.where(Atom("City", CmpOp.EQ, "c")))
    q_osurl = Query("sessions", AggOp.COUNT,
                    predicate=Predicate.where(Atom("OS", CmpOp.EQ, "o"),
                                              Atom("URL", CmpOp.EQ, "u")))
    for _ in range(4):
        mon.record(q_city)
    assert mon.drift_score("sessions") == 0.0
    assert not mon.should_reoptimize("sessions")
    for _ in range(12):
        mon.record(q_osurl)
    assert mon.drift_score("sessions") == pytest.approx(12 / 16)
    assert mon.should_reoptimize("sessions")
    tpl = mon.templates("sessions")
    assert tpl[0].columns == frozenset({"OS", "URL"})
    assert tpl[0].weight == pytest.approx(12 / 16)
    mon.rebase(tpl)
    assert not mon.should_reoptimize("sessions")


def test_workload_monitor_target_stats():
    mon = WorkloadMonitor()
    db = _db(8_000)
    city = db.tables["sessions"].dictionaries["City"][0]
    q = Query("sessions", AggOp.COUNT,
              predicate=Predicate.where(Atom("City", CmpOp.EQ, city)),
              bound=ErrorBound(0.1))
    mon.record(q, db.query(q))
    st = mon.template_stats[("sessions", frozenset({"City"}))]
    assert st.n == 1 and st.bound_met + st.bound_missed == 1


def test_met_bound_uses_ci_half_width():
    q = Query("t", AggOp.AVG, "v", bound=ErrorBound(0.10, 0.95))
    groups = [GroupResult((), 100.0, 8.0, 0.0, 0.0, 50.0)]
    assert _met_bound(q, Answer(q, groups, ("x",), 1.0, 10, 100, 0.01,
                                0.95)) is False
    groups_ok = [GroupResult((), 100.0, 4.0, 0.0, 0.0, 50.0)]
    assert _met_bound(q, Answer(q, groups_ok, ("x",), 1.0, 10, 100,
                                0.01, 0.95)) is True


def test_failed_epoch_keeps_drift_baseline():
    mon = WorkloadMonitor.from_templates(
        [QueryTemplate(frozenset({"City"}), 1.0)],
        WorkloadConfig(window=32, min_queries=4, drift_threshold=0.3))
    q = Query("sessions", AggOp.COUNT,
              predicate=Predicate.where(Atom("OS", CmpOp.EQ, "o")))
    for _ in range(8):
        mon.record(q)
    assert mon.should_reoptimize("sessions")
    drift_before = mon.drift_score("sessions")
    mon.defer()
    assert mon.drift_score("sessions") == drift_before
    assert not mon.should_reoptimize("sessions")
    for _ in range(8):
        mon.record(q)
    assert mon.should_reoptimize("sessions")


# ------------------------------------------------------- scheduler

def _sessions(svc, items, n=None):
    """Submit items[i] from session thread i, all released together."""
    n = len(items) if n is None else n
    barrier = threading.Barrier(n)
    got: dict[int, object] = {}

    def session(i):
        barrier.wait()
        try:
            got[i] = svc.submit(items[i])
        except Exception as e:   # noqa: BLE001 — the caller inspects it
            got[i] = e

    threads = [threading.Thread(target=session, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a session hung"
    return got


def test_service_end_to_end_matches_programmatic_query():
    """BlinkQL text from eight sessions → coalesced shared scans → answers
    bit-identical to BlinkDB.query() on the same engine."""
    db = _db()
    cities = db.tables["sessions"].dictionaries["City"]
    texts = [
        f"SELECT SUM(SessionTime) FROM sessions WHERE City = '{c}' "
        f"ERROR WITHIN 10% CONFIDENCE 95%" for c in cities[:6]
    ] + ["SELECT AVG(SessionTime) FROM sessions GROUP BY OS ERROR WITHIN 10%",
         "SELECT COUNT(*) FROM sessions WHERE OS = 'os1' OR OS = 'os2'"]
    with BlinkQLService(db, config=ServiceConfig(batch_window_s=0.02,
                                                 use_cache=False)) as svc:
        got = _sessions(svc, texts)
        assert svc.n_batches < len(texts), "nothing coalesced"
    for i, text in enumerate(texts):
        _assert_bit_identical(db.query(parse_blinkql(text, db).normalized()),
                              got[i])


def test_service_concurrent_mixed_bounds_and_deadline_k():
    db = _db()
    cities = db.tables["sessions"].dictionaries["City"]
    window = 0.01
    bounds = [ErrorBound(0.1), ErrorBound(0.05, 0.99), None,
              TimeBound(5.0), ErrorBound(0.2)]
    queries = [Query("sessions", AggOp.SUM, "SessionTime",
                     predicate=Predicate.where(Atom("City", CmpOp.EQ,
                                                    cities[i])), bound=b)
               for i, b in enumerate(bounds)]
    with BlinkQLService(db, config=ServiceConfig(batch_window_s=window,
                                                 use_cache=False)) as svc:
        got = _sessions(svc, queries)
    for i, q in enumerate(queries):
        if not isinstance(q.bound, TimeBound):
            _assert_bit_identical(db.query(q.normalized()), got[i])
    ans = got[3]
    fam = db.families["sessions"][tuple(ans.sample_phi)]
    model = db._latency[("sessions", tuple(ans.sample_phi))]
    assert ans.sample_k == elp_lib.pick_k_for_time(
        fam, model, bounds[3].seconds, headroom_s=window)


def test_service_cache_serves_repeats_and_invalidates_on_append():
    db = _db()
    city = db.tables["sessions"].dictionaries["City"][0]
    text = (f"SELECT COUNT(*) FROM sessions WHERE City = '{city}' "
            f"ERROR WITHIN 10%")
    with BlinkQLService(db, config=ServiceConfig(batch_window_s=0.0)) as svc:
        a1 = svc.submit(text)
        a2 = svc.submit("select count(*) FROM sessions "
                        f"WHERE City = '{city}' ERROR WITHIN 10%")
        assert svc.cache.stats.hits == 1
        assert dataclasses.replace(a2, trace=None, timings=None) == \
            dataclasses.replace(a1, trace=None, timings=None)
        assert a2.trace is not None and a2.trace.find("cache")
        raw = {c: np.asarray(v)[:300]
               for c, v in synth.sessions_table(300, seed=7).items()}
        db.append_rows("sessions", raw)
        a3 = svc.submit(text)
        assert a3 is not a1
        assert a3.rows_total == a1.rows_total + 300


def test_service_admission_control_rejects_past_max_queue():
    db = _db(5_000)
    release, entered = threading.Event(), threading.Event()
    orig = db.query_batch

    def slow_batch(queries, **kw):
        entered.set()
        release.wait(30)
        return orig(queries, **kw)

    db.query_batch = slow_batch
    cities = db.tables["sessions"].dictionaries["City"]
    cfg = ServiceConfig(batch_window_s=0.0, max_queue=2, max_batch=1,
                        use_cache=False, solo_bypass=False)
    errors, answers = [], []
    with BlinkQLService(db, config=cfg) as svc:
        def session(i):
            q = Query("sessions", AggOp.COUNT, predicate=Predicate.where(
                Atom("City", CmpOp.EQ, cities[i])))
            try:
                answers.append(svc.submit(q))
            except AdmissionError as e:
                errors.append(e)

        threads = [threading.Thread(target=session, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        assert entered.wait(30)
        # One request executes, two queue: the other five are refused.
        while len(errors) + len(svc._queue) < 7:
            threading.Event().wait(0.001)
        release.set()
        for t in threads:
            t.join(timeout=60)
    assert errors, "queue never rejected despite max_queue=2"
    assert answers, "admitted requests must still be answered"


def test_service_propagates_engine_errors_and_isolates_them():
    """An AVG over OR disjuncts fails for its submitter alone: the
    dispatcher survives and the other sessions of its window answer."""
    db = _db(8_000)
    good = "SELECT COUNT(*) FROM sessions WHERE OS = 'os1'"
    bad = ("SELECT AVG(SessionTime) FROM sessions "
           "WHERE OS = 'os1' OR OS = 'os2'")
    with BlinkQLService(db, config=ServiceConfig(batch_window_s=0.05,
                                                 use_cache=False)) as svc:
        with pytest.raises(ValueError, match="additive"):
            svc.submit(bad)
        assert svc.submit("SELECT COUNT(*) FROM sessions").groups
        got = _sessions(svc, [good, good, good, bad])
    for i in range(3):
        assert got[i].groups, f"session {i} was poisoned"
    assert isinstance(got[3], ValueError)


def test_close_detaches_cache_listener():
    db = _db(5_000)
    n_before = len(db._invalidation_listeners)
    svc = BlinkQLService(db, config=ServiceConfig(batch_window_s=0.0))
    assert len(db._invalidation_listeners) == n_before + 1
    svc.submit("SELECT COUNT(*) FROM sessions")
    svc.close()
    assert len(db._invalidation_listeners) == n_before
    assert len(svc.cache) == 0


def test_workload_churn_triggers_reoptimization_epoch():
    """A template-churn-only workload (no data delta) triggers a §3.2
    re-optimization epoch that changes the family set."""
    db = BlinkDB(EngineConfig(k1=400.0, m=3, seed=SEED), device="cpu")
    db.register_table("sessions", table_lib.from_columns(
        "sessions", synth.sessions_table(30_000, seed=DATA_SEED)))
    templates = [QueryTemplate(frozenset({"City"}), 1.0)]
    db.build_samples("sessions", templates, storage_budget_fraction=1.0)
    maint = SampleMaintainer(
        db, "sessions", templates,
        MaintenanceConfig(change_fraction=1.0, storage_budget_fraction=1.0))
    cfg = ServiceConfig(batch_window_s=0.0,
                        workload=WorkloadConfig(window=64, min_queries=10,
                                                drift_threshold=0.4))
    before = set(db.families["sessions"])
    n_rows_before = db.tables["sessions"].n_rows
    with BlinkQLService(db, maintainer=maint, config=cfg) as svc:
        urls = db.tables["sessions"].dictionaries["URL"]
        for i in range(40):
            svc.submit("SELECT COUNT(*) FROM sessions WHERE OS = 'os1' "
                       f"AND URL = '{urls[i % 8]}' ERROR WITHIN 20%")
        done = threading.Event()
        for _ in range(5000):
            if svc.workload_epochs or done.wait(0.001):
                break
        assert svc.workload_epochs, "drifted workload never triggered"
        report = svc.workload_epochs[0]
        assert "error" not in report
        assert report["added"] or report["dropped"]
        assert set(db.families["sessions"]) != before
        assert db.tables["sessions"].n_rows == n_rows_before
        assert svc.submit("SELECT COUNT(*) FROM sessions "
                          "WHERE OS = 'os1' ERROR WITHIN 20%").groups


# ------------------------------------------------------- solo bypass

def test_solo_bypass_skips_window_and_matches_query():
    db = _db(8_000)
    city = db.tables["sessions"].dictionaries["City"][0]
    q = Query("sessions", AggOp.COUNT,
              predicate=Predicate.where(Atom("City", CmpOp.EQ, city)),
              bound=ErrorBound(0.1)).normalized()
    db.query(q)
    window = 0.5
    with BlinkQLService(db, config=ServiceConfig(batch_window_s=window,
                                                 use_cache=False)) as svc:
        lat, answers = [], []
        for _ in range(5):
            t0 = time.monotonic()
            answers.append(svc.submit(q))
            lat.append(time.monotonic() - t0)
        stats = svc.stats()
    assert max(lat) < window / 2, lat
    assert stats["queries"] == 5
    for a in answers:
        _assert_bit_identical(db.query(q), a)


def test_solo_bypass_still_serves_cache_and_monitor():
    db = _db(8_000)
    city = db.tables["sessions"].dictionaries["City"][1]
    text = (f"SELECT COUNT(*) FROM sessions WHERE City = '{city}' "
            f"ERROR WITHIN 10%")
    with BlinkQLService(db, config=ServiceConfig(batch_window_s=0.3)) as svc:
        a1 = svc.submit(text)
        a2 = svc.submit(text)
        assert svc.cache.stats.hits == 1
        assert dataclasses.replace(a2, trace=None, timings=None) == \
            dataclasses.replace(a1, trace=None, timings=None)
        assert svc.monitor.template_stats[
            ("sessions", frozenset({"City"}))].n == 2


def test_concurrent_burst_still_coalesces_with_bypass_enabled():
    db = _db(8_000)
    cities = db.tables["sessions"].dictionaries["City"]
    texts = [f"SELECT COUNT(*) FROM sessions WHERE City = '{c}' "
             f"ERROR WITHIN 20%" for c in cities[:8]]
    for t in texts:
        db.query(parse_blinkql(t, db).normalized())
    with BlinkQLService(db, config=ServiceConfig(batch_window_s=0.05,
                                                 use_cache=False)) as svc:
        got = _sessions(svc, texts)
        assert svc.n_batches <= 3, "burst did not coalesce under bypass"
    for i, text in enumerate(texts):
        _assert_bit_identical(db.query(parse_blinkql(text, db).normalized()),
                              got[i])


def test_submit_and_submit_many_from_threads_equal_query():
    """Eight sessions mixing submit and submit_many over QUANTILE, GROUP BY
    and disjunctive strings: every answer bit-identical to BlinkDB.query on
    the same engine, repeats then served from the cache."""
    db = _db(8_000)
    texts = [
        "SELECT QUANTILE(SessionTime, 0.5) FROM sessions GROUP BY OS "
        "ERROR WITHIN 10%",
        "SELECT AVG(Bitrate) FROM sessions WHERE Genre = 'genre01' "
        "ERROR WITHIN 10%",
        "SELECT COUNT(*) FROM sessions WHERE City = 'city001' OR "
        "City = 'city002' ERROR WITHIN 20%",
        "SELECT SUM(SessionTime) FROM sessions GROUP BY City "
        "ERROR WITHIN 20%",
    ]
    with BlinkQLService(db, config=ServiceConfig(batch_window_s=0.01)) as svc:
        got: dict = {}

        def one(i):
            if i % 2:
                got[i] = svc.submit_many(texts, timeout=120)
            else:
                got[i] = [svc.submit(texts[i % len(texts)])]
        threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        hits = svc.cache.stats.hits
        again = svc.submit_many(texts)
        assert svc.cache.stats.hits == hits + len(texts)
    want = {t: db.query(parse_blinkql(t, db).normalized()) for t in texts}
    for i, answers in got.items():
        sent = texts if i % 2 else [texts[i % len(texts)]]
        for t, a in zip(sent, answers):
            _assert_bit_identical(want[t], a)
    for t, a in zip(texts, again):
        _assert_bit_identical(want[t], a)


# ------------------------------------------------------- elp headroom

def test_pick_k_for_time_headroom_monotone():
    db = _db(10_000)
    fam = db.families["sessions"][("City",)]
    model = elp_lib.LatencyModel(a=1e-4, b=0.0)
    ks = [elp_lib.pick_k_for_time(fam, model, 0.5, headroom_s=h)
          for h in (0.0, 0.2, 0.45, 0.5)]
    assert ks == sorted(ks, reverse=True)
    assert elp_lib.pick_k_for_time(fam, model, 0.5) == ks[0]


def test_families_stay_host_only_through_mutations():
    """Merges and tombstones keep families as host arrays (only the striped
    blocks live on the device), and answers follow the mutations."""
    db = _db()
    q = Query("sessions", AggOp.COUNT, bound=ErrorBound(0.2)).normalized()
    db.query(q)
    raw = {c: np.asarray(v)[:400]
           for c, v in synth.sessions_table(400, seed=11).items()}
    db.append_rows("sessions", raw)

    def host_only():
        for fam in db.families["sessions"].values():
            for v in dataclasses.asdict(fam).values():
                assert not torch.is_tensor(v)
            assert all(isinstance(c, np.ndarray)
                       for c in fam.columns_host.values())
    host_only()
    a_after_append = db.query(q)
    db.delete_rows("sessions", Predicate.where(Atom("OS", CmpOp.EQ, "os2")))
    host_only()
    assert db.query(q).rows_total < a_after_append.rows_total
    ek = db.families["sessions"][("City",)].entry_key_host
    assert np.all(np.diff(ek) >= 0)


# ------------------------------------------------ a-priori contracts

def test_parse_strict_error_bound_or_fail(parsers):
    db = parsers[1]
    q = parse_blinkql("SELECT COUNT(*) FROM sessions GROUP BY OS "
                      "ERROR WITHIN 5% AT CONFIDENCE 99% OR FAIL", db)
    assert isinstance(q.bound, ErrorBound) and q.bound.strict is True
    assert q.bound.relative and q.bound.eps == pytest.approx(0.05)
    assert q.bound.confidence == pytest.approx(0.99)
    q2 = parse_blinkql("SELECT COUNT(*) FROM sessions ERROR WITHIN 5%", db)
    assert q2.bound.strict is False
    q3 = parse_blinkql("SELECT COUNT(*) FROM sessions "
                       "WHERE OS = 'os1' OR OS = 'os2' "
                       "ERROR WITHIN 5% OR FAIL", db)
    assert len(q3.predicate.disjuncts) == 2 and q3.bound.strict is True


def test_time_bound_headroom_does_not_alias_cached_k():
    db = _db(10_000)
    q = Query("sessions", AggOp.COUNT, group_by=("City",),
              bound=TimeBound(1.0)).normalized()
    phi = tuple(db.query(q).sample_phi)
    fam = db.families["sessions"][phi]
    sizes = sorted(set(fam.prefix_sizes), reverse=True)
    assert len(sizes) >= 2
    p0, p1 = sizes[0], sizes[1]
    model = elp_lib.LatencyModel(a=1.0 / p0, b=0.0)
    window = 1.0 - 0.5 * (p1 / p0)
    db._latency[("sessions", phi)] = model
    k_direct = db.query(q).sample_k
    assert k_direct == elp_lib.pick_k_for_time(fam, model, 1.0)
    (ans_b,) = db.query_batch([q], deadline_headroom_s=window)
    want_b = elp_lib.pick_k_for_time(fam, model, 1.0, headroom_s=window)
    assert want_b != k_direct
    assert ans_b.sample_k == want_b
    assert db.query(q).sample_k == k_direct
    (ans_b2,) = db.query_batch([q], deadline_headroom_s=window)
    assert ans_b2.sample_k == want_b


def test_scheduler_reprojects_cached_latency_model_per_window():
    db = _db(10_000)
    window = 0.05
    q = Query("sessions", AggOp.COUNT, group_by=("City",),
              bound=TimeBound(1.0)).normalized()
    with BlinkQLService(db, config=ServiceConfig(batch_window_s=window,
                                                 use_cache=False,
                                                 solo_bypass=False)) as svc:
        svc.submit(q)
        phi = tuple(db.query(q).sample_phi)
        fam = db.families["sessions"][phi]
        sizes = sorted(set(fam.prefix_sizes), reverse=True)
        model = elp_lib.LatencyModel(a=window * 2.0 / sizes[1], b=0.0)
        db._latency[("sessions", phi)] = model
        ans = svc.submit(q)
    assert ans.sample_k == elp_lib.pick_k_for_time(fam, model, 1.0,
                                                   headroom_s=window)


def test_stale_serve_demotes_contract_verdict():
    db = _db()
    q = Query("sessions", AggOp.COUNT, group_by=("OS",),
              bound=ErrorBound(0.15)).normalized()
    with BlinkQLService(db, config=ServiceConfig(batch_window_s=0.001)) as svc:
        fresh = svc.submit(q)
        assert fresh.bound_met is not None
        served = svc._fallback_result(q, FaultError("shards down"))
        missing = svc._fallback_result(
            Query("sessions", AggOp.SUM, "Bitrate").normalized(),
            FaultError("shards down"))
    assert not isinstance(served, BaseException)
    assert served.degraded is True and served.staleness_s >= 0.0
    assert served.bound_met is False and served.certified is False
    assert isinstance(missing, DegradedServiceError)
    assert isinstance(DeadlineShedError("x"), AdmissionError)
