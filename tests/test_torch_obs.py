"""Port parity and contracts: span tracing, metrics export, statements.

Against the reference (`repro`; the port on the CPU with the reference's
sample units): the same query gives the same span names nested the same
way (times are not compared), through BlinkDB.query, query_batch, a
fault plan's replica attempts, the exact fallback, a QUANTILE and the
service's request path. Then the reference's tests/test_obs.py contracts on
the port: the span machinery, the sampling policy, ladder completeness,
disabled tracing bit-identical, the merged metrics snapshot and Prometheus
text, and the SHOW METRICS / EXPLAIN statement surface. Port-only: a
traced answer equals an untraced one bit for bit on the engine itself, and
a scan span's bytes_per_row is the block's dtype-exact row width.
"""
import threading

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import sampling as ref_samp
from repro.core import table as ref_table
from repro.data import synth as ref_synth
from repro.fault import inject as ref_inject
from repro.obs import trace as ref_trace
from repro.service import BlinkQLService as RefService
from repro.service import ServiceConfig as RefServiceConfig
import repro_torch.core as P
from repro_torch import state
from repro_torch.core import table as table_lib
from repro_torch.data import synth
from repro_torch.fault import inject
from repro_torch.fault.inject import FaultPlan, FaultSpec, arm
from repro_torch.launch.roofline import scan_bytes_per_row
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import (QueryTrace, Tracer, activate,
                                   active_traces, span)
from repro_torch.service import (BlinkQLError, BlinkQLService,
                                 DeadlineShedError, DegradedServiceError,
                                 Explain, ServiceConfig, ShowMetrics,
                                 parse_blinkql, parse_statement)

N_ROWS, DATA_SEED, SEED = 20_000, 2, 1
N_SHARDS = 4  # EngineConfig default n_logical_shards
AVG_TXT = ("SELECT AVG(SessionTime) FROM sessions WHERE City = 'city003' "
           "ERROR WITHIN 10% CONFIDENCE 95%")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_db(n_rows=N_ROWS):
    d = P.BlinkDB(P.EngineConfig(k1=400.0, m=3, seed=SEED), device="cpu")
    d.register_table("sessions", table_lib.from_columns(
        "sessions", synth.sessions_table(n_rows, seed=DATA_SEED)))
    state.install_families(d, "sessions", {
        ("City",): ref_samp.base_units(n_rows, SEED),
        (): ref_samp.base_units(n_rows, SEED, uniform=True)})
    return d


def _ref_db(n_rows=N_ROWS, **cfg):
    d = R.BlinkDB(R.EngineConfig(k1=400.0, m=3, seed=SEED, **cfg))
    d.register_table("sessions", ref_table.from_columns(
        "sessions", ref_synth.sessions_table(n_rows, seed=DATA_SEED)))
    d.add_family("sessions", ("City",))
    d.add_family("sessions", ())
    return d


@pytest.fixture(scope="module")
def db():
    return _port_db()


@pytest.fixture(scope="module")
def engines():
    return _ref_db(), _port_db()


def _avg_q(db):
    return parse_blinkql(AVG_TXT, db).normalized()


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


def _root_reaches(tr, s):
    i = s.index
    while tr.spans[i].parent >= 0:
        i = tr.spans[i].parent
    return i


def _tree(tr):
    return [(s.name, s.parent) for s in tr.spans]


# ===================================================== parity: span trees

def _queries(m):
    city3 = m.Predicate.where(m.Atom("City", m.CmpOp.EQ, "city003"))
    return {
        "avg_error": m.Query("sessions", m.AggOp.AVG, "SessionTime",
                             predicate=city3, bound=m.ErrorBound(0.1)),
        "count_time": m.Query("sessions", m.AggOp.COUNT, group_by=("OS",),
                              bound=m.TimeBound(2.0)),
        "exact_rung": m.Query("sessions", m.AggOp.AVG, "SessionTime",
                              predicate=city3,
                              bound=m.ErrorBound(1e-6)),
        "sum_or": m.Query("sessions", m.AggOp.SUM, "Bitrate",
                          predicate=m.Predicate((
                              m.Conjunction((m.Atom("OS", m.CmpOp.EQ,
                                                    "os1"),)),
                              m.Conjunction((m.Atom("OS", m.CmpOp.EQ,
                                                    "os2"),)))),
                          bound=m.ErrorBound(0.1)),
    }


def _fresh(*dbs):
    for d in dbs:
        d._elp_cache.clear()
        d._latency.clear()


@pytest.mark.parametrize("name", ["avg_error", "count_time", "exact_rung",
                                  "sum_or"])
def test_query_span_tree_matches_the_reference(engines, name):
    ref, port = engines
    _fresh(ref, port)
    tr_r, tr_p = ref_trace.QueryTrace("q"), QueryTrace("q")
    with ref_trace.activate(tr_r):
        ref.query(_queries(R)[name])
    with activate(tr_p):
        port.query(_queries(P)[name])
    assert _tree(tr_p) == _tree(tr_r)
    assert "scan" in tr_p.span_names() or "scan.exact" in tr_p.span_names()


def test_batch_span_tree_matches_the_reference(engines):
    ref, port = engines
    _fresh(ref, port)
    names = ["avg_error", "sum_or", "count_time"]
    tr_r, tr_p = ref_trace.QueryTrace("b"), QueryTrace("b")
    with ref_trace.activate(tr_r):
        ref.query_batch([_queries(R)[n] for n in names])
    with activate(tr_p):
        port.query_batch([_queries(P)[n] for n in names])
    assert _tree(tr_p) == _tree(tr_r)


def test_fault_plan_span_tree_matches_the_reference(engines):
    """Replica attempts under a plan: scan.shard per (shard, replica)
    attempt, the failed ones marked, nested as in the reference."""
    ref, port = engines
    _fresh(ref, port)

    def plan(m):
        return m.FaultPlan([m.FaultSpec(site="shard.scan", kind="kill",
                                        match=(("shard", 1),
                                               ("replica", 0)))], seed=0)
    tr_r, tr_p = ref_trace.QueryTrace("f"), QueryTrace("f")
    with ref_inject.arm(plan(ref_inject)), ref_trace.activate(tr_r):
        ref.query(_queries(R)["avg_error"])
    with arm(plan(inject)), activate(tr_p):
        port.query(_queries(P)["avg_error"])
    assert _tree(tr_p) == _tree(tr_r)

    def attempts(tr):
        return [(s.attrs["shard"], s.attrs["replica"], s.attrs.get("ok"),
                 s.attrs.get("process")) for s in tr.find("scan.shard")]
    assert attempts(tr_p) == attempts(tr_r)


def test_quantile_span_tree_matches_the_reference():
    ref, port = _ref_db(8_000, use_pallas=True), _port_db(8_000)

    def q(m):
        return m.Query("sessions", m.AggOp.QUANTILE, "SessionTime",
                       quantile=0.5, group_by=("OS",),
                       bound=m.ErrorBound(0.1))
    tr_r, tr_p = ref_trace.QueryTrace("q"), QueryTrace("q")
    with ref_trace.activate(tr_r):
        ref.query(q(R))
    with activate(tr_p):
        port.query(q(P))
    assert _tree(tr_p) == _tree(tr_r)
    assert [s.attrs.get("quantile") for s in tr_p.find("scan")] == \
        [s.attrs.get("quantile") for s in tr_r.find("scan")]


def test_service_span_tree_matches_the_reference(engines):
    ref, port = engines
    _fresh(ref, port)
    with RefService(ref, config=RefServiceConfig(use_cache=False)) as a, \
            BlinkQLService(port, config=ServiceConfig(use_cache=False)) as b:
        ra, rb = a.submit(AVG_TXT), b.submit(AVG_TXT)
        assert _tree(rb.trace) == _tree(ra.trace)
        assert set(rb.timings) == set(ra.timings)


# ===================================================== span machinery (unit)

def test_span_is_noop_singleton_without_active_trace():
    assert active_traces() == ()
    a = span("anything", x=1)
    b = span("else")
    assert a is b
    with a as s:
        assert s.set(more=2) is s


def test_cross_thread_spans_nest_under_anchor():
    tr = QueryTrace("q", reason="forced")
    root = tr.open_span("request", {})
    tr.set_anchor(root.index)
    seen = {}

    def worker():
        with activate(tr):
            with span("scan", shard=0):
                pass
        seen["ok"] = True

    t = threading.Thread(target=worker, name="obs-worker")
    t.start()
    t.join(timeout=30)
    assert seen["ok"]
    tr.close_span(root)
    tr.finish()
    (scan,) = tr.find("scan")
    assert scan.parent == root.index
    assert scan.thread == "obs-worker"
    assert _root_reaches(tr, scan) == root.index


def test_activate_dedups_already_active_trace():
    tr = QueryTrace("q")
    with activate(tr):
        with activate(tr, None):
            with span("s"):
                pass
        assert active_traces() == (tr,)
    assert active_traces() == ()
    assert len(tr.find("s")) == 1


def test_timings_count_only_outermost_stage_spans():
    tr = QueryTrace("q")
    outer = tr.open_span("scan", {})
    inner = tr.open_span("scan.shard", {})
    tr.close_span(inner)
    tr.close_span(outer)
    est = tr.open_span("estimate", {})
    tr.close_span(est)
    tr.finish()
    tr.t0, tr.t1 = 100.0, 103.0
    outer.t0, outer.t1 = 100.0, 102.0
    inner.t0, inner.t1 = 100.25, 101.75
    est.t0, est.t1 = 102.0, 102.25
    t = tr.timings()
    assert t["scan"] == pytest.approx(2.0)
    assert t["estimate"] == pytest.approx(0.25)
    assert t["total"] == pytest.approx(3.0)


def test_tracer_sampling_policy():
    tr = Tracer(sample_every=3)
    assert tr.should_sample(forced=True) == "forced"
    assert tr.should_sample(contract=True) == "contract"
    with arm(FaultPlan()):
        assert tr.should_sample() == "fault"
    assert [tr.should_sample() for _ in range(6)] == \
        [None, None, "sampled", None, None, "sampled"]
    tr.enabled = False
    assert tr.should_sample(forced=True) is None
    tr.enabled = True
    tr.sample_every = 0
    assert tr.should_sample() is None


def test_tracer_ring_respects_capacity():
    tr = Tracer(capacity=4, sample_every=1)
    for i in range(10):
        tr.finish(tr.start(f"q{i}", "sampled"))
    assert [t.query_text for t in tr.recent()] == ["q6", "q7", "q8", "q9"]


# ===================================================== engine-level tracing

@pytest.mark.parametrize("text", [
    AVG_TXT,
    "SELECT QUANTILE(SessionTime, 0.9) FROM sessions GROUP BY OS "
    "ERROR WITHIN 10%",
    "SELECT COUNT(*) FROM sessions WHERE OS = 'os1' OR OS = 'os2' "
    "ERROR WITHIN 10%",
])
def test_traced_answer_is_bit_identical_to_untraced(db, text):
    q = parse_blinkql(text, db).normalized()
    plain = db.query(q)
    tr = QueryTrace(text)
    with activate(tr):
        traced = db.query(q)
        (batched,) = db.query_batch([q])
    tr.finish()
    _assert_bit_identical(plain, traced)
    _assert_bit_identical(plain, batched)
    assert {"plan", "scan", "estimate"} <= set(tr.timings())


def test_scan_span_bytes_per_row_is_the_block_row_width(db):
    tr = QueryTrace("bytes")
    with activate(tr):
        db.query(_avg_q(db))
    striped = db._striped_for("sessions", ("City",))
    want = scan_bytes_per_row(
        [a.dtype for a in striped.columns.values()]
        + [striped.unit.dtype, striped.strat.dtype, striped.valid.dtype])
    assert {s.attrs["bytes_per_row"] for s in tr.find("scan")} == {want}
    assert want == sum(a.element_size() for a in
                       (*striped.columns.values(), striped.unit,
                        striped.strat, striped.valid))


# ===================================================== end-to-end tracing

def test_contract_query_traced_end_to_end(db):
    svc = BlinkQLService(db)
    try:
        ans = svc.submit(AVG_TXT)
        tr = ans.trace
        assert tr is not None and tr.reason == "contract"
        assert {"request", "parse", "admit", "plan", "scan",
                "estimate"} <= set(tr.span_names())
        assert tr.spans[0].name == "request"
        for s in tr.spans:
            assert s.t1 >= s.t0
            assert _root_reaches(tr, s) == 0
        for stage in ("parse", "admit", "plan", "scan", "estimate"):
            assert ans.timings[stage] >= 0.0
        assert ans.timings["total"] >= ans.timings["scan"]
        cached = svc.cache.get(_avg_q(db))
        assert cached is not None and cached.trace is None
        hit = svc.submit(AVG_TXT)
        assert hit.trace.span_names() == ["request", "parse", "cache"]
        (c,) = hit.trace.find("cache")
        assert c.attrs.get("hit") is True
        assert hit.timings["total"] >= 0.0
    finally:
        svc.close()


def test_queued_path_spans_cross_threads(db):
    svc = BlinkQLService(db, config=ServiceConfig(use_cache=False,
                                                  solo_bypass=False))
    try:
        tr = svc.submit(AVG_TXT).trace
        assert {"request", "parse", "admit", "plan",
                "scan"} <= set(tr.span_names())
        assert len({s.thread for s in tr.spans}) >= 2
        (admit,) = tr.find("admit")
        assert admit.attrs.get("batch", 0) >= 1
        for s in tr.spans:
            assert _root_reaches(tr, s) == 0
    finally:
        svc.close()


def test_replica_reroute_attempts_recorded(db):
    svc = BlinkQLService(db, config=ServiceConfig(use_cache=False))
    try:
        with arm(FaultPlan([FaultSpec(site="shard.scan", kind="kill",
                                      match=(("shard", 1), ("replica", 0)))],
                           seed=0)):
            ans = svc.submit(AVG_TXT)
        assert not ans.degraded
        tr = ans.trace
        assert tr is not None and tr.reason == "contract"
        attempts = tr.find("scan.shard")
        assert len(attempts) == N_SHARDS + 1
        failed = [s for s in attempts if s.attrs.get("ok") is False]
        assert [(s.attrs["shard"], s.attrs["replica"]) for s in failed] == \
            [(1, 0)]
        assert failed[0].attrs.get("error")
        assert any(s.attrs.get("shard") == 1 and s.attrs.get("replica") == 1
                   and s.attrs.get("ok") is True for s in attempts)
    finally:
        svc.close()


def test_exact_fallback_span_recorded(db):
    svc = BlinkQLService(db, config=ServiceConfig(use_cache=False))
    try:
        ans = svc.submit("SELECT AVG(SessionTime) FROM sessions "
                         "WHERE City = 'city003' "
                         "ERROR WITHIN 0.0001% CONFIDENCE 95%")
        assert ans.sample_phi == ("<exact>",) and ans.bound_met
        tr = ans.trace
        assert tr is not None and tr.reason == "contract"
        (exact,) = tr.find("scan.exact")
        assert exact.attrs.get("rows_read", 0) > 0
        assert "plan" in tr.span_names()
    finally:
        svc.close()


def test_stale_serve_ladder_spans(db):
    svc = BlinkQLService(db)
    try:
        warm = svc.submit(AVG_TXT)
        svc.cache._on_invalidate("sessions", None)
        with arm(FaultPlan([FaultSpec(site="engine.scan",
                                      kind="kill")], seed=0)):
            stale = svc.submit(AVG_TXT)
        assert stale.degraded and stale.staleness_s > 0.0
        _assert_bit_identical(warm, stale)
        tr = stale.trace
        retries = tr.find("ladder.retry")
        assert retries and all(r.attrs.get("error") for r in retries)
        (served,) = tr.find("ladder.stale_serve")
        assert served.attrs["age_s"] > 0.0
        assert svc.n_stale == 1
    finally:
        svc.close()


def test_exhausted_ladder_trace_retained_in_ring(db):
    svc = BlinkQLService(db, config=ServiceConfig(use_cache=False))
    try:
        with arm(FaultPlan([FaultSpec(site="engine.scan",
                                      kind="kill")], seed=0)):
            with pytest.raises(DegradedServiceError):
                svc.submit(AVG_TXT)
        tr = svc.tracer.recent()[-1]
        assert tr.error == "DegradedServiceError"
        assert {"ladder.retry", "ladder.exhausted"} <= set(tr.span_names())
    finally:
        svc.close()


def test_shed_trace_retained_and_counted(db):
    svc = BlinkQLService(db, config=ServiceConfig(use_cache=False,
                                                  solo_bypass=False))
    try:
        svc.submit("SELECT COUNT(SessionTime) FROM sessions "
                   "WITHIN 5 SECONDS")
        svc._exec_ewma = 10.0
        with pytest.raises(DeadlineShedError):
            svc.submit("SELECT COUNT(SessionTime) FROM sessions "
                       "WHERE City = 'city001' WITHIN 0.05 SECONDS")
        assert svc.n_shed == 1 and svc.stats()["shed"] == 1
        tr = svc.tracer.recent()[-1]
        assert tr.error == "DeadlineShedError"
        assert "scan" not in tr.span_names()
    finally:
        svc.close()


def test_disabled_tracing_is_bit_identical(db):
    on = BlinkQLService(db, config=ServiceConfig(use_cache=False,
                                                 trace_sample_every=1))
    off = BlinkQLService(db, config=ServiceConfig(use_cache=False,
                                                  trace=False))
    try:
        a = on.submit(AVG_TXT)
        b = off.submit(AVG_TXT)
        assert a.trace is not None and a.timings is not None
        assert b.trace is None and b.timings is None
        _assert_bit_identical(a, b)
        assert off.tracer.recent() == []
    finally:
        on.close()
        off.close()


# ===================================================== metrics + statements

def test_metrics_snapshot_schema_and_prometheus(db):
    svc = BlinkQLService(db)
    try:
        svc.submit(AVG_TXT)
        snap = svc.metrics_snapshot()
        assert snap["schema_version"] == 1
        assert set(snap) >= {"schema_version", "counters", "gauges",
                             "histograms"}
        assert {"engine_queries_total", "service_queries_total",
                "service_batches_total", "cache_events_total",
                "workload_queries_total"} <= set(snap["counters"])
        assert "service_queue_depth" in snap["gauges"]
        beat = snap["gauges"]["service_last_beat_age_s"]["values"]
        assert 0.0 <= beat["dispatcher"] < 60.0
        assert {"service_batch_width",
                "engine_scan_seconds"} <= set(snap["histograms"])
        text = svc.render_prometheus()
        assert "# TYPE service_queries_total counter" in text
        assert "service_last_beat_age_s" in text
        assert obs_metrics.to_json(snap)
    finally:
        svc.close()


def test_service_counters_isolated_per_service_instance(db):
    a = BlinkQLService(db, config=ServiceConfig(use_cache=False))
    try:
        a.submit(AVG_TXT)
        assert a.n_queries == 1
    finally:
        a.close()
    b = BlinkQLService(db, config=ServiceConfig(use_cache=False))
    try:
        assert b.n_queries == 0 and b.n_batches == 0
        b.submit(AVG_TXT)
        assert b.n_queries == 1
    finally:
        b.close()


def test_parse_statement_dispatch(db):
    s = parse_statement("SHOW METRICS", db)
    assert isinstance(s, ShowMetrics) and s.fmt == "json"
    s = parse_statement("show metrics format prometheus", db)
    assert isinstance(s, ShowMetrics) and s.fmt == "prometheus"
    e = parse_statement(f"EXPLAIN {AVG_TXT}", db)
    assert isinstance(e, Explain)
    assert e.query.normalized() == _avg_q(db)
    assert e.text == AVG_TXT
    assert parse_statement(AVG_TXT, db).normalized() == _avg_q(db)
    for bad in ("SHOW METRICS FORMAT XML", "SHOW METRICS garbage",
                "EXPLAIN"):
        with pytest.raises(BlinkQLError):
            parse_statement(bad, db)
    with pytest.raises(BlinkQLError):
        parse_blinkql("SHOW METRICS", db)


def test_execute_show_metrics_and_explain(db):
    svc = BlinkQLService(db, config=ServiceConfig(use_cache=False))
    try:
        snap = svc.execute("SHOW METRICS")
        assert isinstance(snap, dict) and snap["schema_version"] == 1
        text = svc.execute("SHOW METRICS FORMAT PROMETHEUS")
        assert isinstance(text, str) and "service_queries_total" in text
        rep = svc.execute(f"EXPLAIN {AVG_TXT}")
        assert rep["answer"].groups
        assert rep["trace"]["reason"] == "forced"
        assert rep["plan"].get("family") == ["City"]
        assert rep["plan"].get("k", 0) > 0
        assert rep["timings"]["total"] > 0.0
        span_names = [s["name"] for s in rep["trace"]["spans"]]
        assert "plan" in span_names and "scan" in span_names
        assert svc.execute(AVG_TXT).groups
    finally:
        svc.close()


def test_explain_reports_cached_plan(db):
    svc = BlinkQLService(db)
    try:
        svc.submit(AVG_TXT)
        rep = svc.explain(AVG_TXT)
        assert rep["plan"] == {"cached": True}
        assert rep["answer"].groups
    finally:
        svc.close()


def test_explain_honors_trace_kill_switch(db):
    svc = BlinkQLService(db, config=ServiceConfig(use_cache=False,
                                                  trace=False))
    try:
        rep = svc.explain(AVG_TXT)
        assert rep["trace"] is None and rep["plan"] == {}
        assert rep["answer"].groups
    finally:
        svc.close()


def _fault_count(snap) -> float:
    vals = snap["counters"].get("fault_injections_total", {})
    return sum(vals.get("values", {}).values())


def test_fault_injection_counter_in_merged_snapshot(db):
    svc = BlinkQLService(db, config=ServiceConfig(use_cache=False))
    try:
        before = _fault_count(svc.metrics_snapshot())
        plan = FaultPlan([FaultSpec(site="engine.scan", kind="kill",
                                    max_fires=1)], seed=0)
        with arm(plan):
            ans = svc.submit(AVG_TXT)
        assert ans.groups and plan.n_fires == 1
        snap = svc.metrics_snapshot()
        assert _fault_count(snap) == before + 1
        ladder = snap["counters"]["service_ladder_total"]["values"]
        assert ladder.get("retry", 0) >= 1
    finally:
        svc.close()


def test_engine_counters_follow_the_reference_names(db):
    """The engine's instruments the snapshot exports: per-path query counts,
    rows read, scan seconds, and the shard counters under a plan."""
    before = db.metrics.snapshot()["counters"]
    with arm(FaultPlan([FaultSpec(site="shard.scan", kind="kill",
                                  match=(("shard", 1),))], seed=0)):
        db.query(_avg_q(db))
    snap = db.metrics.snapshot()
    c = snap["counters"]
    assert c["engine_queries_total"]["values"]["query"] > \
        before.get("engine_queries_total", {}).get("values", {}).get(
            "query", 0)
    assert c["engine_shards_lost_total"]["values"][""] >= 1
    assert c["engine_rows_read_total"]["values"][""] > 0
    assert snap["histograms"]["engine_scan_seconds"]["values"][""][
        "count"] > 0
    assert np.isfinite(snap["histograms"]["engine_scan_seconds"][
        "values"][""]["sum"])
