"""Port parity and contracts: fault-injected serving on the port.

Against the reference (`repro`, use_pallas=False; the port on the CPU, the
reference's sample units carried into it), on one table and families:
fault plans fire the same specs on the same visit sequence, the shard hash
gives the same shard for every int8/int16 stratum id and 10^5 seeded int32
ones, and under one plan per case (a clean 4-shard scan, a replica-0 kill
on every shard, a shard lost on every replica, a poison, a process kill
through placement, all shards lost) the ShardScanReports, the degradation
fields, the estimates and CIs (rtol 1e-4) and the typed errors are equal.

Then the reference's tests/test_faults.py contracts, each on the port: the
fault layer itself, the sharded scan (empty plan bit-identical, replica
re-route bit-identical to the clean sharded scan, HT reweighting under
shard loss, poison containment), the service's degradation ladder, deadline
shedding, dispatcher-death safety, submit timeouts (a blocked query_batch
stands in for the reference's sleeps), the supervisor primitives and a
seeded chaos soak on three seeds. Port-only: a torch RuntimeError (what a
CUDA error or a failed kernel build raises) propagates through the sharded
scan and the service with no replica, no retry and no stale serve.
"""
import threading

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import executor as ref_exec
from repro.core import sampling as ref_samp
from repro.core import table as ref_table
from repro.data import synth as ref_synth
from repro.fault import inject as ref_inject
import repro_torch.core as P
from repro_torch import state
from repro_torch.core import executor as exec_lib
from repro_torch.core import table as table_lib
from repro_torch.core.estimators import GroupedMoments, reweight_moments
from repro_torch.core.executor import (ShardScanReport, merge_shard_reports,
                                       shard_of_strata)
from repro_torch.data import synth
from repro_torch.fault import inject
from repro_torch.fault.inject import (AllShardsLostError, FaultError,
                                      FaultPlan, FaultSpec, InjectedFault,
                                      arm, random_plan)
from repro_torch.fault.supervisor import Heartbeat, RetryLoop
from repro_torch.service import (AdmissionError, BlinkQLService,
                                 DeadlineShedError, DegradedServiceError,
                                 ServiceConfig, ServiceUnhealthyError,
                                 parse_blinkql)

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


@pytest.fixture(scope="module")
def db():
    return _port_db()


@pytest.fixture(scope="module")
def engines():
    ref = R.BlinkDB(R.EngineConfig(k1=400.0, m=3, seed=SEED))
    ref.register_table("sessions", ref_table.from_columns(
        "sessions", ref_synth.sessions_table(N_ROWS, seed=DATA_SEED)))
    ref.add_family("sessions", ("City",))
    ref.add_family("sessions", ())
    return ref, _port_db()


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


def _assert_close(a, b, rtol=1e-4):
    ka = {g.key: g for g in a.groups}
    kb = {g.key: g for g in b.groups}
    assert ka.keys() == kb.keys()
    for key in ka:
        np.testing.assert_allclose(ka[key].estimate, kb[key].estimate,
                                   rtol=rtol)


def _finite(ans):
    return all(np.isfinite(g.estimate) and np.isfinite(g.stderr)
               for g in ans.groups)


# ------------------------------------------------- parity: the fault layer

def _visits(n=40):
    sites = ("shard.scan", "engine.scan")
    return [(sites[v % 3 == 0], {"shard": v % 4, "replica": (v // 4) % 2,
                                 "process": v % 2, "table": "sessions"})
            for v in range(n)]


@pytest.mark.parametrize("seed", range(6))
def test_random_plans_fire_the_same_specs_as_the_reference(seed):
    """random_plan draws the same specs from one seed in both packages, and
    the two plans fire the same specs on the same visit sequence."""
    ref, port = ref_inject.random_plan(seed), random_plan(seed)
    assert [s.__dict__ for s in port.specs] == \
        [s.__dict__ for s in ref.specs] and port.seed == ref.seed
    for site, ctx in _visits():
        assert [(i, s.kind) for i, s in port.visit(site, ctx)] == \
            [(i, s.kind) for i, s in ref.visit(site, ctx)]
    assert port.log == ref.log and port.n_fires == ref.n_fires


def test_probabilistic_plan_fires_the_same_as_the_reference():
    def specs(m):
        return [m.FaultSpec(site="shard.scan", kind="kill", p=0.4),
                m.FaultSpec(site="shard.scan", kind="poison", p=0.7,
                            match=(("shard", 2),), after=1, max_fires=3),
                m.FaultSpec(site="engine.scan", kind="delay", p=0.5,
                            delay_s=0.0)]
    ref = ref_inject.FaultPlan(specs(ref_inject), seed=9)
    port = FaultPlan(specs(inject), seed=9)
    for site, ctx in _visits(60):
        assert [i for i, _ in port.visit(site, ctx)] == \
            [i for i, _ in ref.visit(site, ctx)]
    assert port.log == ref.log


@pytest.mark.parametrize("n_logical", [2, 3, 4, 7])
def test_shard_hash_matches_the_reference(n_logical):
    """Every int8 and int16 stratum id and 10^5 seeded int32 ones, negative
    ids (pads) included: the port's device mask and host hash give the
    reference's uint32 shard."""
    rng = np.random.default_rng(n_logical)
    for ids in (np.arange(-128, 128, dtype=np.int8),
                np.arange(-2**15, 2**15, dtype=np.int16),
                rng.integers(-2**31, 2**31, 100_000).astype(np.int32)):
        want = ref_exec.shard_of_strata(ids, n_logical)
        np.testing.assert_array_equal(shard_of_strata(ids, n_logical), want)
        valid = torch.from_numpy(rng.random(ids.shape[0]) < 0.9)
        for s in range(n_logical):
            got = exec_lib.shard_valid_mask(torch.from_numpy(ids), valid, s,
                                            n_logical=n_logical)
            np.testing.assert_array_equal(got.numpy(),
                                          valid.numpy() & (want == s))


# ------------------------------------------- parity: one table, one plan

def _plan(m, case):
    S = m.FaultSpec
    return m.FaultPlan({
        "clean_sharded": [S(site="shard.scan", kind="kill",
                            match=(("shard", 99),))],
        "replica0_kill": [S(site="shard.scan", kind="kill",
                            match=(("replica", 0),))],
        "shard_lost": [S(site="shard.scan", kind="kill",
                         match=(("shard", 1),))],
        "poison": [S(site="shard.scan", kind="poison",
                     match=(("shard", 2),))],
        "process_kill": [S(site="shard.scan", kind="kill",
                           match=(("process", 0),))],
        "all_lost": [S(site="shard.scan", kind="kill")],
    }[case], seed=0)


def _parity_queries(m):
    t = "sessions"
    return [
        m.Query(t, m.AggOp.AVG, "SessionTime", predicate=m.Predicate.where(
            m.Atom("City", m.CmpOp.EQ, "city003")), bound=m.ErrorBound(0.1)),
        m.Query(t, m.AggOp.SUM, "SessionTime", group_by=("OS",),
                bound=m.ErrorBound(0.1)),
        m.Query(t, m.AggOp.COUNT, predicate=m.Predicate.where(
            m.Atom("Genre", m.CmpOp.EQ, "genre03")), group_by=("City",),
            bound=m.ErrorBound(0.2)),
    ]


def _same_report(a, b):
    assert (b.n_shards, b.lost, b.rerouted) == (a.n_shards, a.lost,
                                               a.rerouted)
    assert b.reweight == pytest.approx(a.reweight, rel=1e-12)


def _same_answer(a, b):
    assert b.sample_phi == a.sample_phi and b.sample_k == a.sample_k
    assert (b.degraded, b.shards_lost, b.shards_total) == \
        (a.degraded, a.shards_lost, a.shards_total)
    assert (b.bound_met, b.certified) == (a.bound_met, a.certified)
    assert [g.key for g in b.groups] == [g.key for g in a.groups]
    for ga, gb in zip(a.groups, b.groups):
        assert gb.exact == ga.exact and gb.n_selected == ga.n_selected
        for f in ("estimate", "stderr", "ci_low", "ci_high"):
            np.testing.assert_allclose(getattr(gb, f), getattr(ga, f),
                                       rtol=1e-4, atol=1e-9, err_msg=f)


@pytest.mark.parametrize("case", ["clean_sharded", "replica0_kill",
                                  "shard_lost", "poison", "process_kill",
                                  "all_lost"])
def test_plan_matches_the_reference(engines, case):
    ref, port = engines
    for e in engines:
        e._elp_cache.clear()
    for qr, qp in zip(_parity_queries(R), _parity_queries(P)):
        phi = ("City",)
        k = port.families["sessions"][phi].ks[1]
        with ref_inject.arm(_plan(ref_inject, case)):
            try:
                mr, _, _, rep_r = ref._run_at_k("sessions", qr, phi, k)
                ar = ref.query(qr)
            except ref_inject.FaultError as e:
                err_r = type(e).__name__
            else:
                err_r = None
        with arm(_plan(inject, case)):
            try:
                mp, _, _, rep_p = port._run_at_k("sessions", qp, phi, k)
                ap = port.query(qp)
            except FaultError as e:
                err_p = type(e).__name__
            else:
                err_p = None
        assert err_p == err_r
        if case == "all_lost":
            assert err_p == "AllShardsLostError"
            continue
        _same_report(rep_r, rep_p)
        want = np.stack([np.asarray(getattr(mr, f)) for f in
                         ("n", "wsum", "wxsum", "wx2sum", "var_count",
                          "var_sum", "var_sum2")])
        np.testing.assert_allclose(mp.stacked().numpy(), want, rtol=2e-5,
                                   atol=1e-3)
        _same_answer(ar, ap)
        if ap.sample_phi != ("<exact>",):
            assert ap.shards_total == N_SHARDS


# ---------------------------------------------------------- fault layer

def test_fault_spec_validates_kind():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec(site="x", kind="explode")


def test_fault_spec_match_after_max_fires():
    spec = FaultSpec(site="s", kind="kill", match=(("shard", 1),),
                     after=1, max_fires=2)
    plan = FaultPlan([spec], seed=0)
    assert plan.visit("s", {"shard": 0}) == []      # no match
    assert plan.visit("other", {"shard": 1}) == []  # wrong site
    assert plan.visit("s", {"shard": 1}) == []      # after: skip first
    assert len(plan.visit("s", {"shard": 1})) == 1
    assert len(plan.visit("s", {"shard": 1})) == 1
    assert plan.visit("s", {"shard": 1}) == []      # max_fires exhausted
    assert plan.n_fires == 2
    assert plan.log == [("s", 0, "kill"), ("s", 0, "kill")]


def test_fault_plan_deterministic_under_fixed_visit_sequence():
    def fires(plan):
        return [bool(plan.visit("s", {"shard": v % 4})) for v in range(20)]

    def mk():
        return FaultPlan([FaultSpec(site="s", kind="kill", p=0.5)], seed=42)
    assert fires(mk()) == fires(mk())


def test_random_plan_reproducible_and_bounded():
    a, b = random_plan(7), random_plan(7)
    assert a.specs == b.specs and a.seed == b.seed
    for seed in range(20):
        plan = random_plan(seed)
        assert 1 <= len(plan.specs) <= 5
        for spec in plan.specs:
            assert spec.site in ("shard.scan", "engine.scan")
            if spec.site == "engine.scan":   # bounded: retries must succeed
                assert spec.kind == "kill" and spec.max_fires <= 2


def test_arm_is_exclusive_and_scoped():
    assert inject.active() is None
    with arm(FaultPlan([FaultSpec(site="s", kind="kill")], seed=0)) as p:
        assert inject.active() is p
        with pytest.raises(RuntimeError, match="already armed"):
            with arm(FaultPlan()):
                pass
    assert inject.active() is None
    assert inject.site("s") is None   # disarmed: no-op


def test_site_kill_beats_poison_and_reports_context():
    plan = FaultPlan([FaultSpec(site="s", kind="poison"),
                      FaultSpec(site="s", kind="kill")], seed=0)
    with arm(plan):
        with pytest.raises(InjectedFault) as ei:
            inject.site("s", shard=3)
    assert ei.value.site == "s" and ei.value.context == {"shard": 3}
    assert isinstance(ei.value, FaultError)


# ------------------------------------------------- sharded scan (engine)

NEVER = [FaultSpec(site="shard.scan", kind="kill", match=(("shard", 99),))]


def test_empty_plan_is_bit_identical(db):
    q = _avg_q(db)
    clean = db.query(q)
    with arm(FaultPlan()):
        armed = db.query(q)
    _assert_bit_identical(clean, armed)
    assert not armed.degraded and armed.shards_total == 0


def test_empty_plan_batch_is_bit_identical(db):
    qs = [_avg_q(db),
          parse_blinkql("SELECT COUNT(SessionTime) FROM sessions "
                        "WHERE City = 'city001'", db).normalized(),
          parse_blinkql("SELECT QUANTILE(SessionTime, 0.5) FROM sessions "
                        "GROUP BY OS ERROR WITHIN 10%", db).normalized()]
    clean = db.query_batch(list(qs))
    with arm(FaultPlan()):
        armed = db.query_batch(list(qs))
    for c, a in zip(clean, armed):
        _assert_bit_identical(c, a)
        assert a.shards_total == 0


def test_sharded_clean_scan_matches_fused(db):
    """A non-empty plan that never fires engages the sharded path: the
    answer agrees with the fused scan within the reference's tolerance
    (another summation order) and carries provenance."""
    q = _avg_q(db)
    clean = db.query(q)
    with arm(FaultPlan(NEVER, seed=0)):
        sharded = db.query(q)
    _assert_close(clean, sharded, rtol=1e-4)
    assert not sharded.degraded
    assert sharded.shards_total == N_SHARDS and sharded.shards_lost == 0


@pytest.mark.parametrize("match", [(("shard", 1), ("replica", 0)),
                                   (("replica", 0),)])
def test_replica_reroute_is_bit_identical_to_sharded_clean(db, match):
    """Killing replica 0 (of one shard, or of every shard) re-routes to
    replica 1, a re-execution of the same shard mask: bit-identical to the
    sharded scan with no faults at all."""
    q = _avg_q(db)
    with arm(FaultPlan(NEVER, seed=0)):
        baseline = db.query(q)
    with arm(FaultPlan([FaultSpec(site="shard.scan", kind="kill",
                                  match=match)], seed=0)):
        rerouted = db.query(q)
    _assert_bit_identical(baseline, rerouted)
    assert not rerouted.degraded and rerouted.shards_lost == 0


def test_shard_loss_reweights_and_widens_ci(db):
    q = _avg_q(db)
    with arm(FaultPlan(NEVER, seed=0)):
        baseline = db.query(q)
    with arm(FaultPlan([FaultSpec(site="shard.scan", kind="kill",
                                  match=(("shard", 1),))], seed=0)):
        degraded = db.query(q)
        _, _, _, rep = db._run_at_k("sessions", q, ("City",),
                                    degraded.sample_k)
    assert degraded.degraded
    assert degraded.shards_lost == 1 and degraded.shards_total == N_SHARDS
    assert rep.lost == (1,) and rep.reweight == pytest.approx(4 / 3)
    assert _finite(degraded)
    kb = {g.key: g for g in baseline.groups}
    for g in degraded.groups:
        # The second-phase reweight strictly inflates variance.
        assert g.stderr >= kb[g.key].stderr


def test_poison_is_detected_and_contained(db):
    q = _avg_q(db)
    with arm(FaultPlan([FaultSpec(site="shard.scan", kind="poison",
                                  match=(("shard", 2),))], seed=0)):
        ans = db.query(q)
    assert _finite(ans)
    assert ans.degraded and ans.shards_lost == 1


def test_all_shards_lost_raises_typed_error(db):
    with arm(FaultPlan([FaultSpec(site="shard.scan", kind="kill")],
                       seed=0)):
        with pytest.raises(AllShardsLostError):
            db.query(_avg_q(db))


def test_straggler_delay_is_tolerated(db):
    """A delay fault alone (no deadline configured) only slows the scan."""
    q = _avg_q(db)
    with arm(FaultPlan(NEVER, seed=0)):
        baseline = db.query(q)
    with arm(FaultPlan([FaultSpec(site="shard.scan", kind="delay",
                                  match=(("shard", 0),), delay_s=0.01)],
                       seed=0)):
        delayed = db.query(q)
    _assert_bit_identical(baseline, delayed)
    assert not delayed.degraded


def test_straggler_deadline_loses_the_slow_shard():
    """With a straggler deadline every attempt past it is disqualified:
    a shard delayed on each replica is lost and the answer degrades."""
    d = _port_db(5_000)
    d.config.straggler_deadline_s = 0.01
    q = _avg_q(d)
    with arm(FaultPlan([FaultSpec(site="shard.scan", kind="delay",
                                  match=(("shard", 0),), delay_s=0.02)],
                       seed=0)):
        ans = d.query(parse_blinkql("SELECT COUNT(*) FROM sessions "
                                    "GROUP BY OS", d).normalized())
    assert ans.degraded and ans.shards_lost == 1
    assert q is not None


def test_quantile_under_a_plan_takes_the_sharded_moments():
    """QUANTILE under a plan: sharded moments (reweighted on loss) and the
    histogram from one unsharded quantile scan; finite and degraded."""
    d = _port_db(8_000)
    q = parse_blinkql("SELECT QUANTILE(SessionTime, 0.5) FROM sessions "
                      "GROUP BY OS", d).normalized()
    clean = d.query(q)
    with arm(FaultPlan([FaultSpec(site="shard.scan", kind="kill",
                                  match=(("shard", 3),))], seed=0)):
        ans = d.query(q)
    assert ans.degraded and ans.shards_lost == 1 and _finite(ans)
    assert [g.key for g in ans.groups] == [g.key for g in clean.groups]
    for a, c in zip(ans.groups, clean.groups):
        assert a.estimate == c.estimate     # the same unsharded histogram
        assert a.stderr >= c.stderr * (1 - 1e-6)


def test_subsampling_under_an_armed_plan_uses_the_closed_form():
    d = P.BlinkDB(P.EngineConfig(k1=400.0, m=3, seed=SEED,
                                 ci_method="subsampling"), device="cpu")
    d.register_table("sessions", table_lib.from_columns(
        "sessions", synth.sessions_table(8_000, seed=DATA_SEED)))
    d.add_family("sessions", ("City",))
    d.add_family("sessions", ())
    q = parse_blinkql("SELECT SUM(SessionTime) FROM sessions GROUP BY OS",
                      d).normalized()
    sub = d.query(q)
    d.config.ci_method = "closed"
    closed = d.query(q)
    d.config.ci_method = "subsampling"
    with arm(FaultPlan()):
        armed = d.query(q)
    _assert_bit_identical(closed, armed)
    assert [g.stderr for g in sub.groups] != [g.stderr for g in armed.groups]


def test_runtime_error_in_a_launch_propagates_unretried(db):
    """A launch failure (torch raises CUDA errors and failed builds as
    RuntimeError) is no FaultError: the sharded scan tries no replica, and
    the service neither retries it nor serves a stale answer."""
    striped = db._striped_for("sessions", ("City",))
    calls = []

    def call(mask):
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access")
    with arm(FaultPlan(NEVER, seed=0)):
        with pytest.raises(RuntimeError, match="illegal memory"):
            exec_lib.run_sharded_scan(call, striped, n_logical=N_SHARDS)
    assert len(calls) == 1
    svc = BlinkQLService(db)
    try:
        warm = svc.submit(AVG_TXT)
        svc.cache._on_invalidate("sessions", None)   # a stale entry exists
        db._batched_scan = lambda *a, **kw: call(None)
        with pytest.raises(RuntimeError, match="illegal memory"):
            svc.submit(AVG_TXT)
        assert warm.groups and svc.n_stale == 0
        assert svc.metrics_snapshot()["counters"]["service_ladder_total"][
            "values"].get("retry", 0) == 0
    finally:
        del db._batched_scan
        svc.close()


def test_shard_partition_is_disjoint_and_total():
    shards = shard_of_strata(np.arange(1000, dtype=np.int64), 4)
    assert shards.min() >= 0 and shards.max() < 4
    counts = np.bincount(shards, minlength=4)
    assert counts.sum() == 1000 and (counts > 0).all()


def test_reweight_moments_matches_hand_computation():
    mom = GroupedMoments(*(torch.tensor([v]) for v in
                           (10.0, 20.0, 40.0, 100.0, 4.0, 8.0, 24.0)))
    out = reweight_moments(mom, 2.0)
    np.testing.assert_allclose(out.n.numpy(), [10.0])
    np.testing.assert_allclose(out.wsum.numpy(), [40.0])
    np.testing.assert_allclose(out.wxsum.numpy(), [80.0])
    np.testing.assert_allclose(out.wx2sum.numpy(), [200.0])
    # var' = f²·var + f(f−1)·(matching weighted leaf)
    np.testing.assert_allclose(out.var_count.numpy(), [4 * 4.0 + 2 * 20.0])
    np.testing.assert_allclose(out.var_sum.numpy(), [4 * 8.0 + 2 * 40.0])
    np.testing.assert_allclose(out.var_sum2.numpy(),
                               [4 * 24.0 + 2 * 100.0])


def test_merge_shard_reports():
    a = ShardScanReport(n_shards=4, lost=(1,), rerouted=(), reweight=4 / 3)
    b = ShardScanReport(n_shards=4, lost=(2,), rerouted=(0,), reweight=1.0)
    m = merge_shard_reports([a, None, b])
    assert m.n_shards == 4 and set(m.lost) == {1, 2}
    assert m.rerouted == (0,) and m.reweight == pytest.approx(4 / 3)
    assert m.degraded
    assert merge_shard_reports([None, None]) is None


# ------------------------------------------------ degradation ladder

def test_service_retry_absorbs_bounded_engine_kill(db):
    svc = BlinkQLService(db, config=ServiceConfig(use_cache=False))
    try:
        plan = FaultPlan([FaultSpec(site="engine.scan", kind="kill",
                                    max_fires=1)], seed=0)
        with arm(plan):
            ans = svc.submit(AVG_TXT)
        assert ans.groups and not ans.degraded
        assert plan.n_fires == 1
    finally:
        svc.close()


def test_service_serves_stale_answer_with_declared_staleness(db):
    svc = BlinkQLService(db)
    try:
        warm = svc.submit(AVG_TXT)
        svc.cache._on_invalidate("sessions", None)
        with arm(FaultPlan([FaultSpec(site="engine.scan",
                                      kind="kill")], seed=0)):
            stale = svc.submit(AVG_TXT)
        assert stale.degraded and stale.staleness_s > 0.0
        _assert_bit_identical(warm, stale)
        assert svc.n_stale == 1
        fresh = svc.submit(AVG_TXT)
        assert not fresh.degraded and fresh.staleness_s == 0.0
    finally:
        svc.close()


def test_service_degraded_error_when_ladder_exhausted(db):
    svc = BlinkQLService(db, config=ServiceConfig(use_cache=False))
    try:
        with arm(FaultPlan([FaultSpec(site="engine.scan",
                                      kind="kill")], seed=0)):
            with pytest.raises(DegradedServiceError) as ei:
                svc.submit(AVG_TXT)
        assert isinstance(ei.value.__cause__, InjectedFault)
    finally:
        svc.close()


def test_service_passes_degraded_shard_answer_and_never_caches_it(db):
    svc = BlinkQLService(db)
    try:
        with arm(FaultPlan([FaultSpec(site="shard.scan", kind="kill",
                                      match=(("shard", 1),))], seed=0)):
            ans = svc.submit(AVG_TXT)
        assert ans.degraded and ans.shards_lost == 1
        assert svc.n_degraded == 1
        assert svc.cache.get(_avg_q(db)) is None
        clean = svc.submit(AVG_TXT)
        assert not clean.degraded
        assert svc.cache.get(_avg_q(db)) is not None
    finally:
        svc.close()


def test_service_nonfault_errors_propagate_unretried(db):
    svc = BlinkQLService(db)
    try:
        with pytest.raises(ValueError, match="additive"):
            svc.submit("SELECT AVG(SessionTime) FROM sessions WHERE "
                       "City = 'city001' OR OS = 'os2'")
    finally:
        svc.close()


def test_service_sheds_unmeetable_deadlines(db):
    svc = BlinkQLService(db, config=ServiceConfig(use_cache=False,
                                                  solo_bypass=False))
    try:
        svc.submit("SELECT COUNT(SessionTime) FROM sessions "
                   "WITHIN 5 SECONDS")          # prime the EWMA
        svc._exec_ewma = 10.0                   # a saturated engine
        with pytest.raises(DeadlineShedError):
            svc.submit("SELECT COUNT(SessionTime) FROM sessions "
                       "WHERE City = 'city001' WITHIN 0.05 SECONDS")
        assert isinstance(DeadlineShedError("x"), AdmissionError)
        assert svc.stats()["shed"] == 1
        assert svc.submit(AVG_TXT).groups      # ERROR bounds never shed
    finally:
        svc.close()


# ------------------------------------------------ dispatcher-death safety

def test_dispatcher_death_fails_pending_and_marks_unhealthy(db):
    svc = BlinkQLService(db, config=ServiceConfig(use_cache=False,
                                                  solo_bypass=False))
    with arm(FaultPlan([FaultSpec(site="scheduler.dispatch",
                                  kind="kill")], seed=0)):
        with pytest.raises(ServiceUnhealthyError) as ei:
            svc.submit(AVG_TXT, timeout=30)
        assert isinstance(ei.value.__cause__, InjectedFault)
        assert not svc.healthy
        with pytest.raises(ServiceUnhealthyError):
            svc.submit(AVG_TXT)
        with pytest.raises(ServiceUnhealthyError):
            svc.submit_async(AVG_TXT)
    assert svc.stats()["healthy"] is False
    svc.close()


class _Blocked:
    """db.query_batch held until released: `entered` is set once a batch
    is executing (the stand-in for the reference tests' sleeps)."""

    def __init__(self, db):
        self.db, self.orig = db, db.query_batch
        self.entered, self.release = threading.Event(), threading.Event()

    def __call__(self, qs, **kw):
        self.entered.set()
        assert self.release.wait(30), "never released"
        return self.orig(qs, **kw)

    def __enter__(self):
        self.db.query_batch = self
        return self

    def __exit__(self, *exc):
        self.release.set()
        self.db.query_batch = self.orig
        return False


def test_dispatcher_death_fails_queued_requests_from_other_threads(db):
    svc = BlinkQLService(db, config=ServiceConfig(use_cache=False,
                                                  solo_bypass=False))
    errors = []

    def session():
        try:
            svc.submit(AVG_TXT, timeout=30)
        except BaseException as e:   # noqa: BLE001
            errors.append(e)

    # Kill the SECOND dispatch iteration: the later sessions queue while the
    # first batch executes, and the death handler drains them.
    with arm(FaultPlan([FaultSpec(site="scheduler.dispatch", kind="kill",
                                  after=1)], seed=0)), _Blocked(db) as blk:
        threads = [threading.Thread(target=session) for _ in range(3)]
        threads[0].start()
        assert blk.entered.wait(30)
        for t in threads[1:]:
            t.start()
        while len(svc._queue) < 2 and all(t.is_alive() for t in threads[1:]):
            threading.Event().wait(0.001)
        blk.release.set()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads), "a session hung"
    assert errors and all(isinstance(e, ServiceUnhealthyError)
                          for e in errors)
    svc.close()


# ------------------------------------------------ submit timeout races

@pytest.mark.parametrize("solo_bypass", [False, True])
def test_submit_timeout_frees_slot_and_service_recovers(db, solo_bypass):
    """A timed submit takes the queued path even with the bypass on; the
    abandoned slot is freed and the service answers afterwards (the bypass
    serving solo traffic again)."""
    svc = BlinkQLService(db, config=ServiceConfig(use_cache=False,
                                                  solo_bypass=solo_bypass))
    try:
        with _Blocked(db):
            with pytest.raises(TimeoutError):
                svc.submit(AVG_TXT, timeout=0.05)
        nb0 = svc.n_batches
        ans = svc.submit(AVG_TXT, timeout=None if solo_bypass else 30)
        assert ans.groups and len(svc._queue) == 0
        assert svc.n_batches > nb0
    finally:
        svc.close()


def test_concurrent_submit_timeouts_leak_nothing(db):
    svc = BlinkQLService(db, config=ServiceConfig(use_cache=False,
                                                  solo_bypass=False))
    outcomes = []

    def session():
        try:
            outcomes.append(svc.submit(AVG_TXT, timeout=0.05))
        except TimeoutError:
            outcomes.append("timeout")

    try:
        with _Blocked(db):
            threads = [threading.Thread(target=session) for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads), "a session hung"
        assert len(outcomes) == 4
        ans = svc.submit(AVG_TXT, timeout=30)
        assert ans.groups and len(svc._queue) == 0
    finally:
        svc.close()


# ------------------------------------------------ async / batched submit

def test_submit_many_lands_in_one_batch(db):
    svc = BlinkQLService(db, config=ServiceConfig(use_cache=False,
                                                  solo_bypass=False))
    try:
        texts = [f"SELECT COUNT(SessionTime) FROM sessions "
                 f"WHERE City = 'city{i:03d}'" for i in range(6)]
        nb0 = svc.n_batches
        res = svc.submit_many(texts, timeout=120)
        assert len(res) == 6 and all(r.groups for r in res)
        assert svc.n_batches - nb0 == 1
        assert svc.n_queries == 6
    finally:
        svc.close()


def test_submit_async_future_and_cache_hit(db):
    svc = BlinkQLService(db)
    try:
        ans = svc.submit_async(AVG_TXT).result(timeout=120)
        assert ans.groups
        fut2 = svc.submit_async(AVG_TXT)
        assert fut2.done()
        _assert_bit_identical(ans, fut2.result())
    finally:
        svc.close()


def test_submit_many_mixed_errors_reach_only_their_query(db):
    svc = BlinkQLService(db, config=ServiceConfig(use_cache=False,
                                                  solo_bypass=False))
    try:
        bad = ("SELECT AVG(SessionTime) FROM sessions "
               "WHERE City = 'city001' OR OS = 'os2'")
        with pytest.raises(ValueError, match="additive"):
            svc.submit_many([AVG_TXT, bad], timeout=120)
        assert svc.n_queries >= 1
        assert svc.submit(AVG_TXT, timeout=120).groups
    finally:
        svc.close()


# ------------------------------------------------ supervisor primitives

def test_heartbeat_stamps_each_worker_individually(monkeypatch):
    from repro_torch.fault import supervisor as sup
    ticks = iter(range(100))
    monkeypatch.setattr(sup, "now_s", lambda: float(next(ticks)))
    hb = Heartbeat(n_workers=3)
    assert len(set(hb.last_time.tolist())) == 3


def test_retry_loop_no_sleep_after_final_attempt(monkeypatch):
    from repro_torch.fault import supervisor as sup
    sleeps = []
    monkeypatch.setattr(sup.time, "sleep", sleeps.append)
    calls = []

    def boom():
        calls.append(1)
        raise RuntimeError("nope")

    with pytest.raises(RuntimeError, match="after 2 retries"):
        RetryLoop(max_retries=2, backoff_s=0.1).run(boom)
    assert len(calls) == 3
    assert sleeps == [0.1, 0.2]


def test_retry_loop_raise_last_reraises_original(monkeypatch):
    from repro_torch.fault import supervisor as sup
    monkeypatch.setattr(sup.time, "sleep", lambda s: None)
    original = FloatingPointError("nan")

    def boom():
        raise original

    with pytest.raises(FloatingPointError) as ei:
        RetryLoop(max_retries=1, raise_last=True).run(boom)
    assert ei.value is original


def test_retry_loop_nontransient_propagates_immediately():
    calls = []

    def boom():
        calls.append(1)
        raise ValueError("not transient")

    with pytest.raises(ValueError):
        RetryLoop(max_retries=5).run(boom)
    assert len(calls) == 1


def test_retry_loop_retry_on_is_injectable(monkeypatch):
    from repro_torch.fault import supervisor as sup
    monkeypatch.setattr(sup.time, "sleep", lambda s: None)
    attempts = []

    def flaky():
        attempts.append(1)
        if len(attempts) < 3:
            raise KeyError("transient here")
        return "ok"

    assert RetryLoop(max_retries=3, retry_on=(KeyError,)).run(flaky) == "ok"
    assert len(attempts) == 3


def test_service_retry_on_excludes_runtime_error():
    assert RuntimeError not in ServiceConfig().retry_on
    assert not issubclass(RuntimeError, ServiceConfig().retry_on)


# ------------------------------------------------------- chaos soak

@pytest.mark.parametrize("seed", range(3))
def test_chaos_soak(db, seed):
    """The serving contract under a random bounded fault schedule: every
    submission returns an Answer or raises a TYPED error; non-degraded
    answers agree with the fault-free answer; degraded answers are finite
    and annotated; no session hangs."""
    texts = [f"SELECT AVG(SessionTime) FROM sessions WHERE "
             f"City = 'city{i:03d}' ERROR WITHIN 10% CONFIDENCE 95%"
             for i in range(4)]
    reference = {t: db.query(parse_blinkql(t, db).normalized())
                 for t in texts}
    typed = (FaultError, DegradedServiceError, AdmissionError,
             ServiceUnhealthyError, TimeoutError)
    svc = BlinkQLService(db, config=ServiceConfig(use_cache=False,
                                                  retry_backoff_s=0.001))
    results: list = []

    def session():
        for t in texts:
            try:
                results.append((t, svc.submit(t, timeout=120)))
            except typed as e:
                results.append((t, e))

    try:
        with arm(random_plan(seed)):
            threads = [threading.Thread(target=session) for _ in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in threads), "a session hung"
    finally:
        svc.close()

    assert len(results) == 3 * len(texts)
    for text, res in results:
        if isinstance(res, BaseException):
            continue
        assert _finite(res), "non-finite estimate escaped the fault layer"
        if not res.degraded:
            _assert_close(reference[text], res, rtol=1e-3)
        else:
            assert res.shards_lost > 0 or res.staleness_s > 0.0
