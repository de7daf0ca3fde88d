"""Port parity and contracts: fleet placement of logical sample shards.

Against the reference (`repro`; the port on the CPU with the reference's
sample units): the placements, the routed shard sets and the per-shard
sample load of one family are equal. Then the reference's
tests/test_placement.py contracts on the port: deterministic home and
replica chains, hot replication, routing provenance that agrees with the
scan's stratum hash and declines what it cannot pin, process-kill
fail-over bit-identical with no shard lost, every process down raising the
typed error, hot-family promotion through the service, and the placement
attributes on scan spans.
"""
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import sampling as ref_samp
from repro.core import table as ref_table
from repro.core.types import CmpOp as RefCmpOp
from repro.data import synth as ref_synth
from repro.sharding import placement as ref_place
import repro_torch.core as P
from repro_torch import state
from repro_torch.core import table as table_lib
from repro_torch.core.executor import shard_of_strata
from repro_torch.core.types import CmpOp
from repro_torch.data import synth
from repro_torch.fault.inject import AllShardsLostError, FaultPlan, FaultSpec, arm
from repro_torch.obs.trace import QueryTrace, activate
from repro_torch.service import BlinkQLService, ServiceConfig, parse_blinkql
from repro_torch.sharding.placement import (PlacementConfig, PlacementMap,
                                            build_placement, route_shard_set,
                                            shard_load)

N_ROWS, DATA_SEED, SEED = 20_000, 2, 1
N_SHARDS = 4   # EngineConfig default n_logical_shards
AVG_TXT = ("SELECT AVG(SessionTime) FROM sessions WHERE City = 'city003' "
           "ERROR WITHIN 10% CONFIDENCE 95%")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_db(n_rows=N_ROWS, **cfg):
    d = P.BlinkDB(P.EngineConfig(k1=400.0, m=3, seed=SEED, **cfg),
                  device="cpu")
    d.register_table("sessions", table_lib.from_columns(
        "sessions", synth.sessions_table(n_rows, seed=DATA_SEED)))
    state.install_families(d, "sessions", {
        ("City",): ref_samp.base_units(n_rows, SEED),
        (): ref_samp.base_units(n_rows, SEED, uniform=True)})
    return d


@pytest.fixture(scope="module")
def db():
    return _port_db()


def _q(db, text=AVG_TXT):
    return parse_blinkql(text, db).normalized()


def _assert_bit_identical(a, b):
    ka = {g.key: g for g in a.groups}
    kb = {g.key: g for g in b.groups}
    assert ka.keys() == kb.keys()
    for key in ka:
        assert ka[key].estimate == kb[key].estimate
        assert ka[key].stderr == kb[key].stderr


# ------------------------------------------------------ parity (reference)

@pytest.mark.parametrize("n_proc, n_rep, hot_rep, n_logical", [
    (2, 2, 3, 4), (3, 2, 4, 7), (1, 2, 3, 4), (4, 3, 5, 2)])
def test_placement_matches_the_reference(n_proc, n_rep, hot_rep, n_logical):
    for hot in (False, True):
        want = ref_place.build_placement(
            "t", ("City",), n_logical,
            ref_place.PlacementConfig(n_proc, n_rep, hot_rep), hot=hot)
        got = build_placement("t", ("City",), n_logical,
                              PlacementConfig(n_proc, n_rep, hot_rep),
                              hot=hot)
        assert got.replicas == want.replicas
        assert got.span_attrs() == want.span_attrs()
        assert [got.shards_on(p) for p in range(n_proc)] == \
            [want.shards_on(p) for p in range(n_proc)]


def test_routes_and_shard_load_match_the_reference(db):
    ref = R.BlinkDB(R.EngineConfig(k1=400.0, m=3, seed=SEED))
    ref.register_table("sessions", ref_table.from_columns(
        "sessions", ref_synth.sessions_table(N_ROWS, seed=DATA_SEED)))
    ref.add_family("sessions", ("City",))
    fam_r = ref.families["sessions"][("City",)]
    fam_p = db.families["sessions"][("City",)]
    np.testing.assert_array_equal(fam_p.strata_keys, fam_r.strata_keys)
    cases = [
        (((("City", "EQ"),),), [(float(c),) for c in (0, 3, 17, 150)]),
        (((("City", "EQ"), ("OS", "EQ")),), [(3.0, 1.0)]),
        (((("City", "EQ"),), (("City", "EQ"),)), [(1.0, 5.0), (2.0, 9.0)]),
        (((("City", "GE"),),), [(1.0,)]),
        (((("OS", "EQ"),),), [(0.0,)]),
    ]
    for struct, consts in cases:
        for n_logical in (2, 4, 7):
            want = ref_place.route_shard_set(
                fam_r.strata_keys, ("City",),
                tuple(tuple((c, RefCmpOp[o]) for c, o in conj)
                      for conj in struct), consts, n_logical)
            got = route_shard_set(
                fam_p.strata_keys, ("City",),
                tuple(tuple((c, CmpOp[o]) for c, o in conj)
                      for conj in struct), consts, n_logical)
            assert got == want
    for n_logical in (2, 4, 7):
        np.testing.assert_array_equal(
            shard_load(db._striped_for("sessions", ("City",)), n_logical),
            ref_place.shard_load(ref._striped_for("sessions", ("City",)),
                                 n_logical))


# -------------------------------------------------------- placement layer

def test_build_placement_round_robin_and_deterministic():
    cfg = PlacementConfig(n_processes=2, n_replicas=2, hot_replicas=3)
    pl = build_placement("t", ("City",), 4, cfg)
    assert [pl.home(s) for s in range(4)] == [0, 1, 0, 1]
    for s in range(4):
        chain = pl.replicas_for(s)
        assert len(chain) == 2
        assert chain[0] == pl.home(s)
        assert len(set(chain)) == 2
    assert pl.replicas == build_placement("t", ("City",), 4, cfg).replicas
    for p in range(2):
        assert pl.shards_on(p) == tuple(
            s for s in range(4) if pl.home(s) == p)
    assert sorted(pl.shards_on(0) + pl.shards_on(1)) == [0, 1, 2, 3]


def test_hot_placement_grows_failover_chain():
    cfg = PlacementConfig(n_processes=2, n_replicas=2, hot_replicas=3)
    pm = PlacementMap(cfg)
    cold = pm.for_family("t", ("City",), 4)
    assert cold.n_replicas == 2 and not cold.hot
    assert pm.mark_hot("t", ("City",)) is True
    assert pm.mark_hot("t", ("City",)) is False   # idempotent
    hot = pm.for_family("t", ("City",), 4)
    assert hot.hot and hot.n_replicas == 3
    assert hot.replicas == tuple(
        tuple((s + r) % 2 for r in range(3)) for s in range(4))
    assert pm.hot_families() == [("t", ("City",))]


def test_span_attrs_are_json_plain():
    attrs = build_placement("t", ("City",), 4, PlacementConfig()).span_attrs()
    assert attrs["n_processes"] == 2 and attrs["hot"] is False
    assert attrs["homes"] == [0, 1, 0, 1]


# ------------------------------------------------- routing + shard load

def test_route_shard_set_matches_scan_hash(db):
    fam = db.families["sessions"][("City",)]
    cities = db.tables["sessions"].dictionaries["City"]
    code = float(np.flatnonzero(cities == "city003")[0])
    route = route_shard_set(fam.strata_keys, ("City",),
                            ((("City", CmpOp.EQ),),), [(code,)], N_SHARDS)
    d = int(np.flatnonzero(fam.strata_keys[:, 0] == code)[0])
    assert route == (int(shard_of_strata(np.array([d]), N_SHARDS)[0]),)


def test_route_declines_unpinned_predicates(db):
    fam = db.families["sessions"][("City",)]
    assert route_shard_set(fam.strata_keys, ("City",),
                           ((("City", CmpOp.GE),),), [(1.0,)],
                           N_SHARDS) is None
    assert route_shard_set(fam.strata_keys, ("City",), (), [],
                           N_SHARDS) is None
    assert route_shard_set(fam.strata_keys, ("City",),
                           ((("OS", CmpOp.EQ),),), [(0.0,)],
                           N_SHARDS) is None


def test_shard_load_partitions_sample(db):
    load = shard_load(db._striped_for("sessions", ("City",)), N_SHARDS)
    assert load.shape == (N_SHARDS,)
    assert int(load.sum()) == db.families["sessions"][("City",)].n_rows


# --------------------------------------------- fail-over under placement

def test_process_kill_fails_over_bit_identical(db):
    q = _q(db)
    with arm(FaultPlan([FaultSpec(site="nowhere", kind="kill")], seed=0)):
        sharded = db.query(q)
    plan = FaultPlan([FaultSpec(site="shard.scan", kind="kill",
                                match=(("process", 0),))], seed=0)
    with arm(plan):
        failed_over = db.query(q)
        _, _, _, rep = db._run_at_k("sessions", q, ("City",),
                                    failed_over.sample_k)
    assert plan.n_fires > 0
    assert failed_over.shards_lost == 0 and not failed_over.degraded
    # Every shard homed on process 0 (shards 0 and 2) served by its replica.
    assert rep.rerouted == (0, 2) and rep.lost == ()
    _assert_bit_identical(sharded, failed_over)


def test_all_processes_down_raises_typed_error(db):
    plan = FaultPlan([FaultSpec(site="shard.scan", kind="kill",
                                match=(("process", p),)) for p in (0, 1)],
                     seed=0)
    with arm(plan), pytest.raises(AllShardsLostError):
        db.query(_q(db))


def test_hot_chain_survives_a_third_process_loss():
    """A hot family's longer chain fails over where a cold one is lost:
    with three processes, killing the first two replicas' processes of
    shard 0 loses it cold and reroutes it hot."""
    d = _port_db(5_000, n_processes=3)
    q = _q(d)
    plan = [FaultSpec(site="shard.scan", kind="kill",
                      match=(("shard", 0), ("process", p))) for p in (0, 1)]
    with arm(FaultPlan(plan, seed=0)):
        cold = d.query(q)
    assert d.mark_hot_family("sessions", ("City",))
    d._elp_cache.clear()
    with arm(FaultPlan(plan, seed=0)):
        hot = d.query(q)
    assert cold.shards_lost == 1 and hot.shards_lost == 0


# ------------------------------------------------ service hot promotion

def test_service_promotes_hot_family(db):
    svc = BlinkQLService(db, config=ServiceConfig(
        use_cache=False, hot_family_min=8, hot_family_share=0.25))
    try:
        for _ in range(12):
            svc.submit(AVG_TXT)
    finally:
        svc.close()
    assert db.placements.is_hot("sessions", ("City",))
    pl = db.placements.for_family("sessions", ("City",),
                                  db.config.n_logical_shards)
    assert pl.n_replicas == db.config.hot_replicas
    assert db.metrics.snapshot()["gauges"]["engine_hot_families"][
        "values"][""] == 1.0
    _assert_bit_identical(db.query(_q(db)), db.query(_q(db)))


def test_hot_promotion_disabled_by_config():
    d = _port_db(5_000)
    svc = BlinkQLService(d, config=ServiceConfig(
        use_cache=False, hot_replication=False, hot_family_min=4))
    try:
        for _ in range(8):
            svc.submit(AVG_TXT)
    finally:
        svc.close()
    assert not d.placements.is_hot("sessions", ("City",))


# ------------------------------------------------------- obs integration

def test_scan_span_carries_placement_attrs(db):
    tr = QueryTrace("placement")
    with activate(tr):
        db.query(_q(db))
    scans = [s for s in tr.spans if s.name == "scan"]
    assert scans, "query must open a scan span"
    attrs = scans[0].attrs
    assert attrs["placement"]["n_processes"] == db.config.n_processes
    assert attrs["placement"]["homes"] == [
        s % db.config.n_processes
        for s in range(db.config.n_logical_shards)]
    assert attrs["shard_set"] != "all" and len(attrs["shard_set"]) == 1
