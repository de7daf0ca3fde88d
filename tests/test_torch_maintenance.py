"""Port parity: sample maintenance (core/maintenance.py, paper §4.5/§3.2.3).

The same SampleMaintainer operations run on a reference engine (`repro`)
and a port engine (`repro_torch`, on the CPU) over the same 20k-row
sessions table: run_epoch with a low-drift and a high-drift delta, with a
replacement table and as a refresh; reclaim; check_drift with tombstones;
the fleet maintainer's reclaim against the single-table pass; and the
fleet storage trigger. Every family the port builds from a seed draws the
reference's base_units for it (jax and torch draw different numbers from
one seed); delta and decay units are numpy in both packages.
Reports, families, blocks and generations must be equal, answers equal in
family and K and within rtol 1e-4.
"""
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import maintenance as ref_maint
from repro.core import sampling as ref_samp
from repro.core import table as ref_table
import repro_torch.core as P
from repro_torch.core import maintenance
from repro_torch.core import sampling as samp
from repro_torch.core import table as table_lib
from repro_torch.data import synth

N_ROWS, SEED = 20_000, 1
TPL = {m: [m.QueryTemplate(frozenset({"City"}), 1.0),
           m.QueryTemplate(frozenset({"OS"}), 0.5)] for m in (R, P)}


@pytest.fixture(scope="module", autouse=True)
def reference_units():
    """One torch thread, and the port's seeded builds drawing the
    reference's units for the same seed."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(samp, "base_units", ref_samp.base_units)
        yield
    torch.set_num_threads(prev)


def _raw(n, seed, **kw):
    return synth.sessions_table(n, seed=seed, n_cities=50, **kw)


def _pair(tables=("s",), n=N_ROWS, families=(("City",), ())):
    ref = R.BlinkDB(R.EngineConfig(k1=300.0, m=3, seed=SEED,
                                   use_pallas=True))
    port = P.BlinkDB(P.EngineConfig(k1=300.0, m=3, seed=SEED), device="cpu")
    for i, name in enumerate(tables):
        raw = _raw(n, 2 + i)
        ref.register_table(name, ref_table.from_columns(name, raw))
        port.register_table(name, table_lib.from_columns(name, raw))
        for phi in families:
            ref.add_family(name, phi)
            port.add_family(name, phi)
            ref._striped_for(name, phi)
            port._striped_for(name, phi)
    return ref, port


def _maintainers(ref, port, cfg=None, **kw):
    cfg = cfg or {}
    tpl = kw.pop("templates", None)
    mk = []
    for db, mod, m in ((ref, ref_maint, R), (port, maintenance, P)):
        if "tables" in kw:
            args = dict(tables={t: TPL[m] for t in kw["tables"]})
        else:
            args = dict(table_name="s", templates=tpl or TPL[m])
        mk.append(mod.SampleMaintainer(db, config=mod.MaintenanceConfig(
            **cfg), **args))
    return mk


def _assert_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a), set(b))
        for k in a:
            _assert_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)
    else:
        assert a == b, (path, a, b)


def _assert_engines_equal(ref, port, table="s"):
    assert set(port.families[table]) == set(ref.families[table])
    for phi, fa in ref.families[table].items():
        fb = port.families[table][phi]
        for f in ("ks", "prefix_sizes", "n_rows", "table_rows"):
            assert getattr(fb, f) == getattr(fa, f), (phi, f)
        for f in ("stratum_freqs", "live_freqs", "strata_keys", "row_strata",
                  "entry_key_host", "unit_host", "row_ids"):
            np.testing.assert_array_equal(getattr(fb, f), getattr(fa, f),
                                          err_msg=f"{phi} {f}")
        for c in fb.columns_host:
            np.testing.assert_array_equal(fb.host_column(c),
                                          fa.host_column(c))
        sa, sb = ref._striped.get((table, phi)), port._striped.get((table, phi))
        assert (sa is None) == (sb is None), phi
        if sa is not None:
            for f in ("unit", "strat", "valid", "freq_table"):
                np.testing.assert_array_equal(
                    getattr(sb, f).numpy(),
                    np.asarray(getattr(sa, f)).reshape(-1), err_msg=f)
            np.testing.assert_array_equal(sb.slot_row_ids, sa.slot_row_ids)
            assert (sb.n_rows, sb.n_ghosts) == (sa.n_rows, sa.n_ghosts)
    assert port._generations == ref._generations
    assert port._family_set_gen == ref._family_set_gen
    assert port.tables[table].n_rows == ref.tables[table].n_rows
    assert port.tables[table].n_live == ref.tables[table].n_live


def _assert_same_answer(a, b, rtol=1e-4):
    assert (b.sample_phi, b.sample_k, b.rows_read, b.rows_total) == \
        (a.sample_phi, a.sample_k, a.rows_read, a.rows_total)
    assert [g.key for g in b.groups] == [g.key for g in a.groups]
    for ga, gb in zip(a.groups, b.groups):
        assert gb.n_selected == ga.n_selected
        for f in ("estimate", "stderr"):
            np.testing.assert_allclose(getattr(gb, f), getattr(ga, f),
                                       rtol=rtol, atol=1e-9, err_msg=f)


def _answers_agree(ref, port, table="s"):
    for agg, col in (("COUNT", None), ("AVG", "SessionTime"),
                     ("QUANTILE", "SessionTime")):
        qs = [m.Query(table, getattr(m.AggOp, agg), col, group_by=("OS",),
                      bound=m.ErrorBound(0.1)) for m in (R, P)]
        _assert_same_answer(ref.query(qs[0]), port.query(qs[1]))


def _delete(db, m, col, values, table="s"):
    for v in values:
        db.delete_rows(table, m.Predicate.where(m.Atom(col, m.CmpOp.EQ, v)))


# -- epochs -------------------------------------------------------------------

@pytest.fixture(scope="module")
def epochs():
    """run_epoch on both engines: a low-drift delta, a high-drift delta, a
    replacement table, a refresh; the reports and the engines after each."""
    ref, port = _pair()
    mr, mp = _maintainers(ref, port, dict(drift_threshold=0.05,
                                          compact_threshold=0.05,
                                          base_compact_threshold=0.1,
                                          decay_ratio=1.3))
    out = {}
    low = _raw(2000, 31)
    skew = _raw(3000, 32)
    skew["City"] = np.array(["city40"] * 3000)
    for db, m in ((ref, R), (port, P)):
        _delete(db, m, "dt", range(4))
    steps = [
        ("low_drift", lambda mt: mt.run_epoch(delta=low)),
        ("high_drift", lambda mt: mt.run_epoch(delta=skew)),
        ("replacement", None),
        ("refresh", lambda mt: mt.run_epoch()),
    ]
    for label, op in steps:
        if op is None:
            raw = _raw(N_ROWS, 33)
            reps = (mr.run_epoch(new_table=ref_table.from_columns("s", raw)),
                    mp.run_epoch(new_table=table_lib.from_columns("s", raw)))
        else:
            reps = (op(mr), op(mp))
        out[label] = reps
        _assert_engines_equal(ref, port)
        _answers_agree(ref, port)
    return out


EPOCHS = ["low_drift", "high_drift", "replacement", "refresh"]


@pytest.mark.parametrize("label", EPOCHS)
def test_run_epoch_reports_equal_the_reference(epochs, label):
    a, b = epochs[label]
    _assert_equal(a, b, label)


def test_epochs_took_their_paths(epochs):
    low, high = epochs["low_drift"][1], epochs["high_drift"][1]
    assert not low["rebuilt"] and low["merged"] and low["base_compacted"]
    assert ("City",) in high["rebuilt"] and high["drift"][("City",)] > 0.05
    assert epochs["replacement"][1]["drift"]
    assert epochs["refresh"][1]["drift"] == {}


# -- reclaim, drift, fleet --------------------------------------------------------

def test_reclaim_equals_the_reference():
    ref, port = _pair()
    mr, mp = _maintainers(ref, port, dict(compact_threshold=0.05,
                                          base_compact_threshold=0.1,
                                          decay_ratio=1.2))
    for db, m in ((ref, R), (port, P)):
        _delete(db, m, "City", ["city01", "city04"])
        _delete(db, m, "dt", range(6))
        db.append_rows("s", _raw(1500, 40))
    assert port.dead_fraction("s") == ref.dead_fraction("s") > 0.1
    _assert_equal(ref.storage_stats("s"), port.storage_stats("s"))
    _assert_equal(ref.ghost_fractions("s"), port.ghost_fractions("s"))
    a, b = mr.reclaim(), mp.reclaim()
    _assert_equal(a, b)
    assert b["base_compacted"] and b["decayed"] and b["compacted"]
    _assert_engines_equal(ref, port)
    _answers_agree(ref, port)
    _assert_equal(ref.storage_stats("s"), port.storage_stats("s"))
    assert mp.reclaim() == {"base_compacted": 0, "decayed": {},
                            "compacted": []}


def test_check_drift_with_tombstones_equals_the_reference():
    ref, port = _pair(families=(("City",),))
    mr, mp = _maintainers(ref, port)
    raw = _raw(N_ROWS, 2)
    for db, m in ((ref, R), (port, P)):
        _delete(db, m, "City", ["city00"])
    a = mr.check_drift(ref_table.from_columns("s", raw))
    b = mp.check_drift(table_lib.from_columns("s", raw))
    _assert_equal(a, b)
    assert b[("City",)] > 0.05
    live = port.tables["s"].live
    tabs = [mod.from_columns("s", {k: v[live] for k, v in raw.items()})
            for mod in (ref_table, table_lib)]
    a, b = mr.check_drift(tabs[0]), mp.check_drift(tabs[1])
    _assert_equal(a, b)
    assert b[("City",)] < 0.01
    for t, m in zip(tabs, (R, P)):
        t.delete(m.Predicate.where(m.Atom("City", m.CmpOp.EQ, "city01")))
    _assert_equal(mr.check_drift(tabs[0]), mp.check_drift(tabs[1]))


def test_fleet_reclaim_bit_identical_to_single_table():
    """Co-tenant table "b" changes nothing of "a"'s reclamation, and both
    equal the reference's."""
    fleet_ref, fleet = _pair(tables=("a", "b"), n=8000,
                             families=(("City",),))
    solo_ref, solo = _pair(tables=("a",), n=8000, families=(("City",),))
    m_fleet_ref, m_fleet = _maintainers(fleet_ref, fleet, tables=("a", "b"))
    m_solo_ref, m_solo = _maintainers(solo_ref, solo, tables=("a",))
    doomed = [f"city{i:02d}" for i in range(7)]
    for db, m in ((fleet_ref, R), (fleet, P), (solo_ref, R), (solo, P)):
        _delete(db, m, "City", doomed, table="a")
    for db, m in ((fleet_ref, R), (fleet, P)):
        _delete(db, m, "City", doomed[:3], table="b")
    reps = [m_fleet.reclaim(table="a"), m_solo.reclaim(),
            m_fleet_ref.reclaim(table="a"), m_solo_ref.reclaim()]
    for r in reps[1:]:
        _assert_equal(reps[0], r)
    _assert_engines_equal(fleet_ref, fleet, "a")
    _assert_engines_equal(solo_ref, solo, "a")
    for f in ("unit", "strat", "valid", "freq_table"):
        assert torch.equal(getattr(fleet._striped_for("a", ("City",)), f),
                           getattr(solo._striped_for("a", ("City",)), f))
    q = P.Query("a", P.AggOp.AVG, "SessionTime", bound=P.ErrorBound(0.1),
                predicate=P.Predicate.where(P.Atom("City", P.CmpOp.EQ,
                                                   "city20")))
    a, b = fleet.query(q), solo.query(q)
    assert [(g.key, g.estimate, g.stderr) for g in a.groups] == \
        [(g.key, g.estimate, g.stderr) for g in b.groups]


def test_storage_budget_trigger_equals_the_reference():
    ref, port = _pair(tables=("a", "b"), n=8000, families=(("City",),))
    mr, mp = _maintainers(ref, port, tables=("a", "b"))
    assert mp.maybe_reclaim_fleet() is None is mr.maybe_reclaim_fleet()
    for db, m in ((ref, R), (port, P)):
        for t in ("a", "b"):
            _delete(db, m, "City", ["city01", "city02", "city03"], t)
    for t in ("a", "b"):
        assert port.dead_fraction(t) < mp.config.base_compact_threshold
    _assert_equal(mr.storage_status(), mp.storage_status())
    assert mp.storage_pressure() >= mp.config.reclaim_pressure
    a, b = mr.maybe_reclaim_fleet(), mp.maybe_reclaim_fleet()
    _assert_equal(a, b)
    for t in ("a", "b"):
        assert b["tables"][t]["base_compacted"] > 0
        assert port.dead_fraction(t) == 0.0
        _assert_engines_equal(ref, port, t)
    assert mp.maybe_reclaim_fleet() is None
    snap, ref_snap = port.metrics.snapshot(), ref.metrics.snapshot()
    for kind in ("counters", "gauges"):
        mine = {k: v for k, v in snap[kind].items()
                if k.startswith("maintenance_")}
        assert mine == {k: v for k, v in ref_snap[kind].items()
                        if k.startswith("maintenance_")}
    assert snap["counters"]["maintenance_fleet_reclaims_total"][
        "values"] == {"": 1.0}
    fleet = mp.run_fleet_epoch()
    _assert_equal(mr.run_fleet_epoch(), fleet)
    assert set(fleet["tables"]) == {"a", "b"} and "fleet_reclaim" in fleet


def test_workload_epoch_equals_the_reference():
    ref, port = _pair()
    mr, mp = _maintainers(ref, port)
    new = {m: [m.QueryTemplate(frozenset({"OS"}), 1.0),
               m.QueryTemplate(frozenset({"Genre", "OS"}), 0.5)]
           for m in (R, P)}
    a, b = mr.run_workload_epoch(new[R]), mp.run_workload_epoch(new[P])
    _assert_equal(a, b)
    _assert_engines_equal(ref, port)
    assert mp.templates == new[P]


def test_background_thread_starts_and_stops():
    _, port = _pair(families=(("City",),))
    mp = maintenance.SampleMaintainer(port, "s", TPL[P])
    mp.start(period_s=3600.0)
    assert mp._thread.is_alive()
    mp.stop()
    assert not mp._thread.is_alive() and mp.epochs == 0
