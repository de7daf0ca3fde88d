"""Port parity: the mutation lifecycle (append, delete, update, base-table
compaction, inclusion-frequency decay, ghost-slot compaction).

One sequence of mutations runs on a reference engine (`repro`,
use_pallas=True: the port's one QUANTILE semantics) and on a port engine
(`repro_torch`, on the CPU) over the same 30k-row sessions table, the
reference's sample units carried into the port. Delta and decay units come
from numpy in both packages, so no units need carrying after the build.
After every step the families must be equal array for array, the striped
blocks slot for slot, the reports and generations equal, the answers equal
in family and K and within rtol 1e-4, exact_query must leave tombstoned
rows out, and query_batch must equal query() bit for bit.

Below it: the table and sampling layers against the reference's on the
same inputs, the port's own incremental-equals-rebuild oracle (the
reference's tests/test_mutations.py, its mirror's units copied), a
subsampled answer after an in-place append, and the re-registration of a
table under a name in use.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import maintenance as ref_maint
from repro.core import sampling as ref_samp
from repro.core import table as ref_table
import repro_torch.core as P
from repro_torch import state
from repro_torch.core import maintenance
from repro_torch.core import sampling as samp
from repro_torch.core import table as table_lib
from repro_torch.data import synth

N_ROWS, DATA_SEED, SEED = 30_000, 5, 11
CFG = dict(k1=400.0, m=3, seed=SEED)
FAMILIES = (("City",), ("OS",), ())
NEW_CITY = "cityNEW"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _raw(n, seed):
    return synth.sessions_table(n, seed=seed, n_cities=50)


def _units(n=N_ROWS, seed=SEED):
    return {phi: ref_samp.base_units(n, seed, uniform=(phi == ()))
            for phi in FAMILIES}


def _engines(n=N_ROWS, families=FAMILIES, **cfg):
    """(reference, port) over the same table and families, the reference's
    units installed in the port, every block striped."""
    cfg = {**CFG, **cfg}
    ref = R.BlinkDB(R.EngineConfig(**cfg, use_pallas=True))
    ref.register_table("s", ref_table.from_columns("s", _raw(n, DATA_SEED)))
    for phi in families:
        ref.add_family("s", phi)
    port = P.BlinkDB(P.EngineConfig(**cfg), device="cpu")
    port.register_table("s", table_lib.from_columns("s", _raw(n, DATA_SEED)))
    state.install_families(port, "s", {phi: u for phi, u in
                                       _units(n, cfg["seed"]).items()
                                       if phi in families})
    for phi in families:
        ref._striped_for("s", phi)
        port._striped_for("s", phi)
    return ref, port


def _queries(m):
    genre = m.Predicate.where(m.Atom("Genre", m.CmpOp.EQ, "genre03"))
    return {
        "count_by_os": m.Query("s", m.AggOp.COUNT, group_by=("OS",),
                               bound=m.ErrorBound(0.1)),
        "avg_by_city": m.Query("s", m.AggOp.AVG, "SessionTime",
                               group_by=("City",), bound=m.ErrorBound(0.1)),
        "sum_genre": m.Query("s", m.AggOp.SUM, "Bitrate", predicate=genre,
                             bound=m.ErrorBound(0.05)),
        "median": m.Query("s", m.AggOp.QUANTILE, "SessionTime",
                          quantile=0.5, bound=m.ErrorBound(0.1)),
        "new_city": m.Query("s", m.AggOp.COUNT, predicate=m.Predicate.where(
            m.Atom("City", m.CmpOp.EQ, NEW_CITY)), bound=m.ErrorBound(0.1)),
    }


def _delta(n, seed, n_new=60):
    raw = _raw(n, seed)
    raw["City"] = raw["City"].astype(object)
    raw["City"][:n_new] = NEW_CITY
    raw["City"] = raw["City"].astype(str)
    return raw


def _decay(db, m_maint, ratio=1.2):
    fam = db.families["s"][("City",)]
    return db.decay_family("s", ("City",), m_maint.strata_to_decay(fam, ratio))


# (label, op(engine, types module, maintenance module) -> report)
STEPS = [
    ("append", lambda db, m, mm: db.append_rows("s", _delta(3000, 101))),
    ("delete", lambda db, m, mm: db.delete_rows("s", m.Predicate.where(
        m.Atom("dt", m.CmpOp.LT, 6)))),
    ("update", lambda db, m, mm: db.update_rows("s", m.Predicate.where(
        m.Atom("Genre", m.CmpOp.EQ, "genre03")), {"Bitrate": 1000.0})),
    ("append_restripe", lambda db, m, mm: db.append_rows(
        "s", _raw(12_000, 102))),
    ("compact_table", lambda db, m, mm: db.compact_table("s")),
    ("decay", lambda db, m, mm: _decay(db, mm)),
    ("compact_family", lambda db, m, mm: [db.compact_family("s", phi)
                                          for phi in FAMILIES]),
]
STEP_NAMES = ["initial"] + [label for label, _ in STEPS]


def _family_state(fam) -> dict:
    out = {f: getattr(fam, f) for f in (
        "phi", "ks", "prefix_sizes", "n_rows", "table_rows", "n_distinct")}
    for f in ("stratum_freqs", "live_freqs", "strata_keys", "row_strata",
              "entry_key_host", "unit_host", "row_ids"):
        out[f] = np.array(getattr(fam, f))
    names = fam.columns if hasattr(fam, "columns") and \
        not isinstance(fam, samp.SampleFamily) else fam.columns_host
    out["columns"] = {c: np.array(fam.host_column(c)) for c in names}
    return out


def _block_state(striped) -> dict:
    def arr(a):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        return a.reshape(-1).copy()
    out = {f: arr(getattr(striped, f))
           for f in ("valid", "unit", "strat", "freq_table")}
    out["columns"] = {c: arr(a) for c, a in striped.columns.items()}
    out["slot_row_ids"] = np.array(striped.slot_row_ids)
    for f in ("n_rows", "n_ghosts", "table_rows", "n_local"):
        out[f] = getattr(striped, f)
    return out


def _report_state(rep):
    if rep is None or isinstance(rep, (list, bool)):
        return rep
    if dataclasses.is_dataclass(rep) and hasattr(rep, "remap"):
        return {"remap": rep.remap, "n_dropped": rep.n_dropped,
                "n_rows_before": rep.n_rows_before}
    if hasattr(rep, "n_admitted"):
        return {"strata": rep.strata, "n_dropped": rep.n_dropped,
                "n_admitted": rep.n_admitted, "epoch": rep.epoch}
    out = {"freqs": rep.freqs, "restriped": sorted(rep.restriped),
           "epoch": rep.epoch}
    if hasattr(rep, "tombstoned_sampled"):
        out["tombstoned_sampled"] = rep.tombstoned_sampled
        out["tombstoned"] = rep.mutation.tombstoned
    else:
        out["start_row"] = rep.delta.start_row
        out["n_rows"] = rep.delta.n_rows
    return out


def answer_bits(ans) -> tuple:
    return (ans.sample_phi, ans.sample_k, ans.rows_read, ans.bound_met,
            ans.certified, ans.predicted_half_width,
            [(g.key, g.estimate, g.stderr, g.ci_low, g.ci_high, g.n_selected,
              g.exact) for g in ans.groups])


def _snapshot(ref, port, rep_ref, rep_port) -> dict:
    snap = {"families": {}, "blocks": {}}
    for phi in FAMILIES:
        snap["families"][phi] = (_family_state(ref.families["s"][phi]),
                                 _family_state(port.families["s"][phi]))
        snap["blocks"][phi] = (_block_state(ref._striped_for("s", phi)),
                               _block_state(port._striped_for("s", phi)))
    snap["reports"] = (_report_state(rep_ref), _report_state(rep_port))
    snap["generations"] = (
        (dict(ref._generations), dict(ref._family_set_gen)),
        (dict(port._generations), dict(port._family_set_gen)))
    rq, pq = _queries(R), _queries(P)
    snap["answers"] = {name: (ref.query(rq[name]), port.query(pq[name]))
                       for name in rq}
    # query_batch on the same engine replays query()'s decisions
    batch = port.query_batch(list(pq.values()))
    snap["batch"] = [(answer_bits(a), answer_bits(snap["answers"][n][1]))
                     for n, a in zip(pq, batch)]
    ex = {m: m.Query("s", m.AggOp.COUNT, group_by=("OS",)) for m in (R, P)}
    tbl = port.tables["s"]
    live = (np.ones(tbl.n_rows, bool) if tbl.live is None else tbl.live)
    os_codes = tbl.host_column("OS")[live]
    snap["exact"] = (ref.exact_query(ex[R]), port.exact_query(ex[P]),
                     np.bincount(os_codes, minlength=tbl.cardinality("OS")),
                     tbl.dictionaries["OS"])
    return snap


@pytest.fixture(scope="module")
def sequence():
    ref, port = _engines()
    snaps = {"initial": _snapshot(ref, port, None, None)}
    for label, op in STEPS:
        rep_ref = op(ref, R, ref_maint)
        rep_port = op(port, P, maintenance)
        snaps[label] = _snapshot(ref, port, rep_ref, rep_port)
    return snaps


def _assert_equal_tree(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_equal_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)) and not isinstance(a, str):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_tree(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype or a.dtype.kind == b.dtype.kind == "U", \
            (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


def _assert_same_answer(a, b, rtol=1e-4):
    assert b.sample_phi == a.sample_phi
    assert b.sample_k == a.sample_k
    assert b.rows_read == a.rows_read
    assert b.rows_total == a.rows_total
    assert (b.bound_met, b.certified) == (a.bound_met, a.certified)
    assert [g.key for g in b.groups] == [g.key for g in a.groups]
    for ga, gb in zip(a.groups, b.groups):
        assert gb.exact == ga.exact and gb.n_selected == ga.n_selected
        for f in ("estimate", "stderr", "ci_low", "ci_high"):
            np.testing.assert_allclose(getattr(gb, f), getattr(ga, f),
                                       rtol=rtol, atol=1e-9, err_msg=f)


# -- the sequence, after every step ---------------------------------------------

@pytest.mark.parametrize("step", STEP_NAMES)
def test_families_equal_the_reference(sequence, step):
    for phi, (a, b) in sequence[step]["families"].items():
        _assert_equal_tree(a, b, f"{step} {phi}")


@pytest.mark.parametrize("step", STEP_NAMES)
def test_blocks_equal_the_reference_slot_for_slot(sequence, step):
    for phi, (a, b) in sequence[step]["blocks"].items():
        _assert_equal_tree(a, b, f"{step} {phi}")


@pytest.mark.parametrize("step", STEP_NAMES)
def test_reports_and_generations_equal(sequence, step):
    _assert_equal_tree(*sequence[step]["reports"], step)
    _assert_equal_tree(*sequence[step]["generations"], step)


@pytest.mark.parametrize("step", STEP_NAMES)
def test_answers_match_the_reference(sequence, step):
    for name, (a, b) in sequence[step]["answers"].items():
        try:
            _assert_same_answer(a, b)
        except AssertionError as e:
            raise AssertionError(f"{step} {name}: {e}") from e


@pytest.mark.parametrize("step", STEP_NAMES)
def test_query_batch_equals_query_bit_for_bit(sequence, step):
    for got, want in sequence[step]["batch"]:
        assert got == want


@pytest.mark.parametrize("step", STEP_NAMES)
def test_exact_query_leaves_tombstones_out(sequence, step):
    ref_ans, port_ans, live_counts, os_names = sequence[step]["exact"]
    _assert_same_answer(ref_ans, port_ans)
    got = {g.key: g.estimate for g in port_ans.groups}
    want = {(os_names[c],): float(n) for c, n in enumerate(live_counts) if n}
    assert got == want
    assert port_ans.rows_total == sum(live_counts)


def test_sequence_exercised_every_path(sequence):
    """The steps did what they are named for: the new city opened a
    stratum, the delete and update ghosted sampled rows, the large append
    outgrew a block, the compactions reclaimed, the decay reset strata."""
    port = {label: sequence[label]["reports"][1] for label in STEP_NAMES}
    city_keys = sequence["append"]["families"][("City",)][1]["strata_keys"]
    assert len(city_keys) == 51
    assert sequence["append"]["answers"]["new_city"][1].groups[0].estimate \
        == 60.0
    assert all(n > 0 for n in port["delete"]["tombstoned_sampled"].values())
    assert port["update"]["epoch"] == 2
    assert port["append_restripe"]["restriped"]
    assert port["compact_table"]["n_dropped"] > 0
    assert port["decay"]["strata"].size > 0
    assert all(port["compact_family"])
    assert all(b[1]["n_ghosts"] == 0
               for b in sequence["compact_family"]["blocks"].values())
    assert any(b[1]["n_ghosts"] > 0
               for b in sequence["update"]["blocks"].values())


# -- the table layer --------------------------------------------------------------

def _tables():
    raw = {"key": np.array(["b", "a", "c", "a", "b"]),
           "x": np.array([1., 2., 3., 4., 5.], np.float32)}
    return ref_table.from_columns("t", raw), table_lib.from_columns("t", raw)


TABLE_OPS = [
    ("append_new_value", lambda t, m: t.append(
        {"key": np.array(["zz", "a", "longer-value"]),
         "x": np.array([6., 7., 8.], np.float32)})),
    ("delete", lambda t, m: t.delete(m.Predicate.where(
        m.Atom("key", m.CmpOp.EQ, "a")))),
    ("delete_unseen_value", lambda t, m: t.delete(m.Predicate.where(
        m.Atom("key", m.CmpOp.EQ, "nope")))),
    ("delete_ne_unseen", lambda t, m: t.delete(m.Predicate.where(
        m.Atom("key", m.CmpOp.NE, "nope"), m.Atom("x", m.CmpOp.GE, 3.0)))),
    ("update_category", lambda t, m: t.update(m.Predicate.where(
        m.Atom("key", m.CmpOp.EQ, "b")), {"key": "q"})),
    ("update_measure", lambda t, m: t.update(m.Predicate.where(
        m.Atom("x", m.CmpOp.LT, 3.0)), {"x": np.array([9., 10.])})),
    ("compact_after_delete", lambda t, m: (t.delete(m.Predicate.where(
        m.Atom("key", m.CmpOp.EQ, "c"))), t.compact())[1]),
    ("compact_clean", lambda t, m: t.compact()),
]


def _record_state(rec):
    if rec is None:
        return None
    out = {k: v for k, v in vars(rec).items() if k != "delta"}
    if getattr(rec, "delta", None) is not None:
        out["delta"] = vars(rec.delta)
    return out


@pytest.mark.parametrize("name", [n for n, _ in TABLE_OPS])
def test_table_mutations_equal_the_reference(name):
    op = dict(TABLE_OPS)[name]
    ref_t, port_t = _tables()
    port_t.to("cpu")
    for t, m in ((ref_t, R), (port_t, P)):
        t._rec = op(t, m)
    _assert_equal_tree(_record_state(ref_t._rec), _record_state(port_t._rec))
    assert [(c.name, c.kind.value, c.cardinality)
            for c in port_t.schema.columns] == \
        [(c.name, c.kind.value, c.cardinality) for c in ref_t.schema.columns]
    assert (port_t.n_rows, port_t.n_live) == (ref_t.n_rows, ref_t.n_live)
    _assert_equal_tree(ref_t.live, port_t.live)
    for c in ("key", "x"):
        np.testing.assert_array_equal(port_t.host_column(c),
                                      ref_t.host_column(c))
        # the device copy follows the host mirror on its next access
        np.testing.assert_array_equal(port_t.columns[c].numpy(),
                                      port_t.host_column(c))
    np.testing.assert_array_equal(port_t.dictionaries["key"],
                                  ref_t.dictionaries["key"])
    np.testing.assert_array_equal(port_t.live_mask_device().numpy(),
                                  np.asarray(ref_t.live_mask_device()))


def test_update_is_atomic_like_the_reference():
    for t, m in zip(_tables(), (R, P)):
        with pytest.raises(KeyError, match="unknown columns"):
            t.update(m.Predicate.where(m.Atom("key", m.CmpOp.EQ, "a")),
                     {"nope": 1})
        with pytest.raises(ValueError):
            t.update(m.Predicate.where(m.Atom("key", m.CmpOp.EQ, "a")),
                     {"x": np.array(["oops", "too"])})
        assert t.n_rows == 5 and t.live is None
        assert len(t.dictionaries["key"]) == 3


def test_stale_columns_upload_on_access_only():
    _, t = _tables()
    t.to("cpu")
    t.append({"key": np.array(["a"]), "x": np.array([1.], np.float32)})
    assert t._stale_device == {"key", "x"}
    assert t.columns["x"].shape == (6,)
    assert t._stale_device == {"key"}


def test_map_codes_stable_and_extend_frequencies_equal_the_reference():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 5, (7, 2)).astype(np.int32)
    keys = np.unique(keys, axis=0)
    mat = rng.integers(0, 7, (400, 2)).astype(np.int32)
    got = table_lib.map_codes_stable(mat, keys)
    want = ref_table.map_codes_stable(mat, keys)
    _assert_equal_tree(list(want), list(got))
    old = rng.integers(0, 9, len(keys)).astype(np.int64)
    _assert_equal_tree(
        ref_table.extend_frequencies(old, want[0], len(want[1])),
        table_lib.extend_frequencies(old, got[0], len(got[1])))
    codes, new = table_lib.get_or_assign_codes(["a", "b", "a"], {"b": 0})
    np.testing.assert_array_equal(codes, [1, 0, 1])
    assert new == ["a"]


# -- the sampling layer ---------------------------------------------------------

@pytest.fixture(scope="module")
def sampled():
    """Both packages' families of one tombstoned, appended table, built
    from the same units (cumulative inclusion: the mutation oracle)."""
    n = 6000
    raw = _raw(n, 3)
    tabs = (ref_table.from_columns("s", raw), table_lib.from_columns("s", raw))
    for t, m in zip(tabs, (R, P)):
        t.delete(m.Predicate.where(m.Atom("OS", m.CmpOp.EQ, "os1")))
    u = ref_samp.base_units(n, 4)
    fams = {phi: (ref_samp.build_family(tabs[0], phi, 150.0, m=3, units=u,
                                        cumulative_inclusion=True),
                  samp.build_family(tabs[1], phi, 150.0, m=3, units=u,
                                    cumulative_inclusion=True))
            for phi in (("City",), ("City", "OS"))}
    fams[()] = (ref_samp.build_uniform_family(tabs[0], 0.2, m=3, units=u,
                                              cumulative_inclusion=True),
                samp.build_uniform_family(tabs[1], 0.2, m=3, units=u,
                                          cumulative_inclusion=True))
    return tabs, fams


def _fam_pair_equal(a, b, label):
    _assert_equal_tree(_family_state(a), _family_state(b), label)


def test_builders_on_a_tombstoned_table_equal_the_reference(sampled):
    _, fams = sampled
    for phi, (a, b) in fams.items():
        _fam_pair_equal(a, b, phi)


def test_merge_family_equals_the_reference(sampled):
    tabs, fams = sampled
    raw = _delta(900, 8, n_new=30)
    d_ref, d_port = tabs[0].append(raw), tabs[1].append(raw)
    _assert_equal_tree(_record_state(d_ref), _record_state(d_port))
    units = samp.delta_units(900, 4, 1)
    np.testing.assert_array_equal(units, ref_samp.delta_units(900, 4, 1))
    for phi, (a, b) in fams.items():
        kw = dict(new_k1=a.ks[0] * 1.1) if phi == () else {}
        ma, ba = ref_samp.merge_family(a, d_ref.columns, units,
                                       start_row=d_ref.start_row, **kw)
        mb, bb = samp.merge_family(b, d_port.columns, units,
                                   start_row=d_port.start_row, **kw)
        _fam_pair_equal(ma, mb, phi)
        _assert_equal_tree(
            {k: v for k, v in vars(ba).items()},
            {k: v for k, v in vars(bb).items()}, f"block {phi}")
        fams[phi] = (ma, mb)


def test_apply_tombstones_remap_and_decay_equal_the_reference(sampled):
    tabs, fams = sampled
    muts = [t.delete(m.Predicate.where(m.Atom("dt", m.CmpOp.LT, 9)))
            for t, m in zip(tabs, (R, P))]
    comps = [None, None]
    for phi, (a, b) in fams.items():
        ta, ba = ref_samp.apply_tombstones(a, muts[0].tombstoned,
                                           muts[0].tombstoned_columns)
        tb, bb = samp.apply_tombstones(b, muts[1].tombstoned,
                                       muts[1].tombstoned_columns)
        _fam_pair_equal(ta, tb, phi)
        assert ba.n_sampled == bb.n_sampled > 0
        np.testing.assert_array_equal(ba.row_ids, bb.row_ids)
        fams[phi] = (ta, tb)
    comps = [t.compact() for t in tabs]
    np.testing.assert_array_equal(comps[0].remap, comps[1].remap)
    for phi, (a, b) in fams.items():
        ra = ref_samp.remap_family_row_ids(a, comps[0].remap)
        rb = samp.remap_family_row_ids(b, comps[1].remap)
        _fam_pair_equal(ra, rb, phi)
        if not phi:
            continue
        strata = maintenance.strata_to_decay(rb, 1.1)
        np.testing.assert_array_equal(
            strata, ref_maint.strata_to_decay(ra, 1.1))
        assert strata.size
        units = samp.decay_units(tabs[1].n_rows, 4, 1)
        np.testing.assert_array_equal(
            units, ref_samp.decay_units(tabs[0].n_rows, 4, 1))
        da, dba = ref_samp.decay_strata(ra, tabs[0], strata, units)
        db_, dbb = samp.decay_strata(rb, tabs[1], strata, units)
        _fam_pair_equal(da, db_, f"decay {phi}")
        assert (dba.n_dropped, dba.n_admitted) == \
            (dbb.n_dropped, dbb.n_admitted)


# -- the port's incremental-equals-rebuild oracle ---------------------------------

def _clone_table(tbl):
    return table_lib.Table(
        tbl.schema, {c: np.array(tbl.host_column(c))
                     for c in tbl.schema.column_names},
        {k: v.copy() for k, v in tbl.dictionaries.items()}, tbl.n_rows,
        live=None if tbl.live is None else tbl.live.copy())


class MutationMirror:
    """The reference's mirror (tests/test_mutations.py) over the port: it
    records what the from-scratch oracle needs after every step: the
    per-family unit vectors (append segments, overwritten by decay draws;
    the mirror owns writable copies), a shadow HISTORY table of every row
    ever inserted, the composed history → current row-id remap, and the
    dead rows each decayed stratum forgave."""

    def __init__(self, db, table="s"):
        self.db, self.table = db, table
        n0 = db.tables[table].n_rows
        seed = db.config.seed
        self.units = {phi: np.array(ref_samp.base_units(n0, seed))
                      for phi in db.families[table] if phi}
        self.uunits = np.array(ref_samp.base_units(n0, seed, uniform=True))
        self.history = _clone_table(db.tables[table])
        self.h2c = np.arange(n0, dtype=np.int64)
        self.forgiven: dict = {}

    def _draw(self, d, epoch):
        seed = self.db.config.seed
        seg = samp.delta_units(d, seed, epoch)
        self.units = {phi: np.concatenate([u, seg])
                      for phi, u in self.units.items()}
        self.uunits = np.concatenate(
            [self.uunits, samp.delta_units(d, seed, epoch, uniform=True)])

    def _extend_remap(self, start_row, d):
        self.h2c = np.concatenate(
            [self.h2c, start_row + np.arange(d, dtype=np.int64)])

    def append(self, raw):
        rep = self.db.append_rows(self.table, raw)
        self.history.append(raw)
        self._extend_remap(rep.delta.start_row, rep.delta.n_rows)
        self._draw(rep.delta.n_rows, rep.epoch)

    def delete(self, pred):
        self.db.delete_rows(self.table, pred)
        self.history.delete(pred)

    def update(self, pred, assignments):
        rep = self.db.update_rows(self.table, pred, assignments)
        self.history.update(pred, assignments)
        if rep.epoch is not None:
            self._extend_remap(rep.mutation.delta.start_row,
                               rep.mutation.delta.n_rows)
            self._draw(rep.mutation.delta.n_rows, rep.epoch)

    def compact(self):
        for phi in list(self.db.ghost_fractions(self.table)):
            self.db.compact_family(self.table, phi)

    def base_compact(self):
        comp = self.db.compact_table(self.table)
        if comp is not None:
            self.h2c = np.where(self.h2c >= 0,
                                comp.remap[np.maximum(self.h2c, 0)], -1)

    def decay(self, ratio=1.5):
        tbl = self.db.tables[self.table]
        for phi in list(self.db.families[self.table]):
            fam = self.db.families[self.table][phi]
            strata = maintenance.strata_to_decay(fam, ratio)
            if not strata.size:
                continue
            keys = [tuple(int(v) for v in fam.strata_keys[s]) for s in strata]
            block = self.db.decay_family(self.table, phi, strata)
            draw = samp.decay_units(tbl.n_rows, self.db.config.seed,
                                    block.epoch)
            mat = np.stack([self.history.host_column(c).astype(np.int32)
                            for c in phi], axis=1)
            codes, _ = table_lib.map_codes_stable(mat, fam.strata_keys)
            member = np.isin(codes, strata)
            live = (self.history.live if self.history.live is not None
                    else np.ones(self.history.n_rows, dtype=bool))
            alive = np.flatnonzero(member & live)
            self.units[phi][alive] = draw[self.h2c[alive]]
            fg = self.forgiven.setdefault(phi, {})
            for s, key in zip(strata, keys):
                fg[key] = int((member & ~live & (codes == s)).sum())

    def oracle(self, phi):
        hist = self.history
        fam = self.db.families[self.table][phi]
        if phi == ():
            ofam = samp.build_uniform_family(
                hist, 0.0, m=len(fam.ks), units=self.uunits, k1=fam.ks[0],
                cumulative_inclusion=True)
        else:
            codes, key_matrix = table_lib.combined_codes(hist, phi)
            nd = int(codes.max()) + 1 if len(codes) else 0
            incl = table_lib.stratum_frequencies(codes, nd)
            for key, dead in self.forgiven.get(phi, {}).items():
                i = np.flatnonzero(
                    (key_matrix == np.asarray(key, np.int32)).all(axis=1))
                assert i.size == 1, (key, key_matrix)
                incl[i[0]] -= dead
            ofam = samp.build_family(hist, phi, k1=fam.ks[0], m=len(fam.ks),
                                     units=self.units[phi], incl_freqs=incl)
        new_ids = self.h2c[ofam.row_ids]
        assert (new_ids >= 0).all(), "oracle sampled a dropped row"
        return dataclasses.replace(ofam, row_ids=new_ids)

    def check(self):
        for phi, fam in self.db.families[self.table].items():
            _assert_matches_oracle(fam, self.oracle(phi))


def _canon(fam):
    return np.lexsort((fam.row_ids, fam.entry_key_host))


def _assert_matches_oracle(fam, oracle):
    assert fam.n_rows == oracle.n_rows
    assert fam.prefix_sizes == oracle.prefix_sizes
    assert fam.table_rows == oracle.table_rows
    np.testing.assert_array_equal(fam.entry_key_host, oracle.entry_key_host)
    np.testing.assert_array_equal(np.sort(fam.stratum_freqs),
                                  np.sort(oracle.stratum_freqs))
    np.testing.assert_array_equal(np.sort(fam.live_freqs),
                                  np.sort(oracle.live_freqs))
    pa, pb = _canon(fam), _canon(oracle)
    np.testing.assert_array_equal(fam.row_ids[pa], oracle.row_ids[pb])
    np.testing.assert_array_equal(fam.unit_host[pa], oracle.unit_host[pb])
    for c in fam.columns_host:
        np.testing.assert_array_equal(fam.host_column(c)[pa],
                                      oracle.host_column(c)[pb])


def _mirror_db(n0, k1=300.0):
    db = P.BlinkDB(P.EngineConfig(k1=k1, m=3, seed=SEED), device="cpu")
    db.register_table("s", table_lib.from_columns("s", _raw(n0, 7)))
    state.install_families(db, "s", {
        ("City",): ref_samp.base_units(n0, SEED),
        (): ref_samp.base_units(n0, SEED, uniform=True)})
    for phi in db.families["s"]:
        db._striped_for("s", phi)
    return db


def _apply_op(mirror, op):
    tbl = mirror.db.tables[mirror.table]
    kind = op[0]
    if kind == "append":
        mirror.append(_raw(op[1], op[2]))
    elif kind == "delete":
        _, col, idx = op
        vals = tbl.dictionaries[col]
        mirror.delete(P.Predicate.where(
            P.Atom(col, P.CmpOp.EQ, vals[idx % len(vals)])))
    elif kind == "update":
        _, col, idx, assign = op
        vals = tbl.dictionaries[col]
        pred = P.Predicate.where(P.Atom(col, P.CmpOp.EQ,
                                        vals[idx % len(vals)]))
        mirror.update(pred, {"City": f"upd{assign}"} if assign % 2
                      else {"Bitrate": 100.0 + assign})
    elif kind == "compact":
        mirror.compact()
    elif kind == "basecompact":
        mirror.base_compact()
    else:
        mirror.decay(ratio=1.5)


def _random_op(rng):
    kind = rng.choice(["append", "delete", "update", "compact",
                       "basecompact", "decay"],
                      p=[.25, .25, .25, .09, .08, .08])
    if kind == "append":
        return ("append", int(rng.integers(20, 400)),
                int(rng.integers(10 ** 6)))
    if kind == "delete":
        return ("delete", str(rng.choice(["City", "OS", "dt"])),
                int(rng.integers(0, 60)))
    if kind == "update":
        return ("update", str(rng.choice(["City", "OS"])),
                int(rng.integers(0, 60)), int(rng.integers(0, 6)))
    return (kind,)


@pytest.mark.parametrize("case_seed", [0, 1, 2, 3])
def test_seeded_sequences_match_the_rebuild_oracle(case_seed):
    rng = np.random.default_rng(case_seed)
    mirror = MutationMirror(_mirror_db(2000))
    mirror.check()
    for _ in range(int(rng.integers(3, 7))):
        _apply_op(mirror, _random_op(rng))
        mirror.check()


def test_delete_then_decay_without_append_matches_the_oracle():
    """The interleaving at which the reference's mirror writes into a
    read-only view of its units: the port's mirror owns its arrays."""
    mirror = MutationMirror(_mirror_db(2500))
    for op in [("delete", "City", 0), ("delete", "dt", 3), ("decay",),
               ("compact",), ("basecompact",), ("decay",)]:
        _apply_op(mirror, op)
        mirror.check()


def test_fixed_sequence_matches_the_oracle_and_stays_exact():
    mirror = MutationMirror(_mirror_db(3000))
    db, tbl = mirror.db, mirror.db.tables["s"]
    cities = tbl.dictionaries["City"]
    for op in [("delete", "City", 0), ("append", 300, 123),
               ("update", "City", 1, 1), ("delete", "OS", 2), ("compact",),
               ("decay",), ("update", "OS", 0, 2), ("basecompact",),
               ("append", 150, 456), ("delete", "City", 1), ("decay",),
               ("compact",), ("basecompact",)]:
        _apply_op(mirror, op)
        mirror.check()
    fam = db.families["s"][("City",)]
    c1 = int(np.nonzero((fam.strata_keys == tbl.encode_value(
        "City", cities[1])).all(axis=1))[0][0])
    assert fam.live_freqs[c1] == 0 and fam.stratum_freqs[c1] == 0
    # a decayed all-dead stratum has frequency 0 in the block's table
    block = db._striped_for("s", ("City",))
    assert block.freq_table[c1].item() == 0.0
    q = P.Query("s", P.AggOp.COUNT, group_by=("OS",), bound=P.ErrorBound(0.2))
    got = {g.key: g.estimate for g in db.query(q).groups}
    exact = {g.key: g.estimate for g in db.exact_query(P.Query(
        "s", P.AggOp.COUNT, group_by=("OS",))).groups}
    assert set(got) == set(exact)
    for key, est in got.items():
        assert abs(est - exact[key]) / max(exact[key], 1.0) < 0.25


def test_contained_stratum_stays_exact_through_mutations():
    db = _mirror_db(4000, k1=600.0)
    tbl = db.tables["s"]
    cities = tbl.dictionaries["City"]
    counts = np.bincount(tbl.host_column("City"), minlength=len(cities))
    code = int(np.argmin(np.where(counts > 0, counts, 1 << 30)))
    q = P.Query("s", P.AggOp.COUNT, predicate=P.Predicate.where(
        P.Atom("City", P.CmpOp.EQ, cities[code])))
    assert abs(db.query(q).groups[0].estimate - counts[code]) < 1e-3
    db.delete_rows("s", P.Predicate.where(
        P.Atom("City", P.CmpOp.EQ, cities[code]),
        P.Atom("OS", P.CmpOp.EQ, "os0")))
    want = int(((tbl.host_column("City") == code) & tbl.live).sum())
    assert abs(db.query(q).groups[0].estimate - want) < 1e-3
    assert abs(db.exact_query(q).groups[0].estimate - want) < 1e-6
    db.update_rows("s", P.Predicate.where(
        P.Atom("City", P.CmpOp.EQ, cities[code])), {"City": "cityELSE"})
    assert db.query(q).groups == [] and db.exact_query(q).groups == []
    q2 = P.Query("s", P.AggOp.COUNT, predicate=P.Predicate.where(
        P.Atom("City", P.CmpOp.EQ, "cityELSE")))
    assert abs(db.query(q2).groups[0].estimate - want) < 1e-3


def test_noop_update_invalidates_nothing():
    db = _mirror_db(2000)
    q = P.Query("s", P.AggOp.COUNT, group_by=("OS",), bound=P.ErrorBound(0.2))
    db.query(q)
    progs, striped = dict(db._batched_programs), dict(db._striped)
    gens = dict(db._generations)
    rep = db.update_rows("s", P.Predicate.where(
        P.Atom("City", P.CmpOp.EQ, "nope")), {"Bitrate": 1.0})
    assert rep.mutation.n_tombstoned == 0 and rep.epoch is None
    assert db._batched_programs == progs and db._generations == gens
    assert all(db._striped.get(k) is v for k, v in striped.items())


def test_dimension_mutations_refresh_joins():
    from repro_torch.core.joins import Join
    db = P.BlinkDB(P.EngineConfig(k1=500.0, m=2), device="cpu")
    db.register_table("fact", table_lib.from_columns("fact", {
        "UserId": np.array(["u0", "u1", "u2"] * 100),
        "x": np.ones(300, np.float32)}))
    db.register_table("users", table_lib.from_columns("users", {
        "UserId": np.array(["u0", "u1", "u2"]),
        "Country": np.array(["US", "US", "DE"])}))
    db.add_family("fact", ("UserId",))
    db.add_family("fact", ())
    q = P.Query("fact", P.AggOp.COUNT, group_by=("users.Country",),
                joins=(Join("users", "UserId", "UserId"),))
    assert {g.key: g.estimate for g in db.exact_query(q).groups} == \
        {("US",): 200.0, ("DE",): 100.0}
    db.update_rows("users", P.Predicate.where(
        P.Atom("UserId", P.CmpOp.EQ, "u1")), {"Country": "FR"})
    want = {("US",): 100.0, ("DE",): 100.0, ("FR",): 100.0}
    assert {g.key: g.estimate for g in db.exact_query(q).groups} == want
    assert {g.key: g.estimate for g in db.query(q).groups} == want
    db.delete_rows("users", P.Predicate.where(
        P.Atom("UserId", P.CmpOp.EQ, "u2")))
    got = {g.key: g.estimate for g in db.exact_query(q).groups}
    assert got == {("US",): 100.0, ("FR",): 100.0}


# -- the subsampled scans after an in-place append ----------------------------------

def test_subsampled_answer_after_in_place_append_matches_the_reference():
    """The port caches the subsampled scans' group column g·B + sub, made
    from the block's group column VALUES; an append that scatters into the
    block without changing its shape must not leave it stale."""
    ref, port = _engines(n=20_000, families=(("City",), ()),
                         ci_method="subsampling")
    qs = {m: m.Query("s", m.AggOp.AVG, "SessionTime", group_by=("City",),
                     bound=m.ErrorBound(0.2)) for m in (R, P)}
    _assert_same_answer(ref.query(qs[R]), port.query(qs[P]))
    shape = port._striped_for("s", ("City",)).n_local
    reps = [db.append_rows("s", _delta(800, 9, n_new=40))
            for db in (ref, port)]
    assert not reps[1].restriped
    assert port._striped_for("s", ("City",)).n_local == shape
    _assert_same_answer(ref.query(qs[R]), port.query(qs[P]))
    new = {m: m.Query("s", m.AggOp.COUNT, group_by=("City",),
                      predicate=m.Predicate.where(
                          m.Atom("City", m.CmpOp.EQ, NEW_CITY)),
                      bound=m.ErrorBound(0.2)) for m in (R, P)}
    a, b = ref.query(new[R]), port.query(new[P])
    _assert_same_answer(a, b)
    assert [g.key for g in b.groups] == [(NEW_CITY,)]
    assert b.groups[0].estimate == 40.0


# -- re-registration ------------------------------------------------------------------

def test_reregistration_keeps_families_like_the_reference():
    """Registering a new table under a name in use keeps the name's
    families (the reference's _invalidate_table), drops their derived
    state and bumps their generations: the next query answers from the
    kept families, as the reference's does."""
    ref, port = _engines(n=20_000, families=(("City",), ()))
    qs = {m: m.Query("s", m.AggOp.AVG, "SessionTime", group_by=("OS",),
                     bound=m.ErrorBound(0.1)) for m in (R, P)}
    _assert_same_answer(ref.query(qs[R]), port.query(qs[P]))
    ref.register_table("s", ref_table.from_columns("s", _raw(20_000, 6)))
    port.register_table("s", table_lib.from_columns("s", _raw(20_000, 6)))
    assert set(port.families["s"]) == set(ref.families["s"])
    assert port._striped == {} and port._elp_cache == {}
    assert port._generations == ref._generations
    assert port._family_set_gen == ref._family_set_gen
    for phi in ref.families["s"]:
        _fam_pair_equal(ref.families["s"][phi], port.families["s"][phi], phi)
    _assert_same_answer(ref.query(qs[R]), port.query(qs[P]))


def test_invalidation_listeners_hear_every_bump():
    db = _mirror_db(2000)
    heard = []

    def listen(table, phi):
        heard.append((table, phi))
    db.add_invalidation_listener(listen)
    db.delete_rows("s", P.Predicate.where(P.Atom("OS", P.CmpOp.EQ, "os0")))
    db.add_family("s", ("OS",))
    db.remove_invalidation_listener(listen)
    db.remove_invalidation_listener(listen)
    db.compact_table("s")
    assert heard == [("s", ("City",)), ("s", ()), ("s", ("OS",)), ("s", None)]
    assert db.family_set_generation("s") == 3
