"""Port parity: joins of the sampled fact table to in-memory dimension
tables (paper §2.1), and group codes outside [0, G).

tests/test_joins.py's workload (80k sessions rows of seed 11, a "media"
dimension of one row per URL with an owner of 12 values and a paid flag;
k1=1500, m=4, seed=1, families URL and uniform) runs through one reference
engine and one port engine (on the CPU), the reference's sample units
carried into the port. A second dimension, "partial", leaves 5% of the
URLs out, so their keys dangle: they gather the code -1, which lands in no
group of a GROUP BY. Family, K, rows_read, group keys and n_selected must
be equal; estimates, stderr and CI bounds within rtol 1e-4.
"""
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import estimators as ref_est
from repro.core import executor as ref_exec
from repro.core import joins as ref_joins
from repro.core import sampling as ref_samp
from repro.core import table as ref_table
from repro.data import synth as ref_synth
import repro_torch.core as P
from repro_torch import state
from repro_torch.core import estimators as est_lib
from repro_torch.core import executor as exec_lib
from repro_torch.core import joins
from repro_torch.core import table as table_lib
from repro_torch.data import synth

N_ROWS, DATA_SEED, SEED = 80_000, 11, 1
CFG = dict(k1=1500.0, m=4, seed=SEED)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _dims(fact_raw):
    """(media, partial) raw dimension tables: one row per URL, owner of 12
    values and a paid flag (tests/test_joins.py), and the same with every
    20th URL left out."""
    rng = np.random.default_rng(0)
    urls = np.unique(fact_raw["URL"])
    owners = np.array([f"own{rng.integers(0, 12)}" for _ in urls])
    media = {"url": urls, "owner": owners,
             "paid": rng.integers(0, 2, len(urls)).astype(np.int32),
             "weight": rng.uniform(0.5, 2.0, len(urls))}
    keep = np.arange(len(urls)) % 20 != 7
    partial = {c: v[keep] for c, v in media.items()}
    return media, partial


def _engines():
    ref = R.BlinkDB(R.EngineConfig(**CFG))
    raw = ref_synth.sessions_table(N_ROWS, seed=DATA_SEED)
    ref.register_table("sessions", ref_table.from_columns("sessions", raw))
    for name, d in zip(("media", "partial"), _dims(raw)):
        ref.register_table(name, ref_table.from_columns(name, d))
    for phi in (("URL",), ()):
        ref.add_family("sessions", phi)
    port = P.BlinkDB(P.EngineConfig(**CFG), device="cpu")
    raw = synth.sessions_table(N_ROWS, seed=DATA_SEED)
    port.register_table("sessions", table_lib.from_columns("sessions", raw))
    for name, d in zip(("media", "partial"), _dims(raw)):
        port.register_table(name, table_lib.from_columns(name, d))
    state.install_families(port, "sessions", {
        ("URL",): ref_samp.base_units(N_ROWS, SEED),
        (): ref_samp.base_units(N_ROWS, SEED, uniform=True)})
    return ref, port


@pytest.fixture(scope="module")
def engines():
    return _engines()


def _join(m, dim="media"):
    join_cls = ref_joins.Join if m is R else joins.Join
    return (join_cls(dim, "URL", "url"),)


def _q(m, name, dim="media"):
    """tests/test_joins.py's queries in either package's types."""
    j = _join(m, dim)
    return {
        "count_owner": m.Query(
            "sessions", m.AggOp.COUNT, bound=m.ErrorBound(0.10, 0.95),
            predicate=m.Predicate.where(m.Atom(f"{dim}.owner", m.CmpOp.EQ,
                                               "own3")), joins=j),
        "avg_by_owner": m.Query(
            "sessions", m.AggOp.AVG, "SessionTime",
            group_by=(f"{dim}.owner",), bound=m.ErrorBound(0.1, 0.95),
            joins=j),
        "count_paid": m.Query(
            "sessions", m.AggOp.COUNT, bound=m.ErrorBound(0.1, 0.95),
            predicate=m.Predicate.where(m.Atom(f"{dim}.paid", m.CmpOp.EQ, 1)),
            joins=j),
        "sum_weight_by_os": m.Query(
            "sessions", m.AggOp.SUM, f"{dim}.weight", group_by=("OS",),
            bound=m.ErrorBound(0.1, 0.95), joins=j),
    }[name]


def _assert_same_answer(a, b, rtol=1e-4):
    assert b.sample_phi == a.sample_phi
    assert b.sample_k == a.sample_k
    assert b.rows_read == a.rows_read
    assert (b.bound_met, b.certified) == (a.bound_met, a.certified)
    assert [g.key for g in b.groups] == [g.key for g in a.groups]
    for ga, gb in zip(a.groups, b.groups):
        assert gb.exact == ga.exact and gb.n_selected == ga.n_selected
        for f in ("estimate", "stderr", "ci_low", "ci_high"):
            np.testing.assert_allclose(getattr(gb, f), getattr(ga, f),
                                       rtol=rtol, atol=1e-9, err_msg=f)


def answer_bits(ans) -> tuple:
    return (ans.sample_phi, ans.sample_k, ans.rows_read, ans.bound_met,
            ans.certified, ans.predicted_half_width,
            [(g.key, g.estimate, g.stderr, g.ci_low, g.ci_high, g.n_selected,
              g.exact) for g in ans.groups])


# -- codes outside [0, G) --------------------------------------------------------

def _codes_case(seed=3, n=4_000, g=5):
    rng = np.random.default_rng(seed)
    values = rng.uniform(0.0, 100.0, n).astype(np.float32)
    rates = rng.uniform(0.05, 1.0, n).astype(np.float32)
    mask = rng.random(n) < 0.7
    codes = rng.integers(-1, g + 1, n).astype(np.int32)   # -1 and G among them
    assert (codes == -1).any() and (codes == g).any()
    return values, rates, mask, codes, g


@pytest.mark.parametrize("accumulate", [torch.float32, torch.float64])
def test_grouped_moments_drop_codes_outside_the_groups(accumulate):
    values, rates, mask, codes, g = _codes_case()
    got = est_lib.grouped_moments(
        torch.from_numpy(values), torch.from_numpy(rates),
        torch.from_numpy(mask), torch.from_numpy(codes), g,
        accumulate=accumulate)
    want = ref_est.grouped_moments(values, rates, mask, codes, g)
    for f in ("n", "wsum", "wxsum", "wx2sum", "var_count", "var_sum",
              "var_sum2"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=2e-5, atol=1e-3, err_msg=f)


def test_grouped_quantile_drops_codes_outside_the_groups():
    values, _, mask, codes, g = _codes_case(seed=4)
    weights = mask.astype(np.float32) * 1.5
    qv, dens = exec_lib.grouped_quantile(
        torch.from_numpy(values), torch.from_numpy(weights),
        torch.from_numpy(codes), g, 0.5)
    want_qv, want_dens = ref_exec.grouped_quantile(values, weights, codes,
                                                   g, 0.5)
    np.testing.assert_allclose(qv.numpy(), np.asarray(want_qv), rtol=1e-5)
    np.testing.assert_allclose(dens.numpy(), np.asarray(want_dens),
                               rtol=1e-5)


# -- the join pieces --------------------------------------------------------------

@pytest.mark.parametrize("dim", ["media", "partial"])
def test_fk_map_equals_the_reference(engines, dim):
    ref, port = engines
    want = ref_joins.build_fk_map(ref.tables["sessions"], ref.tables[dim],
                                  _join(R, dim)[0])
    got = joins.build_fk_map(port.tables["sessions"], port.tables[dim],
                             _join(P, dim)[0])
    np.testing.assert_array_equal(got, want)
    assert ((got >= 0).all() if dim == "media"
            else 0 < (got < 0).sum() < 0.1 * len(got))
    # decoded fact URL == decoded dim url at the mapped row
    fact, d = port.tables["sessions"], port.tables[dim]
    for code in np.nonzero(got >= 0)[0][[0, 5, -1]]:
        row = got[code]
        assert d.dictionaries["url"][d.host_column("url")[row]] == \
            fact.dictionaries["URL"][code]


@pytest.mark.parametrize("col", ["owner", "paid", "weight"])
def test_gather_dim_column_equals_the_reference(engines, col):
    """Dangling keys gather -1 (int32 codes) or 0.0 (floats), from a numpy
    array or a tensor alike."""
    ref, port = engines
    fk_r = ref_joins.build_fk_map(ref.tables["sessions"],
                                  ref.tables["partial"], _join(R, "partial")[0])
    want = np.asarray(ref_joins.gather_dim_column(
        fk_r, ref.tables["partial"], col, ref.tables["sessions"].columns["URL"]))
    fk = joins.build_fk_map(port.tables["sessions"], port.tables["partial"],
                            _join(P, "partial")[0])
    codes = port.tables["sessions"].host_column("URL")
    got = joins.gather_dim_column(fk, port.tables["partial"], col, codes)
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    got_t = joins.gather_dim_column(fk, port.tables["partial"], col,
                                    torch.from_numpy(codes))
    np.testing.assert_array_equal(got_t.numpy(), want)
    sentinel = 0.0 if col == "weight" else -1
    assert (want[fk[codes] < 0] == sentinel).all()


# -- the engine against the reference --------------------------------------------

@pytest.mark.parametrize("dim", ["media", "partial"])
@pytest.mark.parametrize("name", ["count_owner", "avg_by_owner",
                                  "count_paid", "sum_weight_by_os"])
def test_joined_query_matches_the_reference(engines, name, dim):
    ref, port = engines
    a = ref.query(_q(R, name, dim))
    b = port.query(_q(P, name, dim))
    _assert_same_answer(a, b)
    if name != "sum_weight_by_os":
        # the join-key-stratified family serves it (§2.1 case i)
        assert b.sample_phi == ("URL",)
        assert b.rows_read < port.tables["sessions"].n_rows


@pytest.mark.parametrize("dim", ["media", "partial"])
@pytest.mark.parametrize("name", ["count_owner", "avg_by_owner",
                                  "sum_weight_by_os"])
def test_joined_exact_query_matches_the_reference(engines, name, dim):
    """exact_query over a joined column; with dangling keys a GROUP BY on
    the dimension drops their rows (code -1), as the reference does. The
    port's exact scan sums in float64 and the reference's in float32
    (ROADMAP §3): over ~13k float weights a group the reference's SUM
    drifts by up to 1.2e-4 of the total, so that case is held at rtol 5e-4
    against the reference and at rtol 1e-6 against a float64 sum."""
    ref, port = engines
    a = ref.exact_query(_q(R, name, dim))
    b = port.exact_query(_q(P, name, dim))
    assert [g.key for g in b.groups] == [g.key for g in a.groups]
    rtol = 5e-4 if name == "sum_weight_by_os" else 1e-4
    for ga, gb in zip(a.groups, b.groups):
        assert gb.n_selected == ga.n_selected
        np.testing.assert_allclose(gb.estimate, ga.estimate, rtol=rtol)
    if name == "sum_weight_by_os":
        tbl = port.tables["sessions"]
        w = tbl.columns_host[f"{dim}.weight"].astype(np.float64)
        os_ = tbl.host_column("OS")
        for gb in b.groups:
            code = tbl.encode_value("OS", gb.key[0])
            np.testing.assert_allclose(gb.estimate, w[os_ == code].sum(),
                                       rtol=1e-6)
    if name == "avg_by_owner":
        total = sum(g.n_selected for g in b.groups)
        assert (total == N_ROWS) == (dim == "media")


def test_joined_answers_track_exact(engines):
    """tests/test_joins.py's accuracy checks on the port."""
    _, port = engines
    q = _q(P, "count_owner")
    truth = port.exact_query(q).groups[0].estimate
    assert truth > 0
    assert abs(port.query(q).groups[0].estimate - truth) / truth < 0.15
    q = _q(P, "avg_by_owner")
    ex = {g.key: g.estimate for g in port.exact_query(q).groups}
    ans = port.query(q)
    assert len(ans.groups) == len(ex)
    assert np.median([abs(g.estimate - ex[g.key]) / ex[g.key]
                      for g in ans.groups]) < 0.1
    q = _q(P, "count_paid")
    truth = port.exact_query(q).groups[0].estimate
    assert abs(port.query(q).groups[0].estimate - truth) / truth < 0.12


def test_joined_query_batch_equals_query(engines):
    """query_batch of joined queries on a fresh engine over the same
    table, dimensions and families: bit for bit query()'s answers."""
    _, port = engines
    db = P.BlinkDB(port.config, device="cpu")
    for name in ("sessions", "media", "partial"):
        db.register_table(name, port.tables[name])
    db.families["sessions"] = dict(port.families["sessions"])
    qs = [_q(P, n, d) for d in ("media", "partial")
          for n in ("count_owner", "avg_by_owner", "count_paid")]
    qs.append(P.Query("sessions", P.AggOp.COUNT, joins=_join(P),
                      predicate=P.Predicate.where(
                          P.Atom("media.owner", P.CmpOp.EQ, "own5")),
                      bound=P.ErrorBound(0.10, 0.95)))
    batched = db.query_batch(qs)
    single = [db.query(q) for q in qs]
    for q, a, b in zip(qs, batched, single):
        assert a.groups, q
        assert answer_bits(a) == answer_bits(b), q


def test_subsampled_joined_query_groups_skip_dangling_keys(engines):
    """Under subsampling CIs a dangling key's code -1 becomes -B + sub and
    lands in no segment: the folded counts equal the closed form's."""
    _, port = engines
    db = P.BlinkDB(P.EngineConfig(**CFG, ci_method="subsampling"),
                   device="cpu")
    for name in ("sessions", "media", "partial"):
        db.register_table(name, port.tables[name])
    db.families["sessions"] = dict(port.families["sessions"])
    q = _q(P, "avg_by_owner", "partial")
    sub, closed = db.query(q), port.query(q)
    assert [g.key for g in sub.groups] == [g.key for g in closed.groups]
    for gs, gc in zip(sub.groups, closed.groups):
        assert gs.n_selected == gc.n_selected
        np.testing.assert_allclose(gs.estimate, gc.estimate, rtol=1e-4)


def test_register_table_of_a_changed_dimension_regathers():
    """Re-registering a dimension strips the columns gathered from the old
    one (table and families) and bumps the generation of every family
    that held one; the next joined query regathers from the new table."""
    raw = synth.sessions_table(20_000, seed=3)
    db = P.BlinkDB(P.EngineConfig(k1=400.0, m=3), device="cpu")
    db.register_table("sessions", table_lib.from_columns("sessions", raw))
    media, _ = _dims(raw)
    db.register_table("media", table_lib.from_columns("media", media))
    db.add_family("sessions", ("URL",))
    q = P.Query("sessions", P.AggOp.COUNT, group_by=("media.owner",),
                joins=_join(P))

    def truth(owners):
        by_url = dict(zip(media["url"], owners))
        own = np.array([by_url[u] for u in raw["URL"]])
        keys, counts = np.unique(own, return_counts=True)
        return {(k,): float(c) for k, c in zip(keys, counts)}

    def got():
        return {g.key: g.estimate for g in db.exact_query(q).groups}

    assert got() == truth(media["owner"])
    db.query(q)
    fam = db.families["sessions"][("URL",)]
    assert "media.owner" in fam.columns_host
    gen = db.family_generation("sessions", ("URL",))
    changed = dict(media, owner=np.array([f"new{i % 3}"
                                          for i in range(len(media["url"]))]))
    db.register_table("media", table_lib.from_columns("media", changed))
    assert "media.owner" not in db.tables["sessions"].columns_host
    assert "media.owner" not in db.tables["sessions"].columns
    assert "media.owner" not in fam.columns_host
    assert db.family_generation("sessions", ("URL",)) == gen + 1
    assert got() == truth(changed["owner"])
    ans = db.query(q)
    assert {g.key for g in ans.groups} == {("new0",), ("new1",), ("new2",)}
