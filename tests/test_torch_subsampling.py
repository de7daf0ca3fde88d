"""Port parity: variational-subsampling CIs (ci_method="subsampling").

The reference's contract workload (tests/test_contracts.py: 80k sessions
rows of seed 11, k1=1500, m=4, uniform_fraction=0.3, families OS, City and
uniform) runs through one reference engine and one port engine (on the
CPU), the reference's sample units carried into the port. The reference
runs with use_pallas=True, the QUANTILE semantics of the port's
closed-form pilot scans (tests/test_torch_quantile.py); its subsampled
scans are jnp whatever use_pallas says, and bin a QUANTILE over the
selected rows' range, as the port's do. Both engines are built once for
the module, so the reference's compiled programs serve every case.

Family, K, rows_read, group keys and n_selected must be equal; estimate,
stderr and CI bounds within rtol 1e-4. Within the port, query_batch must
equal query() bit for bit, and the CIs must track the closed forms within
the reference's own bounds.
"""
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import estimators as ref_est
from repro.core import executor as ref_exec
from repro.core import sampling as ref_samp
from repro.core import table as ref_table
from repro.data import synth as ref_synth
import repro_torch.core as P
from repro_torch import state
from repro_torch.core import estimators as est_lib
from repro_torch.core import executor as exec_lib
from repro_torch.core import table as table_lib
from repro_torch.data import synth

N_ROWS, DATA_SEED = 80_000, 11
CFG = dict(k1=1500.0, c=2.0, m=4, uniform_fraction=0.3)
FAMILIES = (("OS",), ("City",), ())


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _units():
    u = ref_samp.base_units(N_ROWS, 0)
    return {**{phi: u for phi in FAMILIES if phi},
            (): ref_samp.base_units(N_ROWS, 0, uniform=True)}


def _port_engine(units, ci_method="subsampling"):
    port = P.BlinkDB(P.EngineConfig(**CFG, ci_method=ci_method),
                     device="cpu")
    port.register_table("sessions", table_lib.from_columns(
        "sessions", synth.sessions_table(N_ROWS, seed=DATA_SEED)))
    state.install_families(port, "sessions", units)
    return port


@pytest.fixture(scope="module")
def engines():
    ref = R.BlinkDB(R.EngineConfig(**CFG, ci_method="subsampling",
                                   use_pallas=True))
    ref.register_table("sessions", ref_table.from_columns(
        "sessions", ref_synth.sessions_table(N_ROWS, seed=DATA_SEED)))
    for phi in FAMILIES:
        ref.add_family("sessions", phi)
    units = _units()
    return ref, _port_engine(units), units


def _query(m, agg, grouped, bound=None):
    """agg over SessionTime (COUNT: none) WHERE Genre=genre03, GROUP BY OS
    when grouped."""
    genre = m.Predicate.where(m.Atom("Genre", m.CmpOp.EQ, "genre03"))
    kw = dict(group_by=("OS",)) if grouped else {}
    if agg == "QUANTILE":
        kw["quantile"] = 0.5
    return m.Query("sessions", getattr(m.AggOp, agg),
                   None if agg == "COUNT" else "SessionTime",
                   predicate=genre, bound=bound or m.ErrorBound(0.1), **kw)


def _not_in_cities(m):
    """COUNT WHERE City NOT IN (130 cities) GROUP BY OS: a template over
    127 atoms, the wide path's agg_scan launch."""
    return m.Query("sessions", m.AggOp.COUNT, group_by=("OS",),
                   predicate=m.Predicate.where(*[
                       m.Atom("City", m.CmpOp.NE, f"city{199 - j:03d}")
                       for j in range(130)]),
                   bound=m.ErrorBound(0.1))


def _assert_same_answer(a, b, rtol=1e-4):
    assert b.sample_phi == a.sample_phi
    assert b.sample_k == a.sample_k
    assert b.rows_read == a.rows_read
    assert (b.bound_met, b.certified) == (a.bound_met, a.certified)
    if a.predicted_half_width is None:
        assert b.predicted_half_width is None
    else:
        np.testing.assert_allclose(b.predicted_half_width,
                                   a.predicted_half_width, rtol=rtol)
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


# -- the pieces ---------------------------------------------------------------

@pytest.mark.parametrize("n_shards,n_local,b", [(1, 6_400, 32), (1, 64, 7),
                                                (4, 1_000, 32)])
def test_subsample_codes_equal_the_reference(n_shards, n_local, b):
    got = exec_lib.subsample_codes(n_shards, n_local, b)
    want = ref_exec.subsample_codes(n_shards, n_local, b)
    assert got.dtype == np.int32 and got.shape == (n_shards, n_local)
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == set(range(b))


def _hand_moments(g, b, seed):
    """Hand-built per-(group, subsample) moments [2, G·B] (a batch of 2),
    a few subsamples empty; (port, reference) views of the same numbers."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, 4, (2, g * b)).astype(np.float32)
    w = (rng.uniform(1.0, 9.0, (2, g * b)) * n).astype(np.float32)
    x = rng.uniform(0.5, 20.0, (2, g * b)).astype(np.float32)
    leaves = [n, w, w * x, w * x * x, w * (w - 1.0),
              w * (w - 1.0) * x, w * (w - 1.0) * x * x]
    leaves = [np.asarray(v, np.float32) for v in leaves]
    port = est_lib.GroupedMoments(*(torch.from_numpy(v) for v in leaves))
    ref = ref_est.GroupedMoments(*leaves)
    qsub = rng.uniform(0.0, 50.0, (2, g * b)).astype(np.float32)
    return port, ref, qsub


@pytest.mark.parametrize("agg", ["COUNT", "SUM", "AVG", "QUANTILE"])
def test_subsampling_estimators_match_the_reference(agg):
    g, b = 3, est_lib.N_SUBSAMPLES
    assert b == ref_est.N_SUBSAMPLES
    port, ref, qsub = _hand_moments(g, b, seed=len(agg))
    p_agg, r_agg = getattr(P.AggOp, agg), getattr(R.AggOp, agg)

    def close(got, want):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-30)

    fp, fr = (est_lib.fold_subsamples(port, g, b),
              ref_est.fold_subsamples(ref, g, b))
    for f in ("n", "wsum", "wxsum", "wx2sum", "var_count", "var_sum",
              "var_sum2"):
        close(getattr(fp, f), getattr(fr, f))
    qkw = ({"quantile_values": torch.from_numpy(qsub)}, {"quantile_values":
           qsub}) if agg == "QUANTILE" else ({}, {})
    tp, vp = est_lib.subsample_replicates(p_agg, port, g, b, **qkw[0])
    tr, vr = ref_est.subsample_replicates(r_agg, ref, g, b, **qkw[1])
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vr))
    assert not vp.all() and vp.any()
    close(torch.where(vp, tp, 0.0), np.where(np.asarray(vr), tr, 0.0))
    close(est_lib.subsampling_variance(tp, vp),
          ref_est.subsampling_variance(tr, vr))
    dens = np.full((2, g), 0.25, np.float32)
    qv = np.full((2, g), 7.0, np.float32)
    ekw = ({"quantile_value": torch.from_numpy(qv),
            "quantile_density": torch.from_numpy(dens),
            "quantile_values_sub": torch.from_numpy(qsub)},
           {"quantile_value": qv, "quantile_density": dens,
            "quantile_values_sub": qsub}) if agg == "QUANTILE" else ({}, {})
    ep = est_lib.subsampling_estimate(p_agg, port, g, b, q=0.5, **ekw[0])
    er = ref_est.subsampling_estimate(r_agg, ref, g, b, q=0.5, **ekw[1])
    for f in ("value", "variance", "n"):
        close(getattr(ep, f), getattr(er, f))


def test_subsample_group_column_is_g_times_b_plus_sub():
    sub = torch.from_numpy(exec_lib.subsample_codes(1, 640, 32)[0])
    codes = torch.arange(640, dtype=torch.int8) % 6 - 1   # -1 dangles
    gsub = exec_lib.subsample_group_column(codes, sub, 32)
    assert gsub.dtype == torch.int32
    np.testing.assert_array_equal(gsub.numpy(),
                                  codes.numpy().astype(np.int32) * 32
                                  + sub.numpy())
    assert (gsub[codes < 0] < 0).all()


# -- the engine against the reference -----------------------------------------

@pytest.mark.parametrize("agg", ["COUNT", "SUM", "AVG", "QUANTILE"])
@pytest.mark.parametrize("grouped", [False, True], ids=["all", "by_os"])
def test_subsampled_query_matches_the_reference(engines, agg, grouped):
    ref, port, _ = engines
    a = ref.query(_query(R, agg, grouped))
    b = port.query(_query(P, agg, grouped))
    assert a.groups and all(g.stderr > 0 for g in a.groups if not g.exact)
    _assert_same_answer(a, b)


def test_subsampled_wide_template_matches_the_reference(engines):
    ref, port, _ = engines
    _assert_same_answer(ref.query(_not_in_cities(R)),
                        port.query(_not_in_cities(P)))


def test_subsampled_time_bound_matches_the_reference_scan(engines):
    """WITHIN SECONDS picks K from host-clocked probes (engine-specific);
    at the same K and family the subsampled answers agree."""
    ref, port, _ = engines
    qr = _query(R, "AVG", True, bound=R.TimeBound(10.0))
    qp = _query(P, "AVG", True, bound=P.TimeBound(10.0))
    b = port.query(qp)
    a = ref._subsampled_answer(qr, "sessions", b.sample_phi, b.sample_k,
                               0.95)
    _assert_same_answer(a, b)


# -- within the port -----------------------------------------------------------

def _fresh(port):
    """A port engine over `port`'s table and families with no cached
    decisions and no cached subsampled columns."""
    db = P.BlinkDB(port.config, device="cpu")
    db.register_table("sessions", port.tables["sessions"])
    db.families["sessions"] = dict(port.families["sessions"])
    db._generations.update(port._generations)
    db._striped.update(port._striped)
    return db


def test_batch_parity_under_subsampling(engines):
    """query_batch under subsampling folds the same moments as query():
    within the port every answer is bit for bit equal (a scan group with a
    QUANTILE keeps the closed form, in query_batch as in the reference)."""
    _, port, _ = engines
    qs = [P.Query("sessions", P.AggOp.AVG, "SessionTime", group_by=("OS",),
                  bound=P.ErrorBound(0.05, 0.95)),
          P.Query("sessions", P.AggOp.COUNT, group_by=("OS",),
                  bound=P.ErrorBound(0.15, 0.95)),
          _query(P, "SUM", False), _query(P, "COUNT", True),
          _not_in_cities(P)]
    qs += [P.Query("sessions", P.AggOp.SUM, "Bitrate",
                   predicate=P.Predicate.where(
                       P.Atom("City", P.CmpOp.EQ, f"city{i:03d}")),
                   bound=P.ErrorBound(0.2)) for i in range(4)]
    db = _fresh(port)
    batched = db.query_batch(qs)
    single = [db.query(q) for q in qs]
    for q, a, b in zip(qs, batched, single):
        assert a.groups, q
        assert answer_bits(a) == answer_bits(b), q


def test_batch_keeps_closed_form_for_quantile_groups(engines):
    """A batched scan group holding a QUANTILE keeps the closed-form CIs,
    as the reference's query_batch does."""
    _, port, units = engines
    q = _query(P, "QUANTILE", True)
    (sub,) = _fresh(port).query_batch([q])
    closed = _port_engine(units, "closed")
    (want,) = closed.query_batch([q])
    assert answer_bits(sub) == answer_bits(want)


def _both_ci_methods(db, q):
    """q under closed-form and subsampling CIs on one engine."""
    old = db.config.ci_method
    try:
        db.config.ci_method = "closed"
        closed = db.query(q)
        db.config.ci_method = "subsampling"
        sub = db.query(q)
    finally:
        db.config.ci_method = old
    return closed, sub


@pytest.mark.parametrize("agg,vcol", [("COUNT", None),
                                      ("SUM", "SessionTime"),
                                      ("AVG", "SessionTime")])
def test_subsampling_ci_agrees_with_closed_form(engines, agg, vcol):
    """tests/test_contracts.py's check on the port: the folded point
    estimates equal the closed form's within rtol 1e-4, and the replicate
    stderr lies within [0.45, 2.2] of the Table-2 one."""
    _, port, _ = engines
    q = P.Query("sessions", getattr(P.AggOp, agg), value_column=vcol,
                group_by=("OS",), bound=P.ErrorBound(0.2, 0.95))
    closed, sub = _both_ci_methods(port, q)
    c_by = {g.key: g for g in closed.groups}
    assert set(c_by) == {g.key for g in sub.groups}
    for g in sub.groups:
        c = c_by[g.key]
        assert g.estimate == pytest.approx(c.estimate, rel=1e-4)
        if c.exact or g.exact:
            continue
        assert c.stderr > 0 and g.stderr > 0
        assert 0.45 <= g.stderr / c.stderr <= 2.2, (g.key, g.stderr / c.stderr)


def test_subsampling_quantile_validates_closed_form_n_eff(engines):
    """tests/test_contracts.py's QUANTILE check on the port: the closed
    form (Kish n_eff) and the replicate quantiles land within [0.3, 3.0]
    of each other; the estimates within 2%."""
    _, port, _ = engines
    q = P.Query("sessions", P.AggOp.QUANTILE, value_column="SessionTime",
                predicate=P.Predicate.where(P.Atom("OS", P.CmpOp.EQ, "os0")),
                bound=P.ErrorBound(0.2, 0.95))
    closed, sub = _both_ci_methods(port, q)
    (gc,), (gs,) = closed.groups, sub.groups
    assert gs.estimate == pytest.approx(gc.estimate, rel=0.02)
    assert gc.stderr > 0 and gs.stderr > 0
    assert 0.3 <= gs.stderr / gc.stderr <= 3.0, gs.stderr / gc.stderr


def test_ci_method_is_checked():
    P.BlinkDB(P.EngineConfig(ci_method="subsampling"), device="cpu")
    with pytest.raises(ValueError, match="ci_method"):
        P.BlinkDB(P.EngineConfig(ci_method="bootstrap"), device="cpu")
