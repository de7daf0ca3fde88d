"""Port parity: offline sample creation (§3.2 optimizer and
BlinkDB.build_samples), the storage helpers, and queries on a family of
more than 4096 strata.

Both packages compute the optimizer's statistics in numpy, so the chosen
families, the Solution and every Candidate must be equal, not close. The
reference draws its per-row priorities from jax.random; they are carried
into the port through `build_samples(units=...)` (one array for every
stratified family, as the reference uses one seed for all of them), so
each family must equal the reference's row for row. The workloads are
benchmarks/common.py's Conviva and TPC-H-lite templates at the smoke's
ratio of rows to K1 (400k rows at K1 = 2000 there: 120k and 100k rows at
K1 = 600 here).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import sampling as ref_samp
from repro.core import table as ref_table
from repro.data import synth as ref_synth
import repro_torch.core as P
from repro_torch import state
from repro_torch.core import executor as exec_lib
from repro_torch.core import optimizer as opt_lib
from repro_torch.core import sampling as samp_lib
from repro_torch.core import table as table_lib
from repro_torch.data import synth
from repro_torch.kernels import ref as kref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmarks import common  # noqa: E402  (the workloads' templates)

K1, M, SEED = 600.0, 5, 7
WORKLOADS = {
    "sessions": (120_000, lambda m, n: m.sessions_table(n, seed=5),
                 common.conviva_templates),
    "lineitem": (100_000, lambda m, n: m.lineitem_table(n),
                 common.tpch_templates),
}
# A second workload for each table: build_samples again drops and adds.
SECOND = {
    "sessions": [({"OS", "Genre"}, 0.5), ({"City"}, 0.5)],
    "lineitem": [({"l_shipmode", "l_suppkey"}, 0.6), ({"l_returnflag"}, 0.4)],
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def port_templates(templates):
    return [P.QueryTemplate(t.columns, t.weight) for t in templates]


def ref_units(n, templates):
    """The reference's units for every φ build_samples may build: one
    array for all stratified families, the salted one for the uniform."""
    u = ref_samp.base_units(n, SEED)
    phis = {tuple(sorted(c.phi)) for c in opt_lib.enumerate_candidates(
        port_templates(templates), lambda phi: (0.0, 0.0, 0.0), 3)}
    return {**{phi: u for phi in phis},
            (): ref_samp.base_units(n, SEED, uniform=True)}


def engines(name, use_pallas=False):
    n, make, _ = WORKLOADS[name]
    ref = R.BlinkDB(R.EngineConfig(k1=K1, m=M, seed=SEED,
                                   use_pallas=use_pallas))
    ref.register_table(name, ref_table.from_columns(name, make(ref_synth, n)))
    port = P.BlinkDB(P.EngineConfig(k1=K1, m=M, seed=SEED), device="cpu")
    port.register_table(name, table_lib.from_columns(name, make(synth, n)))
    return ref, port


def solution_values(sol):
    return ([(c.phi, c.storage, c.n_distinct, c.delta) for c in sol.chosen],
            sol.objective, sol.storage_used, sol.coverage)


def assert_same_families(ref, port, name):
    assert sorted(port.families[name]) == sorted(ref.families[name])
    rb, pb = ref.tables[name].row_bytes(), port.tables[name].row_bytes()
    assert pb == rb
    for phi, want in ref.families[name].items():
        got = port.families[name][phi]
        assert got.ks == want.ks and got.prefix_sizes == want.prefix_sizes
        assert got.n_rows == want.n_rows
        assert got.storage_bytes(pb) == want.storage_bytes(rb)
        for field in ("entry_key_host", "row_ids", "row_strata",
                      "stratum_freqs"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field), err_msg=field)


@pytest.fixture(scope="module", params=[(w, b) for w in WORKLOADS
                                        for b in (0.5, 1.0)],
                ids=lambda p: f"{p[0]}-{p[1]}")
def built(request):
    name, budget = request.param
    n, _, templates = WORKLOADS[name]
    ref, port = engines(name)
    want = ref.build_samples(name, templates(), budget)
    got = port.build_samples(name, port_templates(templates()), budget,
                             units=ref_units(n, templates()))
    return name, budget, ref, port, want, got


def test_candidate_stats_equal_the_reference(built):
    name, _, ref, port, _, _ = built
    templates = WORKLOADS[name][2]()
    want = R.optimizer.enumerate_candidates(
        templates, ref.candidate_stats(name), 3)
    got = opt_lib.enumerate_candidates(
        port_templates(templates), port.candidate_stats(name), 3)
    assert len(got) == len(want) >= len(templates)
    assert [(c.phi, c.storage, c.n_distinct, c.delta) for c in got] == \
        [(c.phi, c.storage, c.n_distinct, c.delta) for c in want]


def test_build_samples_equals_the_reference(built):
    name, _, ref, port, want, got = built
    assert solution_values(got) == solution_values(want)
    assert solution_values(port.last_solution) == \
        solution_values(ref.last_solution)
    assert got.storage_used <= port.tables[name].nbytes * built[1]
    assert () in port.families[name]
    assert_same_families(ref, port, name)


def test_second_build_drops_and_adds_like_the_reference(built):
    """build_samples again with other templates: the same families go and
    come as in the reference, the generation of every family that went or
    came moves, and nothing derived from a dropped family survives."""
    name, budget, ref, port, _, _ = built
    n = WORKLOADS[name][0]
    before = set(port.families[name])
    gens = {phi: port.family_generation(name, phi) for phi in before}
    # Cache something for every family: its striped block, an ELP decision
    # and a scan program.
    for phi in before:
        q = P.Query(name, P.AggOp.COUNT, group_by=phi[:1],
                    bound=P.ErrorBound(0.5))
        port._striped_for(name, phi)
        port._run_at_k(name, q, phi, port.families[name][phi].ks[-1])
    second = [R.QueryTemplate(frozenset(c), w) for c, w in SECOND[name]]
    want = ref.build_samples(name, second, budget)
    got = port.build_samples(name, port_templates(second), budget,
                             units=ref_units(n, second))
    assert solution_values(got) == solution_values(want)
    assert_same_families(ref, port, name)
    after = set(port.families[name])
    dropped, added = before - after, after - before
    for phi in dropped | added:
        assert port.family_generation(name, phi) == gens.get(phi, 0) + 1
    for phi in before & after:
        assert port.family_generation(name, phi) == gens[phi]
    caches = (port._striped, port._latency, port._batched_programs,
              port._quantile_programs, port._quantile_ranges,
              port._elp_cache)
    for phi in dropped:
        assert not [k for c in caches for k in c if k[:2] == (name, phi)]
    for phi in before & after:
        assert (name, phi) in port._striped


@pytest.mark.parametrize("change_fraction", [0.0, 0.3, 1.0])
def test_exact_solver_and_change_budget_equal_the_reference(change_fraction):
    """build_samples(exact=True) and an Eq.-5 change budget against the
    families already built: the same solution and families as the
    reference, on a second build over other templates."""
    n = 40_000
    ref = R.BlinkDB(R.EngineConfig(k1=200.0, m=4, seed=SEED))
    ref.register_table("s", ref_table.from_columns(
        "s", ref_synth.sessions_table(n, seed=6)))
    port = P.BlinkDB(P.EngineConfig(k1=200.0, m=4, seed=SEED), device="cpu")
    port.register_table("s", table_lib.from_columns(
        "s", synth.sessions_table(n, seed=6)))
    first = common.conviva_templates()           # chooses URL
    # URL stays a candidate: r = 0 keeps the set, r = 0.3 and 1 add OS.
    second = [R.QueryTemplate(frozenset(c), w)
              for c, w in (({"URL", "OS"}, 0.5), ({"City"}, 0.5))]
    for templates, kw in ((first, {}),
                          (second, dict(exact=True,
                                        change_fraction=change_fraction))):
        want = ref.build_samples("s", templates, 0.6, **kw)
        got = port.build_samples("s", port_templates(templates), 0.6,
                                 units=ref_units(n, templates), **kw)
        assert solution_values(got) == solution_values(want)
        assert_same_families(ref, port, "s")


def test_build_samples_seed_and_units_override():
    """Without units the port draws each family from the seed (the config
    seed or the `seed=` override); units for one φ replace its draw only."""
    n = 30_000
    tbl = table_lib.from_columns("sessions", synth.sessions_table(n, seed=2))
    templates = [P.QueryTemplate(frozenset({"City"}), 0.6),
                 P.QueryTemplate(frozenset({"OS"}), 0.4)]

    def build(**kw):
        db = P.BlinkDB(P.EngineConfig(k1=300.0, m=3, seed=3), device="cpu")
        db.register_table("sessions", tbl)
        sol = db.build_samples("sessions", templates, 1.0, **kw)
        assert sorted(db.families["sessions"]) == sorted(
            [()] + [tuple(sorted(c.phi)) for c in sol.chosen])
        return db.families["sessions"]

    for seed, fams in ((3, build()), (11, build(seed=11))):
        for phi, fam in fams.items():
            np.testing.assert_array_equal(
                fam.unit_host,
                samp_lib.base_units(n, seed, uniform=phi == ())[fam.row_ids])
    drawn = build()
    phi0 = min(p for p in drawn if p)
    given = build(units={phi0: np.full(n, 0.5, np.float32)})
    assert (given[phi0].unit_host == 0.5).all()
    for phi in drawn:
        if phi != phi0:
            np.testing.assert_array_equal(given[phi].entry_key_host,
                                          drawn[phi].entry_key_host)


@pytest.mark.parametrize("phi, k", [(("City",), 50), (("OS", "Genre"), 300),
                                    (("URL",), 7)])
def test_stratified_exact_k_equals_the_reference(phi, k):
    raw = synth.sessions_table(40_000, seed=4)
    want = ref_samp.stratified_exact_k(
        ref_table.from_columns("s", ref_synth.sessions_table(40_000, seed=4)),
        phi, k, seed=1)
    got = samp_lib.stratified_exact_k(table_lib.from_columns("s", raw), phi,
                                      k, seed=1)
    assert sorted(got) == sorted(want)
    for col in want:
        np.testing.assert_array_equal(got[col], np.asarray(want[col]),
                                      err_msg=col)


@pytest.mark.parametrize("s", [1.0, 1.5, 2.0])
@pytest.mark.parametrize("k", [1e4, 1e5, 1e6])
def test_zipf_storage_fraction_equals_the_reference_and_table5(s, k):
    """Appendix A Table 5 (M = 1e9, the paper's two significant digits)."""
    table5 = {
        (1.0, 1e4): 0.49, (1.0, 1e5): 0.58, (1.0, 1e6): 0.69,
        (1.5, 1e4): 0.024, (1.5, 1e5): 0.052, (1.5, 1e6): 0.114,
        (2.0, 1e4): 0.0038, (2.0, 1e5): 0.012, (2.0, 1e6): 0.038,
    }
    got = samp_lib.zipf_storage_fraction(s, k, 10 ** 9)
    assert got == ref_samp.zipf_storage_fraction(s, k, 10 ** 9)
    assert abs(got - table5[(s, k)]) / table5[(s, k)] < 0.06
    for m in (1, 999_999, 1_000_000, 1_000_001, 12_345_678):
        assert samp_lib._power_sum(s, m) == ref_samp._power_sum(s, m)


def to_port_query(q):
    """A reference Query in the port's types."""
    pred = P.Predicate(tuple(
        P.Conjunction(tuple(P.Atom(a.column, P.CmpOp[a.op.name], a.value)
                            for a in c.atoms))
        for c in q.predicate.disjuncts))
    bound = (P.ErrorBound(**vars(q.bound))
             if isinstance(q.bound, R.ErrorBound) else
             P.TimeBound(**vars(q.bound)) if q.bound is not None else None)
    return P.Query(q.table, P.AggOp[q.agg.name], q.value_column,
                   predicate=pred, group_by=q.group_by, quantile=q.quantile,
                   bound=bound)


def assert_same_answer(a, b, rtol=1e-4):
    assert (b.sample_phi, b.sample_k, b.rows_read) == \
        (a.sample_phi, a.sample_k, a.rows_read)
    assert (b.bound_met, b.certified) == (a.bound_met, a.certified)
    assert [g.key for g in b.groups] == [g.key for g in a.groups]
    for ga, gb in zip(a.groups, b.groups):
        assert gb.n_selected == ga.n_selected and gb.exact == ga.exact
        np.testing.assert_allclose(
            [gb.estimate, gb.stderr, gb.ci_low, gb.ci_high],
            [ga.estimate, ga.stderr, ga.ci_low, ga.ci_high], rtol=rtol,
            atol=1e-9)


@pytest.mark.parametrize("budget", [0.5, 1.0])
def test_conviva_queries_on_chosen_families_match_the_reference(budget):
    """benchmarks/common.conviva_queries on the families build_samples
    chose. Every field within rtol 1e-4 of the reference's default engine
    (the port's CPU path sums as it does), and the same family, K, rows
    and groups with estimates within rtol 1e-4 of its use_pallas=True
    engine. The stderr is not held to the use_pallas=True engine: at
    AVG(Bitrate) GROUP BY OS on the (OS, URL) family at K = 37.5 the
    reference's two engines differ in it by more than 1e-4 themselves
    (float32 cancellation in the variance, summed in another order)."""
    n, _, templates = WORKLOADS["sessions"]
    ref, port = engines("sessions")
    pallas, _ = engines("sessions", use_pallas=True)
    for db in (ref, pallas):
        db.build_samples("sessions", templates(), budget)
    port.build_samples("sessions", port_templates(templates()), budget,
                       units=ref_units(n, templates()))
    sampled = 0
    for q in common.conviva_queries(ref, R.ErrorBound(0.1)):
        b = port.query(to_port_query(q))
        assert_same_answer(ref.query(q), b)
        c = pallas.query(q)
        assert (b.sample_phi, b.sample_k, b.rows_read) == \
            (c.sample_phi, c.sample_k, c.rows_read)
        assert [(g.key, g.n_selected) for g in b.groups] == \
            [(g.key, g.n_selected) for g in c.groups]
        np.testing.assert_allclose([g.estimate for g in b.groups],
                                   [g.estimate for g in c.groups], rtol=1e-4)
        sampled += b.sample_phi != ("<exact>",)
    assert sampled >= 2


# ------------------------------------------------ more than 4096 strata

N_PROBE = 100_000


@pytest.fixture(scope="module")
def many_strata():
    """The (City, URL) family of sessions_table(100_000, seed=3): 11,838
    strata, which the kernels' shared-memory table (4096) cannot hold."""
    ref = R.BlinkDB(R.EngineConfig(k1=800.0, m=3, seed=0))
    ref.register_table("sessions", ref_table.from_columns(
        "sessions", ref_synth.sessions_table(N_PROBE, seed=3)))
    ref.add_family("sessions", ("City", "URL"))
    ref.add_family("sessions", ())
    port = P.BlinkDB(P.EngineConfig(k1=800.0, m=3, seed=0), device="cpu")
    port.register_table("sessions", table_lib.from_columns(
        "sessions", synth.sessions_table(N_PROBE, seed=3)))
    state.install_families(port, "sessions", {
        ("City", "URL"): ref_samp.base_units(N_PROBE, 0),
        (): ref_samp.base_units(N_PROBE, 0, uniform=True)})
    return ref, port


def _probe_query(m, name):
    both = m.Predicate.where(m.Atom("City", m.CmpOp.EQ, "city001"),
                             m.Atom("URL", m.CmpOp.EQ, "url001"))
    return {
        "count": m.Query("sessions", m.AggOp.COUNT, predicate=both,
                         bound=m.ErrorBound(0.1)),
        "sum": m.Query("sessions", m.AggOp.SUM, "SessionTime",
                       predicate=m.Predicate.where(
                           m.Atom("City", m.CmpOp.EQ, "city000"),
                           m.Atom("URL", m.CmpOp.EQ, "url002")),
                       bound=m.ErrorBound(0.1)),
        "avg": m.Query("sessions", m.AggOp.AVG, "Bitrate",
                       predicate=m.Predicate.where(
                           m.Atom("URL", m.CmpOp.EQ, "url003"),
                           m.Atom("City", m.CmpOp.EQ, "city000")),
                       bound=m.ErrorBound(0.05)),
        "quantile": m.Query("sessions", m.AggOp.QUANTILE, "SessionTime",
                            quantile=0.5, predicate=both,
                            bound=m.ErrorBound(0.1)),
    }[name]


def test_many_strata_family_is_past_the_shared_table(many_strata):
    _, port = many_strata
    fam = port.families["sessions"][("City", "URL")]
    assert fam.n_distinct == 11_838
    striped = port._striped_for("sessions", ("City", "URL"))
    assert striped.freq_table.shape[0] > 4096
    assert striped.strat.dtype == torch.int16


@pytest.mark.parametrize("name", ["count", "sum", "avg"])
def test_many_strata_answers_match_the_reference(many_strata, name):
    """COUNT, SUM and AVG on the 11,838-stratum family answer on the CPU
    within rtol 1e-4 of the reference's default path (use_pallas=False)."""
    ref, port = many_strata
    a = ref.query(_probe_query(R, name))
    b = port.query(_probe_query(P, name))
    assert b.sample_phi == ("City", "URL")
    assert_same_answer(a, b)


def test_many_strata_quantile_against_plain_and_exact(many_strata):
    """QUANTILE on the 11,838-stratum family. The reference's default path
    bins over the data's range, unlike the port's one QUANTILE semantics
    (the family-global range, as the reference's use_pallas=True path), so
    the answer is held against the port's plain quantile scan at the
    answer's K and against exact_query (2 CI half-widths plus one bin of
    each histogram)."""
    _, port = many_strata
    q = _probe_query(P, "quantile")
    ans = port.query(q)
    phi = ("City", "URL")
    assert ans.sample_phi == phi
    striped = port._striped_for("sessions", phi)
    key, vals = port._scan_key("sessions", q, phi)
    names, slots = exec_lib.dedup_atom_slots(exec_lib.flat_atoms(key[2]))
    lo, hi = port._family_range("sessions", phi, "SessionTime")
    _, hist = kref.quantile_scan_ref(
        striped.columns["SessionTime"], striped.unit, striped.strat,
        striped.freq_table, striped.valid,
        tuple(striped.columns[c] for c in names), None,
        torch.tensor([ans.sample_k], dtype=torch.float32), lo, hi,
        torch.tensor([exec_lib.flatten_pred_vals(vals)], dtype=torch.float32),
        tuple(tuple(op for _, op in c) for c in key[2]), slots, 1)
    qv, _ = exec_lib.hist_to_quantile(hist, lo, hi, 0.5)
    assert ans.groups[0].estimate == qv[0].item()
    exact = port.exact_query(q).groups[0].estimate
    tbl = port.tables["sessions"]
    sel = (tbl.columns["City"] == tbl.encode_value("City", "city001")) & \
        (tbl.columns["URL"] == tbl.encode_value("URL", "url001"))
    v = tbl.columns["SessionTime"][sel]
    slack = (hi - lo) / 256.0 + (v.max() - v.min()).item() / 256.0
    g = ans.groups[0]
    half = max(g.ci_high - g.estimate, g.estimate - g.ci_low)
    assert abs(g.estimate - exact) <= 2.0 * half + slack
