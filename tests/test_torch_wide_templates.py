"""Port parity: templates wider than the scan kernels' constant block.

The reference's kernels hold a query's constants in one 128-lane block: k
and 127 atoms for the fused scan, k, lo, hi and 125 atoms for the quantile
scan. A wider template takes the reference's jnp path (derive_ht,
eval_pred, rates = min(1, k/freq), grouped_moments; QUANTILE bins over the
selected rows' own range). The port takes the same steps in torch with the
grouped reduction in agg_scan (and, for QUANTILE, one quantile scan over the
selection as a single atom column). A conjunctive template that wide is a
NOT IN list: an IN list is a disjunction, which §4.1.2 splits into
one-atom subqueries.

Held here against `repro` with EngineConfig(use_pallas=True), the
reference's sample units carried into the port: chosen family and K
exact, answers at rtol 1e-4; and within the port, query_batch equal to
query() bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import executor as ref_exec
from repro.core import sampling as ref_samp
from repro.core import table as ref_table
from repro.core.types import CmpOp as JaxCmpOp
from repro.data import synth as ref_synth
import repro_torch.core as P
from repro_torch import state
from repro_torch.core import executor as exec_lib
from repro_torch.core import table as table_lib
from repro_torch.core.types import CmpOp
from repro_torch.data import synth

N_ROWS, SEED = 50_000, 0
RTOL, ATOL = 2e-5, 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref_db():
    db = R.BlinkDB(R.EngineConfig(k1=800.0, m=3, seed=SEED, use_pallas=True))
    db.register_table("sessions", ref_table.from_columns(
        "sessions", ref_synth.sessions_table(N_ROWS, seed=3)))
    db.add_family("sessions", ("OS",))
    db.add_family("sessions", ())
    return db


def _port_db():
    db = P.BlinkDB(P.EngineConfig(k1=800.0, m=3, seed=SEED), device="cpu")
    db.register_table("sessions", table_lib.from_columns(
        "sessions", synth.sessions_table(N_ROWS, seed=3)))
    state.install_families(db, "sessions", {
        ("OS",): ref_samp.base_units(N_ROWS, SEED),
        (): ref_samp.base_units(N_ROWS, SEED, uniform=True)})
    return db


@pytest.fixture(scope="module")
def engines():
    return _ref_db(), _port_db()


def _not_in(m, n_atoms):
    """A conjunction of n_atoms NE atoms over the least popular values:
    URL (500 values) for 126 and 200 atoms, City (200) for 128 and 130."""
    col, prefix, total = (("URL", "url", 500) if n_atoms in (126, 200)
                          else ("City", "city", 200))
    return m.Predicate.where(*[m.Atom(col, m.CmpOp.NE,
                                      f"{prefix}{total - 1 - i:03d}")
                               for i in range(n_atoms)])


def _query(m, agg, n_atoms):
    pred = _not_in(m, n_atoms)
    if agg == "count":
        return m.Query("sessions", m.AggOp.COUNT, predicate=pred,
                       group_by=("OS",), bound=m.ErrorBound(0.1))
    if agg == "avg":
        return m.Query("sessions", m.AggOp.AVG, "SessionTime",
                       predicate=pred, bound=m.ErrorBound(0.05))
    return m.Query("sessions", m.AggOp.QUANTILE, "SessionTime", quantile=0.9,
                   predicate=pred, bound=m.ErrorBound(0.1))


CASES = [(agg, n) for agg in ("count", "avg", "quantile")
         for n in (128, 130, 200)] + [("quantile", 126)]


def _assert_same_answer(a, b):
    assert (b.sample_phi, b.sample_k, b.rows_read) == \
        (a.sample_phi, a.sample_k, a.rows_read)
    assert (b.bound_met, b.certified) == (a.bound_met, a.certified)
    assert [g.key for g in b.groups] == [g.key for g in a.groups]
    for ga, gb in zip(a.groups, b.groups):
        assert gb.exact == ga.exact and gb.n_selected == ga.n_selected
        for f in ("estimate", "ci_low", "ci_high", "stderr"):
            np.testing.assert_allclose(getattr(gb, f), getattr(ga, f),
                                       rtol=1e-4, atol=1e-9, err_msg=f)


def _bits(ans) -> tuple:
    return (ans.sample_phi, ans.sample_k, ans.rows_read, ans.bound_met,
            ans.certified, ans.predicted_half_width,
            [(g.key, g.estimate, g.stderr, g.ci_low, g.ci_high, g.n_selected,
              g.exact) for g in ans.groups])


@pytest.mark.parametrize("agg, n_atoms", CASES)
def test_wide_query_matches_reference(engines, agg, n_atoms):
    ref, port = engines
    a = ref.query(_query(R, agg, n_atoms))
    b = port.query(_query(P, agg, n_atoms))
    assert b.groups
    _assert_same_answer(a, b)


def test_wide_query_batch_matches_reference_and_query(engines):
    """One batch of every wide template, twice with other constants: the
    answers match the reference's query_batch, and query() on the same
    engine afterwards gives every answer bit for bit. The module's engines
    serve it with their ELP decisions cleared, so the batch decides afresh
    while the reference's programs compiled by the cases above (its
    family-selection probes among them) are reused."""
    ref, port = engines
    ref._elp_cache.clear()
    port._elp_cache.clear()
    queries = [(agg, n) for agg, n in CASES] * 2
    rq = [_query(R, agg, n) for agg, n in queries]
    pq = [_query(P, agg, n) for agg, n in queries]
    for a, b in zip(ref.query_batch(rq), port.query_batch(pq)):
        _assert_same_answer(a, b)
    batched = port.query_batch(pq)
    for q, b in zip(pq, batched):
        assert _bits(b) == _bits(port.query(q))


def _struct(n_atoms, op_enum):
    col = "URL" if n_atoms in (126, 200) else "City"
    return ((((col, op_enum.NE),) * n_atoms),)


@pytest.mark.parametrize("n_atoms", [128, 200])
def test_wide_batched_program_matches_reference_and_single(engines, n_atoms):
    ref, port = engines
    phi = ("OS",)
    r_striped = ref._striped_for("sessions", phi)
    p_striped = port._striped_for("sessions", phi)
    n_groups = port._column_card("sessions", "OS")
    ks = [800.0, 200.0, 50.0]
    consts = [[float(300 + i % 7) for i in range(n_atoms)],
              [float(i) for i in range(n_atoms)],
              [float(100 + i) for i in range(n_atoms)]]
    r_fn = ref_exec.make_batched_query_fn(
        _struct(n_atoms, JaxCmpOp), "SessionTime", "OS", n_groups,
        use_pallas=True)
    want = r_fn(jnp.asarray(ks, jnp.float32), jnp.asarray(consts, jnp.float32),
                *ref_exec.scan_args(r_striped))
    p_fn = exec_lib.make_batched_query_fn(_struct(n_atoms, CmpOp),
                                          "SessionTime", "OS", n_groups)
    got = p_fn(torch.tensor(ks), torch.tensor(consts),
               *exec_lib.scan_args(p_striped))
    np.testing.assert_allclose(
        got.stacked().numpy(),
        np.stack([np.asarray(x) for x in jax.tree.leaves(want)], axis=1),
        rtol=RTOL, atol=ATOL)
    one = exec_lib.make_query_fn(_struct(n_atoms, CmpOp), "SessionTime", "OS",
                                 n_groups)
    for i, k in enumerate(ks):
        single = one(k, (tuple(consts[i]),), *exec_lib.scan_args(p_striped))
        assert torch.equal(single.stacked(), got.stacked()[i])


@pytest.mark.parametrize("n_atoms", [125, 126, 130])
def test_wide_quantile_program_bins_over_the_selection(engines, n_atoms):
    """From 126 atoms the quantile program bins over the selected rows'
    range, as the reference's jnp path; at 125 it keeps the kernel path's
    family-global range. Both match the reference's use_pallas=True
    program."""
    ref, port = engines
    phi = ("OS",)
    r_striped = ref._striped_for("sessions", phi)
    p_striped = port._striped_for("sessions", phi)
    n_groups = port._column_card("sessions", "OS")
    col = "URL"
    enc = port._encode("sessions")
    vals = (tuple(float(enc(col, f"url{499 - i:03d}"))
                  for i in range(n_atoms)),)
    lo, hi = port._family_range("sessions", phi, "SessionTime")
    r_fn = ref_exec.make_quantile_fn(((((col, JaxCmpOp.NE),) * n_atoms),),
                                     "SessionTime", "OS", n_groups,
                                     use_pallas=True)
    p_fn = exec_lib.make_quantile_fn(((((col, CmpOp.NE),) * n_atoms),),
                                     "SessionTime", "OS", n_groups)
    for k, level in ((800.0, 0.9), (100.0, 0.5)):
        rm, rq, rd = r_fn(jnp.float32(k), vals, jnp.float32(level),
                          jnp.float32(lo), jnp.float32(hi),
                          *ref_exec.scan_args(r_striped))
        pm, pq, pd = p_fn(k, vals, level, lo, hi,
                          *exec_lib.scan_args(p_striped))
        want = np.stack([np.asarray(x) for x in jax.tree.leaves(rm)])
        np.testing.assert_allclose(pm.stacked().numpy(), want, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(pq.numpy(), np.asarray(rq), rtol=1e-4)
        np.testing.assert_allclose(pd.numpy(), np.asarray(rd), rtol=1e-4)
