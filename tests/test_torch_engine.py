"""Port parity: BlinkDB.query end to end, the slice's main path.

The verify-skill workload (.claude/skills/verify/SKILL.md: 50k sessions,
k1=800, m=3, families ("OS",) and ()) runs through the reference engine
(`repro`, use_pallas=False) and the port (`repro_torch`, on the CPU), with
the reference's sample units carried into the port. Both must pick the same
family, K and group keys; estimates and CI bounds must agree within rtol
1e-4 (the tolerance of tests/test_kernels.py::test_engine_pallas_path_end_to_end).
"""
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import elp as ref_elp
from repro.core import sampling as ref_samp
from repro.core import table as ref_table
from repro.data import synth as ref_synth
import repro_torch.core as P
from repro_torch import state
from repro_torch.core import elp
from repro_torch.core import table as table_lib
from repro_torch.data import synth
from repro_torch.kernels import agg_scan

N_ROWS, SEED = 50_000, 0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _engines(**cfg):
    ref = R.BlinkDB(R.EngineConfig(k1=800.0, m=3, seed=SEED, **cfg))
    ref.register_table("sessions", ref_table.from_columns(
        "sessions", ref_synth.sessions_table(N_ROWS, seed=3)))
    ref.add_family("sessions", ("OS",))
    ref.add_family("sessions", ())
    port = P.BlinkDB(P.EngineConfig(k1=800.0, m=3, seed=SEED, **cfg),
                     device="cpu")
    port.register_table("sessions", table_lib.from_columns(
        "sessions", synth.sessions_table(N_ROWS, seed=3)))
    state.install_families(port, "sessions", {
        ("OS",): ref_samp.base_units(N_ROWS, SEED),
        (): ref_samp.base_units(N_ROWS, SEED, uniform=True)})
    return ref, port


@pytest.fixture(scope="module")
def engines():
    return _engines()


def _query(m, name):
    """The slice's queries, built in either package's types."""
    genre = m.Predicate.where(m.Atom("Genre", m.CmpOp.EQ, "genre03"))
    q = {
        "avg_by_os": m.Query("sessions", m.AggOp.AVG, "SessionTime",
                             group_by=("OS",), bound=m.ErrorBound(0.1)),
        "count_pred_by_os": m.Query("sessions", m.AggOp.COUNT,
                                    predicate=genre, group_by=("OS",),
                                    bound=m.ErrorBound(0.1)),
        "count_all": m.Query("sessions", m.AggOp.COUNT,
                             bound=m.ErrorBound(0.05)),
        "sum_dt_lt": m.Query("sessions", m.AggOp.SUM, "Bitrate",
                             predicate=m.Predicate.where(
                                 m.Atom("dt", m.CmpOp.LT, 15)),
                             bound=m.ErrorBound(0.05)),
        "sum_abs_bound": m.Query("sessions", m.AggOp.SUM, "SessionTime",
                                 group_by=("OS",),
                                 bound=m.ErrorBound(2e4, relative=False)),
        "avg_by_genre": m.Query("sessions", m.AggOp.AVG, "SessionTime",
                                group_by=("Genre",), bound=m.ErrorBound(0.05)),
        "count_or": m.Query("sessions", m.AggOp.COUNT, predicate=m.Predicate((
            m.Conjunction((m.Atom("OS", m.CmpOp.EQ, "os1"),)),
            m.Conjunction((m.Atom("OS", m.CmpOp.EQ, "os3"),
                           m.Atom("Genre", m.CmpOp.GE, "genre05"))))),
            bound=m.ErrorBound(0.1)),
        "sum_unbounded": m.Query("sessions", m.AggOp.SUM, "SessionTime",
                                 group_by=("OS",)),
        "exact_rung": m.Query("sessions", m.AggOp.AVG, "SessionTime",
                              group_by=("City",), bound=m.ErrorBound(0.002)),
        "empty_selection": m.Query("sessions", m.AggOp.COUNT,
                                   predicate=m.Predicate.where(
                                       m.Atom("City", m.CmpOp.EQ, "nowhere")),
                                   bound=m.ErrorBound(0.1)),
    }
    return q[name]


def _assert_same_answer(a, b):
    assert b.sample_phi == a.sample_phi
    assert b.sample_k == a.sample_k
    assert b.rows_read == a.rows_read
    assert (b.bound_met, b.certified) == (a.bound_met, a.certified)
    if a.predicted_half_width is None:
        assert b.predicted_half_width is None
    else:
        np.testing.assert_allclose(b.predicted_half_width,
                                   a.predicted_half_width, rtol=1e-4)
    assert [g.key for g in b.groups] == [g.key for g in a.groups]
    for ga, gb in zip(a.groups, b.groups):
        assert gb.exact == ga.exact and gb.n_selected == ga.n_selected
        for f in ("estimate", "ci_low", "ci_high", "stderr"):
            np.testing.assert_allclose(getattr(gb, f), getattr(ga, f),
                                       rtol=1e-4, atol=1e-9, err_msg=f)


@pytest.mark.parametrize("name", [
    "avg_by_os", "count_pred_by_os", "count_all", "sum_dt_lt",
    "sum_abs_bound", "avg_by_genre", "count_or", "sum_unbounded",
    "exact_rung", "empty_selection"])
def test_query_matches_reference(engines, name):
    ref, port = engines
    a = ref.query(_query(R, name))
    b = port.query(_query(P, name))
    _assert_same_answer(a, b)
    if name == "exact_rung":
        assert b.sample_phi == ("<exact>",) and b.bound_met


def test_cached_decision_replays_the_same(engines):
    ref, port = engines
    for _ in range(2):
        _assert_same_answer(ref.query(_query(R, "avg_by_os")),
                            port.query(_query(P, "avg_by_os")))


@pytest.mark.parametrize("name", ["count_pred_by_os", "sum_dt_lt"])
def test_exact_query_matches_reference(engines, name):
    ref, port = engines
    _assert_same_answer(ref.exact_query(_query(R, name)),
                        port.exact_query(_query(P, name)))


def test_strict_unreachable_bound_raises():
    ref, port = _engines(exact_fallback=False)
    qs = [m.Query("sessions", m.AggOp.AVG, "SessionTime", group_by=("City",),
                  bound=m.ErrorBound(0.002, strict=True)) for m in (R, P)]
    with pytest.raises(R.BoundUnreachableError) as ea:
        ref.query(qs[0])
    with pytest.raises(P.BoundUnreachableError) as eb:
        port.query(qs[1])
    np.testing.assert_allclose(eb.value.predicted_half_width,
                               ea.value.predicted_half_width, rtol=1e-4)


@pytest.mark.parametrize("a, b, seconds", [(2e-8, 1e-4, 0.0003),
                                           (1e-9, 1e-5, 1.0),
                                           (1e-6, 1e-3, 1e-6)])
def test_time_bound_with_injected_latency_model(engines, a, b, seconds):
    ref, port = engines
    qs = [m.Query("sessions", m.AggOp.AVG, "Bitrate", group_by=("OS",),
                  bound=m.TimeBound(seconds)) for m in (R, P)]
    ref._latency[("sessions", ("OS",))] = ref_elp.LatencyModel(a, b)
    port._latency[("sessions", ("OS",))] = elp.LatencyModel(a, b)
    _assert_same_answer(ref.query(qs[0]), port.query(qs[1]))


def test_time_bound_calibrates_a_model(engines):
    """Without an injected model the port calibrates one from synchronised
    scan times on the smallest resolutions and answers inside the family."""
    _, port = engines
    port._latency.clear()
    q = P.Query("sessions", P.AggOp.COUNT, group_by=("OS",),
                bound=P.TimeBound(0.5))
    ans = port.query(q)
    model = port._latency[("sessions", ("OS",))]
    assert model.a >= 0.0 and model.b >= 0.0
    assert ans.sample_k in port.families["sessions"][("OS",)].ks
    assert ans.groups and ans.bound_met is None


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        assert P.BlinkDB().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.BlinkDB()
        with pytest.raises(RuntimeError, match="CUDA"):
            P.BlinkDB(P.EngineConfig(device="cuda:0"))
    assert P.BlinkDB(device="cpu").device.type == "cpu"


def test_later_slices_raise_not_implemented(engines):
    """The multi-device scan has landed (tests/test_torch_mesh.py): a mesh
    must be a torch.distributed DeviceMesh, and anything else is refused
    with a TypeError, by the scan and by the engine. Joins and subsampling
    CIs have landed too (tests/test_torch_joins.py,
    tests/test_torch_subsampling.py): the engine takes them, and refuses
    a CI method it does not know."""
    from repro_torch.core import executor as exec_lib
    _, port = engines
    striped = port._striped_for("sessions", ("OS",))
    with pytest.raises(TypeError, match="DeviceMesh"):
        exec_lib.run_query_striped(striped, (), None, None, 1, 100.0,
                                   mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        P.BlinkDB(device="cpu", mesh=object())
    assert P.BlinkDB(P.EngineConfig(ci_method="subsampling"),
                     device="cpu").config.n_subsamples == 32
    with pytest.raises(ValueError, match="ci_method"):
        P.BlinkDB(P.EngineConfig(ci_method="bootstrap"), device="cpu")


def test_template_over_kernel_atom_limit_raises(engines):
    """A template of 128 atoms does not fit the fused kernel's descriptor
    (127): the kernel's argument check raises for it, the engine does not.
    The engine answers it as the reference does, on the wide path (torch
    predicate, agg_scan reduction); 127 atoms stay on the fused kernel.
    Both match the reference's answers."""
    ref, port = engines
    for n_atoms in (128, 127):
        qs = [m.Query("sessions", m.AggOp.COUNT, group_by=("OS",),
                      predicate=m.Predicate.where(
                          *[m.Atom("dt", m.CmpOp.GE, i % 3)
                            for i in range(n_atoms)]),
                      bound=m.ErrorBound(0.1)) for m in (R, P)]
        _assert_same_answer(ref.query(qs[0]), port.query(qs[1]))
    one = torch.ones(4)
    with pytest.raises(ValueError, match="atoms"):
        agg_scan.check_fused_args(
            None, one, torch.zeros(4, dtype=torch.int8), one,
            torch.ones(4, dtype=torch.bool),
            (torch.zeros(4, dtype=torch.int8),), None, torch.ones(1),
            torch.zeros(1, 128), ((P.CmpOp.GE,) * 128,), None, 1)


def test_disjunctive_avg_rejected_like_reference(engines):
    _, port = engines
    q = P.Query("sessions", P.AggOp.AVG, "SessionTime",
                predicate=P.Predicate((
                    P.Conjunction((P.Atom("OS", P.CmpOp.EQ, "os1"),)),
                    P.Conjunction((P.Atom("OS", P.CmpOp.EQ, "os2"),)))))
    with pytest.raises(ValueError, match="additive"):
        port.query(q)
