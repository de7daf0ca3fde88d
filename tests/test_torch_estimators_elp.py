"""Port parity: estimators, CIs and the error-latency profile.

The same seeded moments and families go through `repro` and `repro_torch`.
z_value must equal the reference's float32 ndtri exactly (a chosen K or a
bound verdict at the margin can turn on one ulp of z); the float32
estimator arithmetic is held at rtol 1e-6; the ELP's choices must match.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import ndtri

from repro.core import elp as ref_elp
from repro.core import estimators as ref_est
from repro.core import sampling as ref_samp
from repro.core import table as ref_table
from repro.core.types import AggOp as JaxAggOp
from repro.data import synth as ref_synth
from repro_torch.core import elp, estimators as est
from repro_torch.core import sampling as samp
from repro_torch.core import table as table_lib
from repro_torch.core.types import AggOp


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_z_value_equals_reference_over_confidences():
    grid = [float(c) for c in np.linspace(0.5, 0.9999, 1001)] + \
        [0.8, 0.9, 0.95, 0.99, 0.999, 1e-9, 0.6827]
    for c in grid:
        assert est.z_value(c) == ref_est.z_value(c), c
    assert est.z_value(0.95) == 1.9599642753601074


def test_ndtri_equals_reference_over_probabilities():
    ps = np.concatenate([np.linspace(1e-6, 1 - 1e-6, 1501),
                         [1e-30, 1e-12, np.exp(-2.0), 0.5, 0.86]])
    for p in ps:
        assert est.ndtri_f32(float(p)) == float(ndtri(float(p))), p
    assert est.ndtri_f32(0.0) == float("-inf")
    assert est.ndtri_f32(1.0) == float("inf")


def _moments(rng, g):
    n = rng.integers(0, 400, g).astype(np.float32)
    n[0] = 0.0
    wsum = n * rng.uniform(1.0, 30.0, g).astype(np.float32)
    vals = [n, wsum,
            wsum * rng.uniform(5, 50, g).astype(np.float32),
            wsum * rng.uniform(100, 2500, g).astype(np.float32),
            wsum * rng.uniform(0, 20, g).astype(np.float32),
            wsum * rng.uniform(0, 400, g).astype(np.float32),
            wsum * rng.uniform(0, 9000, g).astype(np.float32)]
    vals = [v.astype(np.float32) for v in vals]
    return (ref_est.GroupedMoments(*map(jnp.asarray, vals)),
            est.GroupedMoments(*map(torch.from_numpy, vals)))


@pytest.mark.parametrize("agg", ["COUNT", "SUM", "AVG"])
@pytest.mark.parametrize("relative", [True, False])
def test_estimate_ci_required_n_match(agg, relative):
    rng = np.random.default_rng(len(agg) + relative)
    rm, pm = _moments(rng, 40)
    re_ = ref_est.estimate(JaxAggOp[agg], rm)
    pe = est.estimate(AggOp[agg], pm)
    for f in ("value", "variance", "n"):
        np.testing.assert_allclose(getattr(pe, f).numpy(),
                                   np.asarray(getattr(re_, f)), rtol=1e-6)
    for a, b in zip(est.ci(pe, 0.95), ref_est.ci(re_, 0.95)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    eps = 0.05 if relative else 3.0
    np.testing.assert_allclose(
        est.required_n_for_error(AggOp[agg], pe, eps, 0.9, relative).numpy(),
        np.asarray(ref_est.required_n_for_error(JaxAggOp[agg], re_, eps, 0.9,
                                                relative)), rtol=1e-6)
    np.testing.assert_allclose(est.effective_sample_size(pm).numpy(),
                               np.asarray(ref_est.effective_sample_size(rm)),
                               rtol=1e-6)


@pytest.mark.parametrize("conf", [0.9, 0.95, 0.99])
def test_pilot_inflation_matches(conf):
    n = np.array([0, 1, 2, 5, 30, 1000, 1e6])
    np.testing.assert_array_equal(est.pilot_inflation(n, conf),
                                  ref_est.pilot_inflation(n, conf))


def test_grouped_moments_matches_segment_sum():
    rng = np.random.default_rng(9)
    n, g = 8192, 37
    v = rng.normal(3, 2, n).astype(np.float32)
    r = rng.uniform(0.01, 1.0, n).astype(np.float32)
    m = rng.random(n) < 0.6
    c = rng.integers(0, g, n).astype(np.int32)
    a = est.grouped_moments(*map(torch.from_numpy, (v, r, m, c)), g)
    b = ref_est.grouped_moments(*map(jnp.asarray, (v, r, m, c)), g)
    np.testing.assert_allclose(a.stacked().numpy(),
                               np.stack([np.asarray(x) for x in
                                         (b.n, b.wsum, b.wxsum, b.wx2sum,
                                          b.var_count, b.var_sum, b.var_sum2)]),
                               rtol=2e-5, atol=1e-3)


@pytest.mark.parametrize("rows, times", [
    ([100, 200], [0.001, 0.0015]),
    ([100, 200, 400], [0.003, 0.002, 0.001]),     # negative slope face
    ([100, 200, 400], [0.0001, 0.0021, 0.0061]),  # negative intercept face
    ([50], [0.002]),
])
def test_fit_latency_matches(rows, times):
    a = elp.fit_latency(rows, times)
    b = ref_elp.fit_latency(rows, times)
    assert (a.a, a.b) == (b.a, b.b)
    for s in (0.0, 0.001, 0.05):
        assert a.max_rows_within(s) == b.max_rows_within(s)


@pytest.fixture(scope="module")
def families():
    raw = ref_synth.sessions_table(20_000, seed=6)
    rt = ref_table.from_columns("s", raw)
    pt = table_lib.from_columns("s", raw)
    units = ref_samp.base_units(20_000, 2)
    return (ref_samp.build_family(rt, ("City",), 500.0, m=5, units=units),
            samp.build_family(pt, ("City",), 500.0, m=5, units=units))


@pytest.mark.parametrize("n_probe, n_req", [
    (100.0, 50.0), (100.0, 1000.0), (100.0, 1e9), (0.0, 10.0),
    ([10.0, 0.0, 40.0], [100.0, 5.0, 80.0]),
])
def test_pick_k_for_error_matches(families, n_probe, n_req):
    rf, pf = families
    k_probe = min(pf.ks)
    assert elp.pick_k_for_error(pf, n_probe, n_req, k_probe) == \
        ref_elp.pick_k_for_error(rf, n_probe, n_req, k_probe)


@pytest.mark.parametrize("a, b, seconds, headroom", [
    (1e-8, 1e-4, 0.001, 0.0), (1e-6, 0.0, 0.005, 0.001),
    (0.0, 1e-3, 0.01, 0.0), (1e-3, 1e-3, 0.0001, 0.0),
])
def test_pick_k_for_time_matches(families, a, b, seconds, headroom):
    rf, pf = families
    assert elp.pick_k_for_time(pf, elp.LatencyModel(a, b), seconds,
                               headroom) == \
        ref_elp.pick_k_for_time(rf, ref_elp.LatencyModel(a, b), seconds,
                                headroom)


def test_run_probes_visits_smallest_resolutions(families):
    _, pf = families
    seen = []
    probes = elp.run_probes(pf, lambda k: (seen.append(k) or 1.0, 0.01), 2)
    assert seen == sorted(pf.ks)[:2]
    assert [p.rows_read for p in probes] == \
        [pf.prefix_sizes[pf.ks.index(k)] for k in seen]
