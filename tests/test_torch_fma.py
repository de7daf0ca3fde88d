"""The port's emulated fused multiply-adds round once, as a true FMA does.

`estimators._fma_f32` (z_value's ndtri and logf) and `executor._fma_f32`
(hist_to_quantile's interpolations) compute a·b + c for float32 operands.
The float32 product is exact in float64, the float64 sum is not: rounding
it to float32 rounds twice, one ulp off on near-ties. Both helpers are held
here against the exactly rounded value from `fractions.Fraction`, on
constructed triples whose float64 sum lands on a float32 midpoint.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

from repro_torch.core import estimators, executor


def _round_f32(x: Fraction) -> np.float32:
    """x rounded to the nearest float32, ties to even."""
    f = np.float32(float(x))
    best = None
    for y in (np.nextafter(f, np.float32(-np.inf)), f,
              np.nextafter(f, np.float32(np.inf))):
        key = (abs(Fraction(float(y)) - x), int(y.view(np.int32)) & 1)
        if best is None or key < best[0]:
            best = (key, y)
    return best[1]


def _near_ties(n_cases=300, seed=0):
    """(a, b, c) float32 triples with a·b close to half an ulp of c, kept
    where the float64 sum is exactly a float32 midpoint and the exact sum
    is not; with the ROADMAP's example first."""
    rng = np.random.default_rng(seed)
    n = 200_000
    a = rng.uniform(1.0, 2.0, n).astype(np.float32)
    c = (rng.uniform(1.0, 2.0, n) * rng.choice([-1.0, 1.0], n)).astype(
        np.float32)
    half_ulp = np.spacing(np.abs(c)).astype(np.float64) / 2
    b = (half_ulp / a * np.sign(c) * rng.choice([-1.0, 1.0], n)).astype(
        np.float32)
    s = a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)
    r = s.astype(np.float32).astype(np.float64)
    other = np.where(r > s, np.nextafter(s.astype(np.float32), -np.inf),
                     np.nextafter(s.astype(np.float32), np.inf))
    on_mid = (r + other.astype(np.float64)) / 2 == s
    idx = np.flatnonzero(on_mid)[:n_cases]
    cases = [(np.float32(0.15027946), np.float32(3.9662535e-07),
              np.float32(1.336117))]
    for i in idx:
        x = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        if x != Fraction(float(s[i])):
            cases.append((a[i], b[i], c[i]))
    return cases


@pytest.fixture(scope="module")
def near_ties():
    cases = _near_ties()
    want = [_round_f32(Fraction(float(a)) * Fraction(float(b))
                       + Fraction(float(c))) for a, b, c in cases]
    naive = [np.float32(np.float64(a) * np.float64(b) + np.float64(c))
             for a, b, c in cases]
    # The construction bites: rounding the float64 sum is wrong on many.
    assert len(cases) > 100
    assert sum(n != w for n, w in zip(naive, want)) > 20
    return cases, want


def test_known_near_tie_rounds_up():
    a, b, c = np.float32(0.15027946), np.float32(3.9662535e-07), \
        np.float32(1.336117)
    assert estimators._fma_f32(a, b, c) == np.float32(1.3361171)
    got = executor._fma_f32(*(torch.tensor([x]) for x in (a, b, c)))
    assert got.item() == np.float32(1.3361171)


def test_scalar_fma_rounds_once(near_ties):
    cases, want = near_ties
    got = [estimators._fma_f32(a, b, c) for a, b, c in cases]
    bad = [(cases[i], got[i], want[i]) for i in range(len(cases))
           if got[i] != want[i]]
    assert not bad, bad[:5]


def test_tensor_fma_rounds_once(near_ties):
    cases, want = near_ties
    a, b, c = (torch.tensor(np.array(col, np.float32))
               for col in zip(*cases))
    got = executor._fma_f32(a, b, c).numpy()
    np.testing.assert_array_equal(got, np.array(want, np.float32))


def test_fma_agrees_off_ties():
    rng = np.random.default_rng(1)
    a, b, c = (rng.normal(0, 10, 5000).astype(np.float32) for _ in range(3))
    want = (a.astype(np.float64) * b + c).astype(np.float32)
    np.testing.assert_array_equal(
        executor._fma_f32(*map(torch.from_numpy, (a, b, c))).numpy(), want)
    for i in range(0, 5000, 97):
        assert estimators._fma_f32(a[i], b[i], c[i]) == want[i]
