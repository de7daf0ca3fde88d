"""The port's §3.2 optimization framework (`repro_torch.core.optimizer`):
the reference's checks of tests/test_optimizer.py run on the port, and
seeded instances run through both packages give equal candidates and
equal solutions (both are numpy, so equal, not close)."""
import itertools

import numpy as np
import pytest

from repro.core import optimizer as ref_opt
from repro.core import types as ref_types
from repro_torch.core import optimizer as opt
from repro_torch.core.types import QueryTemplate


def _mk(phi, storage, nd, delta, m=opt):
    return m.Candidate(frozenset(phi), storage, nd, delta)


def _wl(*items, m=opt, template=QueryTemplate):
    ts, ds, nds = [], [], []
    for cols, w, delta, nd in items:
        ts.append(template(frozenset(cols), w))
        ds.append(delta)
        nds.append(nd)
    return m.Workload(tuple(ts), tuple(ds), tuple(nds))


def test_enumerate_candidates_subsets_only():
    templates = [QueryTemplate(frozenset({"a", "b", "c"}), 0.6),
                 QueryTemplate(frozenset({"c", "d"}), 0.4)]
    cands = opt.enumerate_candidates(
        templates, lambda phi: (10.0, 5.0, 2.0), max_cols=2)
    phis = {tuple(sorted(c.phi)) for c in cands}
    assert ("a",) in phis and ("a", "b") in phis and ("c", "d") in phis
    assert ("a", "b", "c") not in phis, "max_cols=2 respected"
    assert ("a", "d") not in phis, "never co-occurred in a template"


def test_budget_respected_and_coverage():
    cands = [_mk({"city"}, 40, 100, 80), _mk({"os"}, 25, 5, 1),
             _mk({"url"}, 60, 400, 300), _mk({"city", "os"}, 70, 450, 350)]
    wl = _wl(({"city"}, 0.4, 80, 100), ({"city", "os"}, 0.4, 350, 450),
             ({"url"}, 0.2, 300, 400))
    sol = opt.solve_greedy(cands, wl, budget=80.0)
    assert sol.storage_used <= 80.0
    assert all(0 <= y <= 1 for y in sol.coverage.values())


def _instance(seed, m=opt, template=QueryTemplate):
    """The reference test's seeded instance: 15 candidates over 5 columns
    and 4 templates, in the given package's types."""
    rng = np.random.default_rng(seed)
    cols = ["a", "b", "c", "d", "e"]
    cands = []
    for r in (1, 2):
        for combo in itertools.combinations(cols, r):
            cands.append(_mk(set(combo), float(rng.integers(10, 80)),
                             float(rng.integers(4, 300)),
                             float(rng.integers(1, 200)), m=m))
    items = []
    for _ in range(4):
        k = int(rng.integers(1, 3))
        sel = rng.choice(len(cols), size=k, replace=False)
        items.append(({cols[i] for i in sel}, float(rng.random() + 0.1),
                      float(rng.integers(10, 200)),
                      float(rng.integers(10, 400))))
    return cands, _wl(*items, m=m, template=template)


@pytest.mark.parametrize("seed", range(8))
def test_greedy_matches_exact_on_small_instances(seed):
    """Greedy+swap must reach ≥95% of the exact optimum (usually 100%)."""
    cands, wl = _instance(seed)
    budget = 120.0
    g = opt.solve_greedy(cands, wl, budget)
    e = opt.solve_exact(cands, wl, budget)
    assert g.storage_used <= budget and e.storage_used <= budget
    assert g.objective >= 0.95 * e.objective - 1e-9, (g.objective, e.objective)


def test_change_budget_eq5():
    """r=0 freezes the existing set; r=1 allows full churn (§3.2.3)."""
    cands = [_mk({"a"}, 50, 10, 5), _mk({"b"}, 50, 200, 150)]
    wl = _wl(({"b"}, 1.0, 150, 200))
    existing = frozenset({frozenset({"a"})})
    frozen = opt.solve_greedy(cands, wl, budget=100.0, existing=existing,
                              change_fraction=0.0)
    assert {tuple(sorted(c.phi)) for c in frozen.chosen} == {("a",)}, \
        "r=0: no creations or deletions allowed"
    free = opt.solve_greedy(cands, wl, budget=100.0, existing=existing,
                            change_fraction=1.0)
    assert frozenset({"b"}) in {c.phi for c in free.chosen}, \
        "r=1: optimizer free to adopt the better family"
    ex = opt.solve_exact(cands, wl, budget=100.0, existing=existing,
                         change_fraction=0.0)
    assert {tuple(sorted(c.phi)) for c in ex.chosen} == {("a",)}


def test_skew_drives_selection():
    """Higher Δ(φ) (more skew) wins at equal cost/weight (§3.2.1)."""
    cands = [_mk({"uniformcol"}, 50, 100, 0.0),
             _mk({"skewcol"}, 50, 100, 500.0)]
    wl = _wl(({"uniformcol"}, 0.5, 0.0, 100), ({"skewcol"}, 0.5, 500.0, 100))
    sol = opt.solve_greedy(cands, wl, budget=50.0)
    assert {c.phi for c in sol.chosen} == {frozenset({"skewcol"})}


def _as_tuple(sol):
    """A Solution as plain values, comparable across the two packages."""
    return ([(c.phi, c.storage, c.n_distinct, c.delta) for c in sol.chosen],
            sol.objective, sol.storage_used, sol.coverage)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("budget", [60.0, 120.0, 400.0])
@pytest.mark.parametrize("solver", ["solve_greedy", "solve_exact"])
@pytest.mark.parametrize("change", [None, 0.0, 0.3, 1.0])
def test_solutions_equal_the_reference(seed, budget, solver, change):
    """Both packages' solvers on one seeded instance, without and with
    existing families under an Eq.-5 change budget, give equal solutions."""
    cands, wl = _instance(seed)
    ref_cands, ref_wl = _instance(seed, m=ref_opt,
                                  template=ref_types.QueryTemplate)
    kw = {}
    if change is not None:
        rng = np.random.default_rng(100 + seed)
        picked = rng.choice(len(cands), size=3, replace=False)
        kw = dict(existing=frozenset(cands[i].phi for i in picked),
                  change_fraction=change)
    got = getattr(opt, solver)(cands, wl, budget, **kw)
    want = getattr(ref_opt, solver)(ref_cands, ref_wl, budget, **kw)
    assert _as_tuple(got) == _as_tuple(want)


@pytest.mark.parametrize("max_cols", [1, 2, 3])
def test_candidates_equal_the_reference(max_cols):
    """enumerate_candidates gives the reference's candidates in its order,
    with the statistics the callback returns."""
    cols = [frozenset(c) for c in ({"a", "b", "c"}, {"c", "d"}, {"e"},
                                   {"a", "d", "e", "b"})]

    def stats(phi):
        return (float(len(phi) * 100 + ord(min(phi))), float(len(phi)), 3.0)
    got = opt.enumerate_candidates(
        [QueryTemplate(c, 0.25) for c in cols], stats, max_cols)
    want = ref_opt.enumerate_candidates(
        [ref_types.QueryTemplate(c, 0.25) for c in cols], stats, max_cols)
    assert [(c.phi, c.storage, c.n_distinct, c.delta) for c in got] == \
        [(c.phi, c.storage, c.n_distinct, c.delta) for c in want]
