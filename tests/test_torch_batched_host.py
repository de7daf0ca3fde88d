"""The host side of the agg_scan_batched wrapper (kernels/agg_scan.py
agg_scan_batched_cuda), which needs no card: how it splits the queries
into launches and places them in its output, the plan and scratch each
launch takes, its cached template descriptor, the constants it shares
with csrc/agg_scan_batched.cu, and the arguments it refuses."""
import re

import pytest
import torch

from repro_torch.core.types import CmpOp
from repro_torch.kernels import agg_scan

SOURCE = agg_scan.LIBRARIES["agg_scan_batched"].source


def _constants() -> dict:
    return {m[0]: int(m[1]) for m in
            re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE.read_text())}


@pytest.mark.parametrize("n, g, n_sms", [(0, 1, 132), (4099, 6, 132),
                                         (10_195_008, 6, 132),
                                         (10_195_008, 8, 114),
                                         (12_504_640, 9, 132)])
def test_batched_launches_take_one_plan_for_any_query_count(n, g, n_sms):
    """For Q = 1..130 the launches tile [0, Q) in order, at most 64 a
    launch, and each takes agg_scan_plan(n, G, card): the chunking, and
    so a query's order of sums, never depends on Q. The scratch of the
    largest launch holds every launch's bits and partials."""
    plan = agg_scan.agg_scan_plan(n, g, n_sms)
    rows, chunks, _ = plan
    assert rows % 1024 == 0 and rows * chunks >= n
    for q_all in range(1, 131):
        launches = agg_scan.batched_launches(q_all)
        assert [q0 for q0, _ in launches] == list(range(0, q_all, 64))
        assert sum(q for _, q in launches) == q_all
        assert all(1 <= q <= agg_scan.MAX_QUERIES for _, q in launches)
        for _, q in launches:
            assert agg_scan.launch_plan(n, q, g, n_sms)[:3] == plan
        bits, partial = agg_scan.batched_scratch(
            min(q_all, agg_scan.MAX_QUERIES), g, rows, chunks)
        for _, q in launches:
            b, p = agg_scan.batched_scratch(q, g, rows, chunks)
            assert b <= bits and p <= partial
        # one bit per (query, row), windows of 32 rows of a thread
        # rounded up: at most 32 × 256 rows a chunk of padding
        per_q = -(-rows // 8192) * 8192 // 8 * chunks
        assert bits == (min(q_all, 64) * per_q if g <= 8 else 0)
        assert bits % 16 == 0               # the partials start aligned


@pytest.mark.parametrize("g", [1, 6, 500])
def test_batched_launch_outputs_stay_inside_out(g):
    """Each launch writes out[q0 : q0 + q] of the call's f32[Q, 7, G]: the
    slices are disjoint, cover the output, and no query slot past Q is
    ever written (the launches carry no padded queries)."""
    for q_all in range(1, 131):
        written = torch.zeros(q_all * 7 * g, dtype=torch.int32)
        for q0, q in agg_scan.batched_launches(q_all):
            start = q0 * 7 * g
            assert start + q * 7 * g <= written.numel()
            written[start:start + q * 7 * g] += 1
        assert bool((written == 1).all())


def test_batched_template_is_kept_per_template():
    """A repeat call reuses its template's packed descriptor; two templates
    of one shape (one atom, other compares) each get their own."""
    eq = agg_scan.batched_template(((CmpOp.EQ,),))
    assert agg_scan.batched_template(((CmpOp.EQ,),)) is eq
    ne = agg_scan.batched_template(((CmpOp.NE,),))
    assert ne is not eq
    ops = {}
    for key, (args, keep) in (("eq", eq), ("ne", ne)):
        n_atoms = args[1]
        assert n_atoms == 1 and len(args) == 7
        ops[key] = list(keep[3][:n_atoms])
    assert ops["eq"] != ops["ne"]
    two = agg_scan.batched_template(((CmpOp.GE, CmpOp.LT), (CmpOp.EQ,)))
    assert list(two[1][4][:2]) == [2, 3]       # conjunction ends


def test_batched_constants_match_the_kernel_source():
    c = _constants()
    assert c["kSelGroups"] == agg_scan._SEL_GROUPS
    assert "kColStride = scan::kThreads + 1;" in SOURCE.read_text()
    header = {m[0]: int(m[1]) for m in re.findall(
        r"constexpr int (k\w+) = (\d+);", agg_scan.HEADER.read_text())}
    assert header["kMaxQ"] == agg_scan.MAX_QUERIES


@pytest.mark.parametrize("g", range(1, 9))
def test_batched_sums_fit_shared_memory(g):
    """masked_moments keeps 7 × G sum columns of 257 floats a block (one a
    thread, and one spare so that a lane reading a warp's 32 columns hits
    32 banks), plus the 8 warps' sums: under a block's limit."""
    assert 7 * g * 257 * 4 + 8 * 7 * g * 4 <= agg_scan.MAX_SHARED


def _args(n=64, a=1, q=3, g=6):
    return dict(values=torch.ones(n), freq=torch.ones(n),
                entry_key=torch.ones(n), atom_cols=torch.zeros((a, n)),
                group_codes=torch.zeros(n, dtype=torch.int8),
                ks=torch.ones(q), pred_consts=torch.zeros((q, a)),
                ops_struct=((CmpOp.EQ,) * a,) if a else (), n_groups=g)


def _with(**changes):
    kw = _args()
    kw.update(changes)
    return kw


REFUSED = {
    "128 atoms": (_args(a=128), "atoms"),
    "129 conjunctions": (_with(ops_struct=((),) * 129,
                               atom_cols=torch.zeros((0, 64)),
                               pred_consts=torch.zeros((3, 0))),
                         "conjunctions"),
    "atom rows of another length": (_with(atom_cols=torch.zeros((1, 63))),
                                    "atom_cols"),
    "no queries": (_with(ks=torch.ones(0), pred_consts=torch.zeros((0, 1))),
                   "ks"),
    "consts of another shape": (_with(pred_consts=torch.zeros((2, 1))),
                                "pred_consts"),
    "freq float64": (_with(freq=torch.ones(64, dtype=torch.float64)),
                     "float32"),
    "values float64": (_with(values=torch.ones(64, dtype=torch.float64)),
                       "values dtype"),
    "float group codes": (_with(group_codes=torch.zeros(64)), "group codes"),
    "entry_key of another length": (_with(entry_key=torch.ones(65)),
                                    "entry_key"),
    "no groups": (_with(n_groups=0), "n_groups"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_check_batched_args_refuses(case):
    kw, match = REFUSED[case]
    with pytest.raises(ValueError, match=match):
        agg_scan.check_batched_args(**kw)


def test_check_batched_args_takes_any_query_count():
    for q in (1, 64, 65, 130):
        agg_scan.check_batched_args(**_args(q=q))


def test_agg_scan_batched_cuda_refuses_cpu_tensors_without_a_launch():
    before = agg_scan.agg_scan_batched_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        agg_scan.agg_scan_batched_cuda(**_args())
    assert agg_scan.agg_scan_batched_cuda.launches == before
