"""The host side of the agg_scan wrapper (kernels/agg_scan.py agg_scan_cuda),
which needs no card: its cached launch plan, the constants it shares with
csrc/agg_scan.cu, the shared memory of the one-launch kernel, and the
per-stream scratch."""
import re
import struct

import pytest
import torch

from repro_torch.kernels import agg_scan

SOURCE = agg_scan.LIBRARIES["agg_scan"].source


def _constants(path) -> dict:
    """The `constexpr int kName = value;` constants of a kernel source."""
    return {m[0]: int(m[1]) for m in
            re.findall(r"constexpr int (k\w+) = (\d+);", path.read_text())}


PLANS = [(0, 1), (1, 1), (4099, 6), (100_003, 6), (6_481_472, 1),
         (10_195_008, 6), (10_195_008, 8), (12_504_640, 9),
         (100_003, 600), (50_000_000, 3)]


@pytest.mark.parametrize("n, g", PLANS)
@pytest.mark.parametrize("n_sms", [132, 114])
def test_agg_scan_plan_is_launch_plan_at_one_query(n, g, n_sms):
    """The wrapper's cached plan is launch_plan(n, 1, G, card), the plan
    of every scan pass at any Q: it depends on (n, G, card) only, so
    agg_scan keeps the fused and quantile kernels' order of sums."""
    plan = agg_scan.agg_scan_plan(n, g, n_sms)
    assert plan == agg_scan.launch_plan(n, 1, g, n_sms)[:3]
    for q in (7, 64):
        assert agg_scan.launch_plan(n, q, g, n_sms)[:3] == plan
    assert agg_scan.agg_scan_plan(n, g, n_sms) is plan      # kept, not redone


@pytest.mark.parametrize("n, g", PLANS)
@pytest.mark.parametrize("n_sms", [132, 114])
def test_agg_scan_chunks_are_whole_stages(n, g, n_sms):
    """The one-launch kernel takes a chunk in stages of kStageRows rows
    and refuses a plan whose chunks are not whole stages: every plan's
    chunks are."""
    c = _constants(SOURCE)
    rows, chunks, _ = agg_scan.agg_scan_plan(n, g, n_sms)
    assert rows % c["kStageRows"] == 0
    assert rows * chunks >= n


def test_agg_scan_constants_match_the_kernel_source():
    c = _constants(SOURCE)
    assert c["kStagedGroups"] == agg_scan._STAGED_GROUPS
    fast_min = re.search(r"constexpr float kFastMin = (0x[0-9a-fp.+-]+)f;",
                         SOURCE.read_text())[1]
    assert agg_scan.FAST_RATE_BITS == (
        struct.unpack("<I", struct.pack("<f", float.fromhex(fast_min)))[0],
        struct.unpack("<I", struct.pack("<f", 1.0))[0])
    assert c["kStageRows"] % 256 == 0 and c["kStageRows"] % 16 == 0
    assert 0 < c["kColGroups"] <= c["kStagedGroups"]


@pytest.mark.parametrize("g", range(1, 9))
@pytest.mark.parametrize("counting", [True, False])
def test_agg_scan_one_launch_fits_shared_memory(g, counting):
    """The ring of the widest columns (f32 values, int32 codes: 13 B a
    row) plus the sums' columns (one float4 a group and thread for a
    COUNT, two with values, G + 1 groups) fit a block's dynamic shared
    memory."""
    c = _constants(SOURCE)
    ring = c["kStages"] * c["kStageRows"] * (4 + 4 + 4 + 1)
    cols = ((1 if counting else 2) * (g + 1) * 256 * 16
            if g >= c["kColGroups"] else 0)
    assert ring + cols <= agg_scan.MAX_SHARED


def test_agg_scan_scratch_is_kept_per_stream():
    """One zeroed scratch buffer per (device, stream): a repeat call on a
    stream gets the same buffer, a larger need a new one, another stream
    its own."""
    cpu = torch.device("cpu")
    keys = [(cpu.index, s) for s in (-101, -102)]
    try:
        a = agg_scan._agg_scan_scratch(cpu, -101, 100)
        assert a.dtype == torch.int32 and a.numel() * 4 >= 100
        assert not a.any()
        assert agg_scan._agg_scan_scratch(cpu, -101, 64) is a
        b = agg_scan._agg_scan_scratch(cpu, -102, 100)
        assert b is not a
        bigger = agg_scan._agg_scan_scratch(cpu, -101, 4000)
        assert bigger is not a and bigger.numel() * 4 >= 4000
        assert agg_scan._agg_scan_scratch(cpu, -101, 100) is bigger
    finally:
        for key in keys:
            agg_scan._SCRATCH.pop(key, None)


def test_agg_scan_cuda_refuses_cpu_tensors_without_a_launch():
    args = (torch.ones(10), torch.ones(10), torch.ones(10, dtype=torch.bool),
            torch.zeros(10, dtype=torch.int8))
    before = agg_scan.agg_scan_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        agg_scan.agg_scan_cuda(*args, 6)
    assert agg_scan.agg_scan_cuda.launches == before
