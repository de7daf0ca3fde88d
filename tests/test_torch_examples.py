"""The port's examples and its query driver run end to end on the CPU at a
small row count (they run on the card unless asked for the CPU), and say
what they chose and answered."""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.launch import query as query_launch

ROOT = Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name, markers", [
    ("torch_quickstart", ["chosen families:", "Q1 COUNT by OS",
                          "Q2 AVG(SessionTime) WITHIN 5ms",
                          "Q1 true relative errors"]),
    ("torch_approx_analytics", ["eps= 0.02", "COUNT(os0 OR os5)",
                                "p95(SessionTime)", "rare city"]),
])
def test_example_runs_on_the_cpu(capsys, name, markers):
    _example(name).main(["--device", "cpu", "--rows", "40000"])
    out = capsys.readouterr().out
    for m in markers:
        assert m in out, (m, out)


def test_query_driver_runs_on_the_cpu(capsys):
    query_launch.main(["--device", "cpu", "--rows", "40000", "--k1", "600"])
    out = capsys.readouterr().out
    assert "families:" in out
    for name, _ in query_launch.queries(None):
        assert name in out


def test_query_driver_time_bound(capsys):
    query_launch.main(["--device", "cpu", "--rows", "20000",
                       "--time-bound-ms", "50"])
    assert "p50 latency" in capsys.readouterr().out


@pytest.mark.parametrize("run", [
    lambda: _example("torch_quickstart").main(["--rows", "1000"]),
    lambda: _example("torch_approx_analytics").main(["--rows", "1000"]),
    lambda: query_launch.main(["--rows", "1000"]),
])
def test_entry_points_run_on_the_card_by_default(run):
    """Without --device each entry point asks for the card, and without
    one it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run()
