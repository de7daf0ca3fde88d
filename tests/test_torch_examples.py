"""The port's examples and its query driver run end to end on the CPU at a
small row count (they run on the card unless asked for the CPU), and say
what they chose and answered."""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.launch import query as query_launch
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch

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
    ("torch_telemetry_queries", ["per-domain AVG(loss) within 10%@95%",
                                 "late high-grad events", "EXPLAIN",
                                 "'hits': 1", "'healthy': True"]),
])
def test_example_runs_on_the_cpu(capsys, name, markers):
    size = (["--steps", "5000"] if name == "torch_telemetry_queries"
            else ["--rows", "40000"])
    _example(name).main(["--device", "cpu", *size])
    out = capsys.readouterr().out
    for m in markers:
        assert m in out, (m, out)


def test_serve_example_runs_on_the_cpu(capsys):
    _example("torch_serve_lm").main(["--device", "cpu"])
    out = capsys.readouterr().out
    lines = out.splitlines()
    for arch in ("qwen2-1.5b", "codeqwen1.5-7b", "xlstm-125m",
                 "jamba-v0.1-52b"):
        assert any(line.startswith(arch) and "out=(4, 40)  on cpu" in line
                   for line in lines), out
    assert any(line.startswith("musicgen-large") and
               "out=(4, 4, 40)  on cpu" in line for line in lines), out


def test_train_example_runs_on_the_cpu(capsys, tmp_path):
    _example("torch_train_lm").main(["--device", "cpu", "--steps", "5",
                                     "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[train_lm] qwen2-25m: 12.0M params, 5 steps of batch 8 x seq " \
        "128 on cpu" in out, out
    assert "[train_lm] loss " in out.strip().splitlines()[-1], out


def test_telemetry_example_queries_the_trainers_own_telemetry(capsys):
    """--train-steps N: the table is the port trainer's Telemetry (one
    record per step and domain of the batch), asked the same BlinkQL."""
    _example("torch_telemetry_queries").main(["--device", "cpu",
                                              "--train-steps", "12"])
    out = capsys.readouterr().out
    assert "[loop] step 0 loss " in out and "[loop] step 6 loss " in out, out
    n = int(out.split("[telemetry] ")[1].split(" records")[0])
    assert 12 < n <= 12 * 8, out
    for m in ["per-domain AVG(loss) within 10%@95%", "EXPLAIN", "'hits': 1",
              "'healthy': True"]:
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
    lambda: _example("torch_telemetry_queries").main(["--steps", "200"]),
    lambda: query_launch.main(["--rows", "1000"]),
    lambda: _example("torch_serve_lm").main([]),
    lambda: serve_launch.main(["--reduced", "--new-tokens", "2"]),
    lambda: _example("torch_train_lm").main(["--steps", "1"]),
    lambda: _example("torch_telemetry_queries").main(["--train-steps", "2"]),
    lambda: train_launch.main(["--reduced", "--steps", "1"]),
])
def test_entry_points_run_on_the_card_by_default(run):
    """Without --device each entry point asks for the card, and without
    one it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run()
