"""The port stands alone: `repro_torch` and chip_smoke.py never import jax
or the reference package `repro` (only the tests import both)."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    sorted((ROOT / "examples").glob("torch_*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "kernel_times.py"]
_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)\b(?!_))", re.M)


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "from repro_torch.kernels import agg_scan, ref  # first, as chip_smoke\n"
        "import repro_torch, repro_torch.core, repro_torch.core.engine\n"
        "import repro_torch.state, repro_torch.kernels.ops\n"
        "import repro_torch.data.synth, repro_torch.core.optimizer\n"
        "import repro_torch.launch.query, repro_torch.obs.clock\n"
        "from repro_torch.core import estimators, executor\n"
        "bad = [m for m in sys.modules if m in ('jax', 'repro')\n"
        "       or m.startswith(('jax.', 'repro.'))]\n"
        "assert not bad, bad\n"
        "for name in ('make_quantile_fn', 'make_batched_query_fn',\n"
        "             'hist_to_quantile', 'grouped_quantile'):\n"
        "    assert hasattr(executor, name), name\n"
        "assert hasattr(ref, 'quantile_scan_ref')\n"
        "assert hasattr(repro_torch.kernels.ops, 'quantile_scan')\n"
        "# importing builds no kernel: nvcc runs at a kernel's first launch\n"
        "assert all(lib.handle is None for lib in agg_scan.LIBRARIES.values())\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_no_port_file_imports_jax_or_reference():
    assert len(PORT_FILES) > 10
    for path in PORT_FILES:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def test_forbidden_pattern_is_word_bounded():
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from repro.core import table")
    assert _FORBIDDEN.search("    import repro")
    assert not _FORBIDDEN.search("from repro_torch.core import table")
    assert not _FORBIDDEN.search("import repro_torch")
    assert not _FORBIDDEN.search("# jax and repro are the reference")


def test_kernel_sources_share_one_header_and_a_plain_c_interface():
    """Each kernel library is one .cu source that includes the shared
    scan_common.cuh and exports its launcher with C linkage; none includes
    PyTorch's headers (ctypes binds it)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import agg_scan
    for lib in agg_scan.LIBRARIES.values():
        text = lib.source.read_text()
        assert '#include "scan_common.cuh"' in text, lib.source.name
        assert f'extern "C" int {lib.symbol}(' in text, lib.source.name
        assert "torch/" not in text and "torch/" not in \
            agg_scan.HEADER.read_text()
