"""The port stands alone: `repro_torch` and chip_smoke.py never import jax
or the reference package `repro` (only the tests import both)."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)\b(?!_))", re.M)


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.core.engine\n"
        "import repro_torch.state, repro_torch.kernels.ops\n"
        "import repro_torch.data.synth\n"
        "bad = [m for m in sys.modules if m in ('jax', 'repro')\n"
        "       or m.startswith(('jax.', 'repro.'))]\n"
        "assert not bad, bad\n")
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
