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
    [ROOT / "chip_smoke.py", ROOT / "kernel_times.py",
     ROOT / "compare_answers.py", ROOT / "lm_train_times.py"]
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
        "import repro_torch.core.maintenance, repro_torch.obs.metrics\n"
        "from repro_torch.core import estimators, executor, joins\n"
        "import repro_torch.fault, repro_torch.fault.inject\n"
        "import repro_torch.fault.supervisor, repro_torch.sharding\n"
        "import repro_torch.sharding.placement, repro_torch.service\n"
        "import repro_torch.service.parser, repro_torch.service.cache\n"
        "import repro_torch.service.workload, repro_torch.service.scheduler\n"
        "import repro_torch.obs, repro_torch.obs.trace\n"
        "import repro_torch.launch.roofline, repro_torch.launch.mesh\n"
        "import repro_torch.configs, repro_torch.configs.base\n"
        "import repro_torch.models.common, repro_torch.models.mlp\n"
        "import repro_torch.models.attention, repro_torch.models.model\n"
        "import repro_torch.models.mamba, repro_torch.models.xlstm\n"
        "import repro_torch.checkpoint.ckpt, repro_torch.train.step\n"
        "import repro_torch.serve.engine, repro_torch.launch.serve\n"
        "import repro_torch.data.tokens, repro_torch.train.optim\n"
        "import repro_torch.train.loop, repro_torch.launch.train\n"
        "import repro_torch.sharding.rules, repro_torch.sharding.lm\n"
        "import repro_torch.launch.cells, repro_torch.launch.dryrun\n"
        "for arch in repro_torch.configs.all_archs():\n"
        "    repro_torch.configs.get_config(arch)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'repro')\n"
        "       or m.startswith(('jax.', 'repro.'))]\n"
        "assert not bad, bad\n"
        "for name in ('make_quantile_fn', 'make_batched_query_fn',\n"
        "             'hist_to_quantile', 'grouped_quantile'):\n"
        "    assert hasattr(executor, name), name\n"
        "assert hasattr(ref, 'quantile_scan_ref')\n"
        "assert hasattr(repro_torch.kernels.ops, 'quantile_scan')\n"
        "from repro_torch.core.engine import BlinkDB\n"
        "for name in ('append_rows', 'delete_rows', 'update_rows',\n"
        "             'compact_family', 'compact_table', 'decay_family',\n"
        "             'storage_stats', 'family_set_generation',\n"
        "             'add_invalidation_listener'):\n"
        "    assert hasattr(BlinkDB, name), name\n"
        "assert hasattr(repro_torch.core.maintenance, 'SampleMaintainer')\n"
        "for name in ('run_sharded_scan', 'shard_valid_mask',\n"
        "             'shard_of_strata', 'merge_shard_reports'):\n"
        "    assert hasattr(executor, name), name\n"
        "for name in ('reweight_moments', 'moments_finite'):\n"
        "    assert hasattr(estimators, name), name\n"
        "for name in ('mark_hot_family', '_fault_sharding_active'):\n"
        "    assert hasattr(BlinkDB, name), name\n"
        "assert hasattr(repro_torch.service, 'BlinkQLService')\n"
        "assert hasattr(repro_torch.obs, 'QueryTrace')\n"
        "assert hasattr(repro_torch.fault, 'FaultPlan')\n"
        "assert hasattr(repro_torch.sharding.placement, 'PlacementMap')\n"
        "assert hasattr(repro_torch.launch.roofline, 'scan_bytes_per_row')\n"
        "# the card's peaks, not the reference's TPU's (819e9 B/s HBM)\n"
        "assert repro_torch.launch.roofline.HBM_BW == 3.35e12\n"
        "assert repro_torch.launch.roofline.PEAK_FLOPS == 989.4e12\n"
        "for name in ('count_flops', 'step_flops', 'StepCost', 'Roofline',\n"
        "             'scan_hbm_seconds', 'extrapolate'):\n"
        "    assert hasattr(repro_torch.launch.roofline, name), name\n"
        "assert hasattr(repro_torch.sharding.lm, 'DryComm')\n"
        "assert hasattr(repro_torch.state, 'lm_params_from_reference')\n"
        "for name in ('DecoderLM', 'init_params', 'init_cache', 'forward',\n"
        "             'prefill', 'decode_step', 'loss_fn'):\n"
        "    assert hasattr(repro_torch.models.model, name), name\n"
        "for name in ('OptConfig', 'schedule', 'quantize_i8',\n"
        "             'dequantize_i8', 'init_opt_state', 'global_norm',\n"
        "             'adamw_update'):\n"
        "    assert hasattr(repro_torch.train.optim, name), name\n"
        "for name in ('StepConfig', 'make_train_step', 'make_decode_step',\n"
        "             'make_prefill_step'):\n"
        "    assert hasattr(repro_torch.train.step, name), name\n"
        "for name in ('LoopConfig', 'Telemetry', 'train'):\n"
        "    assert hasattr(repro_torch.train.loop, name), name\n"
        "assert hasattr(repro_torch.state, 'opt_state_from_reference')\n"
        "assert hasattr(repro_torch.models.common, 'cross_entropy')\n"
        "for name in ('make_host_mesh', 'run_ranks', 'process_group',\n"
        "             'session_rank', 'run_session', 'held_to_plain'):\n"
        "    assert hasattr(repro_torch.launch.mesh, name), name\n"
        "for name in ('mesh_axes', 'merge_partials', 'agree_max'):\n"
        "    assert hasattr(executor, name), name\n"
        "# importing starts no process group\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "# importing builds no kernel: nvcc runs at a kernel's first launch\n"
        "assert all(lib.handle is None for lib in agg_scan.LIBRARIES.values())\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_no_port_file_imports_jax_or_reference():
    assert len(PORT_FILES) > 10
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for sub in ("fault/inject.py", "fault/supervisor.py",
                "sharding/placement.py", "service/parser.py",
                "service/cache.py", "service/workload.py",
                "service/scheduler.py", "obs/trace.py",
                "launch/roofline.py", "launch/mesh.py", "configs/base.py",
                "configs/qwen2_1_5b.py", "models/common.py", "models/mlp.py",
                "models/attention.py", "models/model.py",
                "checkpoint/ckpt.py", "train/step.py", "serve/engine.py",
                "launch/serve.py", "data/tokens.py", "train/optim.py",
                "train/loop.py", "launch/train.py"):
        assert f"src/repro_torch/{sub}" in names, sub
    assert ROOT / "examples" / "torch_serve_lm.py" in PORT_FILES
    assert ROOT / "examples" / "torch_train_lm.py" in PORT_FILES
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
