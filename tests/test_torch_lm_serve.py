"""The port's serving path against the reference's on the CPU:
`ServeEngine.generate`, the serve step factories, `CheckpointManager`
(either package's checkpoints restore into the other) and
`python -m repro_torch.launch.serve`.

The dense archs, the two MoE archs (their capacity dropping in
prefill) and the two recurrent archs (xlstm-125m: mLSTM and sLSTM states;
jamba-v0.1-52b, one period of 8 layers: Mamba states beside a KV cache),
reduced. Weights are the reference's `init_params`, carried by
`repro_torch.state.lm_params_from_reference`. Under float32 compute both
engines' tokens are equal exactly; each engine gets a `StepConfig`
subclass, defined here, whose compute dtype is float32. The bfloat16
default is held to the reference's logits at rtol/atol 2e-2, the reference
compiled with XLA's excess precision off (see tests/test_torch_lm_model.py,
which also says why xlstm-125m takes the reference's cells there and
jamba-v0.1-52b is held in float32 only).
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro.serve import engine as ref_engine
from repro.train import step as ref_step
from repro_torch.checkpoint import ckpt as port_ckpt
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_launch
from repro_torch.models import attention as port_attn
from repro_torch.models import model as port_model
from repro_torch.serve import engine as port_engine
from repro_torch.state import lm_params_from_reference
from repro_torch.train import step as port_step

from lm_reference_cells import reference_cells

jax.config.update("jax_default_matmul_precision", "float32")

ROOT = Path(__file__).resolve().parents[1]
DENSE = ["qwen2-1.5b", "codeqwen1.5-7b", "mistral-large-123b", "llama3-405b"]
ARCHS = DENSE + ["granite-moe-3b-a800m", "qwen3-moe-235b-a22b",
                 "xlstm-125m", "jamba-v0.1-52b"]
B, P, NEW = 3, 16, 12
AS_WRITTEN = {"xla_allow_excess_precision": False}


@dataclasses.dataclass(frozen=True)
class RefF32Step(ref_step.StepConfig):
    @property
    def compute_dtype(self):
        return jnp.float32


@dataclasses.dataclass(frozen=True)
class PortF32Step(port_step.StepConfig):
    @property
    def compute_dtype(self):
        return torch.float32


def cfgs(arch):
    """Both configs, reduced to 2 layers (one period of a longer
    pattern)."""
    n = max(2, len(get_config(arch).pattern))
    ref = dataclasses.replace(ref_get_config(arch).reduced(), n_layers=n)
    port = dataclasses.replace(get_config(arch).reduced(), n_layers=n)
    return ref, port


@functools.lru_cache(maxsize=None)
def weights(arch, seed=3):
    ref_cfg, port_cfg = cfgs(arch)
    params, _ = ref_model.init_params(ref_cfg, jax.random.PRNGKey(seed))
    return params, port_from(port_cfg, jax.tree.map(np.asarray, params))


def port_from(cfg, params_np):
    model = port_model.empty(cfg, "cpu")
    model.load_state_dict(lm_params_from_reference(cfg, params_np, "cpu"),
                          assign=True)
    return model


def prompts(cfg, seed=5):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def ref_tokens_f32(arch):
    ref_cfg, _ = cfgs(arch)
    params, _ = weights(arch)
    eng = ref_engine.ServeEngine(ref_cfg, params, ref_engine.ServeConfig(),
                                 RefF32Step())
    return eng.generate(prompts(ref_cfg), NEW)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_equals_reference_token_for_token(arch):
    ref_cfg, port_cfg = cfgs(arch)
    _, model = weights(arch)
    eng = port_engine.ServeEngine(port_cfg, model,
                                  port_engine.ServeConfig(), PortF32Step())
    got = eng.generate(prompts(port_cfg), NEW)
    want = ref_tokens_f32(arch)
    assert got.dtype == np.int32 and got.shape == (B, P + NEW)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :P], prompts(port_cfg))


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "jamba-v0.1-52b"])
def test_bf16_default_logits_match_reference(arch):
    """The default StepConfig (bfloat16 compute) through both packages'
    serve step factories: prefill logits and the decode logits of a
    teacher-forced continuation, float32 caches as ServeConfig's default."""
    ref_cfg, port_cfg = cfgs(arch)
    params, model = weights(arch)
    toks = np.concatenate([prompts(ref_cfg), prompts(ref_cfg, 6)[:, :4]], 1)
    jt = jnp.asarray(toks)
    rc = ref_model.init_cache(ref_cfg, B, P + 4, dtype=jnp.float32)
    pre = jax.jit(ref_step.make_prefill_step(ref_cfg)).lower(
        params, jt[:, :P], rc).compile(compiler_options=AS_WRITTEN)
    logits, rc = pre(params, jt[:, :P], rc)
    dec = jax.jit(lambda p, t, c, pos: ref_model.forward(
        p, ref_cfg, t, "decode", caches=c, pos=pos)[:2]).lower(
            params, jt[:, :1], rc, jnp.int32(0)).compile(
                compiler_options=AS_WRITTEN)
    want = [np.asarray(logits.astype(jnp.float32))]
    for t in range(P, P + 3):
        lg, rc = dec(params, jt[:, t:t + 1], rc, jnp.int32(t))
        want.append(np.asarray(lg.astype(jnp.float32)))

    tc = port_model.init_cache(port_cfg, B, P + 4, dtype=torch.float32,
                               device="cpu")
    tt = torch.from_numpy(toks)
    with reference_cells(arch == "xlstm-125m"):
        logits, tc = port_step.make_prefill_step(port_cfg)(model, tt[:, :P],
                                                           tc)
        assert logits.dtype == torch.bfloat16
        got = [logits.float().numpy()]
        for t in range(P, P + 3):
            lg, tc, _ = port_model.forward(model, port_cfg, tt[:, t:t + 1],
                                           "decode", tc, t)
            got.append(lg.float().numpy())
    np.testing.assert_allclose(np.concatenate(got, 1),
                               np.concatenate(want, 1), rtol=2e-2, atol=2e-2)
    # the port's decode step factory: next tokens, int32 [B, 1]
    nxt, _ = port_step.make_decode_step(port_cfg)(
        model, tt[:, P + 3:P + 4], tc, P + 3)
    assert nxt.dtype == torch.int32 and nxt.shape == (B, 1)


def test_bf16_generate_runs_and_repeats():
    _, port_cfg = cfgs("qwen2-1.5b")
    _, model = weights("qwen2-1.5b")
    for cache_dtype in ("float32", "bfloat16"):
        eng = port_engine.ServeEngine(
            port_cfg, model, port_engine.ServeConfig(cache_dtype=cache_dtype))
        a = eng.generate(prompts(port_cfg), NEW)
        b = eng.generate(prompts(port_cfg), NEW)
        np.testing.assert_array_equal(a, b)
        assert a.min() >= 0 and a.max() < port_cfg.vocab_size
    stats = port_engine.throughput_probe(eng, prompts(port_cfg), 4)
    assert stats["tokens"] == B * 4 and stats["output_shape"] == (B, P + 4)
    assert stats["tok_per_s"] > 0


# ------------------------------------------------------------ checkpoints

def test_reference_checkpoint_restores_into_the_port(tmp_path):
    ref_cfg, port_cfg = cfgs("codeqwen1.5-7b")
    params, _ = ref_model.init_params(ref_cfg, jax.random.PRNGKey(9))
    mgr = ref_ckpt.CheckpointManager(str(tmp_path), keep=2)
    mgr.save(40, {"params": params})
    mgr.wait()

    port = port_from(port_cfg, jax.tree.map(np.asarray, params))
    fresh = port_model.init_params(port_cfg, torch.Generator().manual_seed(1))
    pm = port_ckpt.CheckpointManager(str(tmp_path))
    assert pm.all_steps() == [40] and pm.latest_step() == 40
    step, state = pm.restore({"params": fresh.param_tree()})
    assert step == 40
    fresh.load_state_dict(lm_params_from_reference(port_cfg, state["params"],
                                                   "cpu"), assign=True)
    for (name, a), (_, b) in zip(port.named_parameters(),
                                 fresh.named_parameters()):
        assert torch.equal(a, b), name

    want = ref_engine.ServeEngine(ref_cfg, params, ref_engine.ServeConfig(),
                                  RefF32Step()).generate(prompts(ref_cfg), NEW)
    got = port_engine.ServeEngine(port_cfg, fresh, port_engine.ServeConfig(),
                                  PortF32Step()).generate(prompts(port_cfg),
                                                          NEW)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("async_save", [True, False])
def test_port_save_restore_round_trip_and_gc(tmp_path, async_save):
    _, port_cfg = cfgs("mistral-large-123b")
    _, model = weights("mistral-large-123b")
    mgr = port_ckpt.CheckpointManager(str(tmp_path), keep=2,
                                      async_save=async_save)
    for step in (1, 2, 3, 5):
        mgr.save(step, {"params": model.param_tree(),
                        "data": {"epoch": np.int64(step)}},
                 extra_meta={"arch": port_cfg.name})
    mgr.wait()
    assert mgr.all_steps() == [3, 5] and mgr.latest_step() == 5
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    like = {"params": model.param_tree(), "data": {"epoch": 0}}
    step, state = mgr.restore(like)
    assert step == 5 and int(state["data"]["epoch"]) == 5
    _, older = mgr.restore(like, step=3)
    assert int(older["data"]["epoch"]) == 3
    restored = port_from(port_cfg, state["params"])
    for (name, a), (_, b) in zip(model.named_parameters(),
                                 restored.named_parameters()):
        assert torch.equal(a, b), name
    # the reference restores the port's checkpoint too
    ref_params, _ = weights("mistral-large-123b")
    _, ref_state = ref_ckpt.CheckpointManager(str(tmp_path)).restore(
        {"params": ref_params})
    for (name, a), (_, b) in zip(
            port_ckpt.flatten_with_paths(jax.tree.map(np.asarray,
                                                      ref_state["params"])),
            port_ckpt.flatten_with_paths(model.param_tree())):
        np.testing.assert_array_equal(a, b.detach().numpy(), err_msg=name)


def test_restore_of_an_empty_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        port_ckpt.CheckpointManager(str(tmp_path / "none")).restore({"a": 0})


def test_async_save_error_surfaces_in_wait(tmp_path, monkeypatch):
    def fail(*_a, **_k):
        raise OSError("disk full")
    monkeypatch.setattr(port_ckpt.np, "save", fail)
    mgr = port_ckpt.CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, {"w": torch.ones(3)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.all_steps() == []
    mgr.wait()   # raised once


def test_leaf_names_are_jax_tree_paths():
    tree = {"b": (np.ones(2), [np.zeros(1), None]), "a": {"z": 1.0, "y": 2},
            "c": port_attn.KVCache(np.ones(1), np.zeros(1))}
    jtree = dict(tree, c=ref_model.attn_lib.KVCache(np.ones(1), np.zeros(1)))
    want = [(n, np.asarray(v)) for n, v in ref_ckpt._flatten_with_paths(jtree)]
    got = port_ckpt.flatten_with_paths(tree)
    assert [n for n, _ in got] == [n for n, _ in want]
    assert [n for n, _ in got] == ["a/y", "a/z", "b/0", "b/1/0", "c/k", "c/v"]
    back = port_ckpt.map_leaves(lambda x: x, tree)
    assert isinstance(back["c"], port_attn.KVCache)
    assert isinstance(back["b"], tuple) and back["b"][1][1] is None


# ------------------------------------------------------------ the launcher

def test_launch_serve_on_the_cpu_exits_zero():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--batch", "2", "--prompt-len", "8",
         "--new-tokens", "6"],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "[serve] 12 tokens in" in proc.stdout
    assert "output (2, 14) on cpu" in proc.stdout


def test_launch_serve_restores_a_reference_checkpoint(tmp_path, capsys):
    ref_cfg = ref_get_config("qwen2-1.5b").reduced()
    params, _ = ref_model.init_params(ref_cfg, jax.random.PRNGKey(2))
    mgr = ref_ckpt.CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(7, {"params": params})
    serve_launch.main(["--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--new-tokens", "3",
                       "--ckpt-dir", str(tmp_path)])
    assert "[serve] 6 tokens in" in capsys.readouterr().out


def test_launch_serve_runs_on_the_card_by_default():
    """Without --device the launcher asks for the card and, without one,
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launcher would run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_launch.main(["--reduced", "--batch", "1", "--prompt-len", "4",
                           "--new-tokens", "2"])
