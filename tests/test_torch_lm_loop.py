"""The port's token stream and training loop (`repro_torch.data.tokens`,
`repro_torch.train.loop`, `repro_torch.launch.train`) on the CPU: batches
equal to the reference's bit for bit over steps, shards and a restore; a
checkpoint written by the reference's loop (params, opt, data) resumed by
the port's, whose next step matches the reference's next step (float32
compute: loss and grad_norm rtol 1e-5, the parameters after it within
rtol 1e-4 and an atol of 1e-5; for granite-moe-3b-a800m under the lowmem
policy, bfloat16 parameters and int8 moments, the router's last axis of 8
padded to a block of 128: the loss rtol 1e-5, grad_norm rtol 1e-4 (the
gradients of bfloat16 parameters are rounded to bfloat16 in both, after
float32 sums in another order) and the bfloat16 parameters within rtol
1e-2 / atol 1e-3, as the train step's test holds them); a port run stopped after a checkpoint and
resumed equal to an uninterrupted one (bit for bit on the CPU); a
non-finite loss leaving the state untouched and raising after the
retries; and launch.train as a user runs it.
"""
import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data import tokens as ref_tokens
from repro.models import model as ref_model
from repro.train import loop as ref_loop
from repro.train import optim as ref_optim
from repro.train import step as ref_step
from repro_torch.checkpoint.ckpt import flatten_with_paths
from repro_torch.configs import get_config
from repro_torch.data import tokens as port_tokens
from repro_torch.launch import train as train_launch
from repro_torch.models import model as port_model
from repro_torch.train import loop as port_loop
from repro_torch.train import optim as port_optim
from repro_torch.train import step as port_step

jax.config.update("jax_default_matmul_precision", "float32")

ARCH = "qwen2-1.5b"
MOE_ARCH = "granite-moe-3b-a800m"
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=10)


def cfgs(arch=ARCH):
    ref = dataclasses.replace(ref_get_config(arch).reduced(), n_layers=3)
    port = dataclasses.replace(get_config(arch).reduced(), n_layers=3)
    return ref, port


def data_cfg(cfg, pkg):
    return pkg.DataConfig(cfg.vocab_size, 32, 4, seed=9)


class RefF32Step(ref_step.StepConfig):
    @property
    def compute_dtype(self):
        return jnp.float32


class PortF32Step(port_step.StepConfig):
    @property
    def compute_dtype(self):
        return torch.float32


# ------------------------------------------------------------ the stream

@pytest.mark.parametrize("shard, n_shards", [(0, 1), (1, 2), (3, 4)])
def test_token_stream_equals_the_reference_bit_for_bit(shard, n_shards):
    for vocab, seq in ((128, 32), (151_936, 17), (50, 8)):
        args = (vocab, seq, 8)
        ref = ref_tokens.SyntheticTokenStream(
            ref_tokens.DataConfig(*args, seed=4), shard, n_shards)
        port = port_tokens.SyntheticTokenStream(
            port_tokens.DataConfig(*args, seed=4), shard, n_shards)
        for _ in range(3):
            want, got = ref.next_batch(), port.next_batch()
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert port.state() == ref.state() == {"step": 3, "seed": 4}


def test_token_stream_restores_its_position_and_checks_its_seed():
    cfg = port_tokens.DataConfig(128, 16, 4, seed=2)
    ref_cfg = ref_tokens.DataConfig(128, 16, 4, seed=2)
    stream = port_tokens.SyntheticTokenStream(cfg)
    for _ in range(5):
        stream.next_batch()
    again = port_tokens.SyntheticTokenStream.restore(cfg, stream.state(), 1, 2)
    want = ref_tokens.SyntheticTokenStream.restore(
        ref_cfg, {"step": 5, "seed": 2}, 1, 2).next_batch()
    got = again.next_batch()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="seed"):
        port_tokens.SyntheticTokenStream.restore(
            cfg, {"step": 5, "seed": 3})
    with pytest.raises(ValueError, match="divisible"):
        port_tokens.SyntheticTokenStream(cfg, 0, 3)


# ------------------------------------------------------------ resume

def port_setup(cfg, seed=0, policy="f32"):
    step_cfg = PortF32Step(policy=policy)
    opt_cfg = port_optim.OptConfig(**OPT)
    model = port_model.init_params(cfg, torch.Generator().manual_seed(seed),
                                   step_cfg.param_dtype)
    opt = port_optim.init_opt_state(model.param_tree(),
                                    step_cfg.opt_config(opt_cfg))
    return model, opt, port_step.make_train_step(cfg, opt_cfg, step_cfg)


@functools.lru_cache(maxsize=None)
def reference_run(tmp_root, arch=ARCH, policy="f32"):
    """The reference's loop: 2 steps with a checkpoint after them, then a
    resumed run of 1 more step from a copy of that checkpoint. Returns the
    copy's directory, the resumed step's record and its parameters. Under
    the lowmem policy the reference's restore hands its bfloat16 leaves
    back as numpy void records ('V2'), which its jitted step does not
    take: the third step then comes from an uninterrupted 3-step run (a
    checkpoint holds the state exactly, so the two are the same step)."""
    ref_cfg, _ = cfgs(arch)
    opt_cfg = ref_optim.OptConfig(**OPT)
    step_cfg = RefF32Step(policy=policy)
    # Drawn in float32, then cast: the reference's init_params(dtype=
    # bfloat16) leaves the leaves of a numpy-scalar scale in float32.
    params = jax.jit(lambda k: jax.tree.map(
        lambda x: x.astype(step_cfg.param_dtype),
        ref_model.init_params(ref_cfg, k)[0]))(jax.random.PRNGKey(3))
    opt = ref_optim.init_opt_state(params, step_cfg.opt_config(opt_cfg))
    step_fn = jax.jit(ref_step.make_train_step(ref_cfg, opt_cfg, step_cfg))
    first = f"{tmp_root}/ref"
    ref_loop.train(step_fn, params, opt, ref_tokens.SyntheticTokenStream(
        data_cfg(ref_cfg, ref_tokens)), ref_loop.LoopConfig(
        total_steps=2, ckpt_every=2, log_every=100, ckpt_dir=first),
        resume=False)
    copy = f"{tmp_root}/for_port"
    shutil.copytree(first, copy)
    straight = policy == "lowmem"
    p3, _, tel = ref_loop.train(
        step_fn, params, opt, ref_tokens.SyntheticTokenStream(
            data_cfg(ref_cfg, ref_tokens)), ref_loop.LoopConfig(
            total_steps=3, ckpt_every=0, log_every=100,
            ckpt_dir=f"{tmp_root}/straight" if straight else first),
        resume=not straight)
    return (copy, [r for r in tel.records if r["step"] == 2],
            jax.tree.map(np.asarray, p3))


def test_a_reference_checkpoint_resumes_in_the_port(tmp_path_factory,
                                                    capsys):
    copy, want, want_params = reference_run(str(tmp_path_factory.mktemp("r")))
    _, cfg = cfgs()
    model, opt, step = port_setup(cfg, seed=1)   # overwritten by the restore
    _, opt, tel = port_loop.train(
        step, model, opt, port_tokens.SyntheticTokenStream(
            data_cfg(cfg, port_tokens)), port_loop.LoopConfig(
            total_steps=3, ckpt_every=0, log_every=100, ckpt_dir=copy))
    assert "[loop] resumed from step 2" in capsys.readouterr().out
    assert [r["step"] for r in tel.records] == [r["step"] for r in want]
    assert [r["domain"] for r in tel.records] == [r["domain"] for r in want]
    np.testing.assert_allclose([r["loss"] for r in tel.records],
                               [r["loss"] for r in want], rtol=1e-5)
    np.testing.assert_allclose([r["grad_norm"] for r in tel.records],
                               [r["grad_norm"] for r in want], rtol=1e-5)
    assert opt["step"].item() == 3
    for (path, p), (_, w) in zip(flatten_with_paths(model.param_tree()),
                                 flatten_with_paths(want_params)):
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-4,
                                   atol=1e-5, err_msg=path)


def test_a_reference_moe_checkpoint_with_int8_moments_resumes(
        tmp_path_factory, capsys):
    copy, want, want_params = reference_run(
        str(tmp_path_factory.mktemp("r")), MOE_ARCH, "lowmem")
    _, cfg = cfgs(MOE_ARCH)
    model, opt, step = port_setup(cfg, seed=1, policy="lowmem")
    assert opt["m"]["layers"][0]["moe"]["router"]["q"].shape[-1] == 8
    _, opt, tel = port_loop.train(
        step, model, opt, port_tokens.SyntheticTokenStream(
            data_cfg(cfg, port_tokens)), port_loop.LoopConfig(
            total_steps=3, ckpt_every=0, log_every=100, ckpt_dir=copy))
    assert "[loop] resumed from step 2" in capsys.readouterr().out
    assert [r["step"] for r in tel.records] == [r["step"] for r in want]
    np.testing.assert_allclose([r["loss"] for r in tel.records],
                               [r["loss"] for r in want], rtol=1e-5)
    np.testing.assert_allclose([r["grad_norm"] for r in tel.records],
                               [r["grad_norm"] for r in want], rtol=1e-4)
    assert opt["step"].item() == 3
    assert opt["v"]["layers"][0]["moe"]["wi"]["q"].dtype == torch.int8
    for (path, p), (_, w) in zip(flatten_with_paths(model.param_tree()),
                                 flatten_with_paths(want_params)):
        assert p.dtype == torch.bfloat16, path
        np.testing.assert_allclose(p.detach().float().numpy(),
                                   np.asarray(w, np.float32), rtol=1e-2,
                                   atol=1e-3, err_msg=path)


@pytest.mark.parametrize("policy", ["f32", "lowmem"])
def test_a_stopped_and_resumed_run_equals_an_uninterrupted_one(tmp_path,
                                                               policy):
    _, cfg = cfgs()
    step_cfg = port_step.StepConfig(policy=policy)
    opt_cfg = port_optim.OptConfig(**OPT)

    def run(total, ckpt_dir, ckpt_every):
        model = port_model.init_params(cfg, torch.Generator().manual_seed(0),
                                       step_cfg.param_dtype)
        opt = port_optim.init_opt_state(model.param_tree(),
                                        step_cfg.opt_config(opt_cfg))
        step = port_step.make_train_step(cfg, opt_cfg, step_cfg)
        return port_loop.train(step, model, opt,
                               port_tokens.SyntheticTokenStream(
                                   data_cfg(cfg, port_tokens)),
                               port_loop.LoopConfig(
                                   total_steps=total, ckpt_every=ckpt_every,
                                   log_every=100, ckpt_dir=str(ckpt_dir)))

    straight, s_opt, s_tel = run(4, tmp_path / "a", 0)
    run(2, tmp_path / "b", 2)                        # stopped after step 2
    resumed, r_opt, r_tel = run(4, tmp_path / "b", 0)
    assert [r["step"] for r in r_tel.records][0] == 2
    n = len(r_tel.records)
    assert r_tel.records == s_tel.records[-n:]
    for (path, a), (_, b) in zip(
            flatten_with_paths({"p": straight.param_tree(), "o": s_opt}),
            flatten_with_paths({"p": resumed.param_tree(), "o": r_opt})):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_a_non_finite_loss_leaves_the_state_and_raises_after_retries(
        tmp_path):
    _, cfg = cfgs()
    model, opt, step = port_setup(cfg)
    with torch.no_grad():
        model.final_norm[3] = float("nan")
    before = [t.clone() for _, t in flatten_with_paths(
        {"p": model.param_tree(), "o": opt})]
    calls = []

    def counted(*args):
        out = step(*args)
        calls.append(out[2]["loss"].item())
        return out
    with pytest.raises(RuntimeError, match="2 retries") as err:
        port_loop.train(counted, model, opt, port_tokens.SyntheticTokenStream(
            data_cfg(cfg, port_tokens)), port_loop.LoopConfig(
            total_steps=2, ckpt_every=0, ckpt_dir=str(tmp_path)))
    assert isinstance(err.value.__cause__, FloatingPointError)
    assert len(calls) == 3 and all(np.isnan(c) for c in calls)
    after = [t for _, t in flatten_with_paths({"p": model.param_tree(),
                                               "o": opt})]
    for a, b in zip(before, after):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    assert opt["step"].item() == 0


def test_telemetry_columns_follow_the_records():
    tel = port_loop.Telemetry()
    tel.log(0, 2.5, np.array([1, 3, 1]), {"grad_norm": torch.tensor(0.5)})
    tel.log(1, 2.0, np.array([2]), {"grad_norm": 0.25})
    cols = tel.as_columns()
    assert list(cols) == ["step", "domain", "n_seqs", "loss", "grad_norm"]
    np.testing.assert_array_equal(cols["domain"], [1, 3, 2])
    np.testing.assert_array_equal(cols["n_seqs"], [2, 1, 1])
    np.testing.assert_array_equal(cols["grad_norm"], [0.5, 0.5, 0.25])
    assert port_loop.Telemetry().as_columns() == {}


# ------------------------------------------------------------ the launcher

def test_launch_train_runs_on_the_cpu(tmp_path, capsys):
    train_launch.main(["--reduced", "--device", "cpu", "--steps", "3",
                       "--ckpt-dir", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("[train] done: first loss ")
    assert " -> last " in lines[-1]


def test_launch_train_resumes_and_takes_lowmem(tmp_path, capsys):
    args = ["--reduced", "--device", "cpu", "--policy", "lowmem",
            "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    train_launch.main(args + ["--steps", "2"])
    train_launch.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "[loop] resumed from step 2" in out
    assert out.strip().splitlines()[-1].startswith("[train] done:")


def test_launch_train_refuses_mesh_flags():
    with pytest.raises(SystemExit):
        train_launch.main(["--reduced", "--device", "cpu",
                           "--production-mesh"])
