"""The port's training path (`repro_torch.models.model.loss_fn`,
`repro_torch.train.step.make_train_step`) against the reference's on the
CPU: the same weights (the reference's `init_params`, carried by
`repro_torch.state.lm_params_from_reference`) and the same batches (numpy
from a seed) through the cross-entropy, the loss and every gradient leaf,
and three optimizer steps under both dtype policies.

qwen2-1.5b (tied head, QKV bias, GQA), llama3-405b (untied, no bias),
granite-moe-3b-a800m (the routed MoE channel: a non-zero aux loss whose
gradient flows through the router, and capacity drops), reduced, with 3
layers; xlstm-125m (mLSTM and sLSTM, 4 layers: two repeats) and
jamba-v0.1-52b (Mamba, attention and MoE, one period of 8 layers),
reduced. The reference is compiled with bfloat16 rounded as
written (`xla_allow_excess_precision` off) and float32 products in float32.
Tolerances: float32 compute, loss rtol 1e-5 (the MoE aux rtol 1e-5 too)
and every gradient leaf max
|diff| <= 1e-4·max|leaf| (a leaf whose gradient is zero, `ZERO_GRADIENT`,
at most 1e-6 of the largest gradient in both); bfloat16 compute, the loss within 2e-2 (the
reference's own bfloat16 tolerance, tests/test_models_smoke.py) and the
gradient norm within 5e-2; the 3-step trajectories of loss and grad_norm
rtol 1e-4 at float32 compute.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import common as ref_common
from repro.models import model as ref_model
from repro.train import optim as ref_optim
from repro.train import step as ref_step
from repro_torch.checkpoint.ckpt import flatten_with_paths
from repro_torch.configs import get_config
from repro_torch.data.tokens import DataConfig, SyntheticTokenStream
from repro_torch.models import common as port_common
from repro_torch.models import model as port_model
from repro_torch.train import optim as port_optim
from repro_torch.train import step as port_step
from repro_torch.state import lm_params_from_reference

jax.config.update("jax_default_matmul_precision", "float32")

ARCHS = ["qwen2-1.5b", "llama3-405b", "granite-moe-3b-a800m", "xlstm-125m",
         "jamba-v0.1-52b"]
B, S = 2, 32
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
AS_WRITTEN = {"xla_allow_excess_precision": False}
# Leaves whose gradient is zero: sLSTM's input-gate bias (a constant added
# to i_t at every step scales c and n alike, and h = o·c/n keeps it out).
# Both packages give float32 rounding there (~1e-9), held as at most 1e-6
# of the largest gradient.
ZERO_GRADIENT = ("slstm/b_i",)
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=10)


def ref_compiled(fn, *args):
    """fn jitted and compiled for `args` with bfloat16 rounded as written."""
    return jax.jit(fn).lower(*args).compile(compiler_options=AS_WRITTEN)


def host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def cfgs(arch):
    """Both configs, reduced to 3 layers (whole periods of a longer
    pattern)."""
    period = len(get_config(arch).pattern)
    n = -(-3 // period) * period
    ref = dataclasses.replace(ref_get_config(arch).reduced(), n_layers=n)
    port = dataclasses.replace(get_config(arch).reduced(), n_layers=n)
    return ref, port


@functools.lru_cache(maxsize=None)
def ref_params(arch, policy="f32"):
    """Weights of the reference's tree and shapes (`abstract_params`) drawn
    with numpy from a seed: matrices N(0, 1/d_model), norms 1 + N(0, 0.1²)
    and biases N(0, 0.1²), so that every leaf's gradient is exercised;
    cast to bfloat16 for the lowmem policy."""
    ref_cfg, _ = cfgs(arch)
    sds, _ = ref_model.abstract_params(ref_cfg)
    rng = np.random.default_rng(5)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        x = rng.normal(0, 1, leaf.shape).astype(np.float32)
        if "norm" in name:
            x = 1 + 0.1 * x
        elif "'b" in name:
            x = 0.1 * x
        else:
            x = x / np.sqrt(ref_cfg.d_model)
        return jnp.asarray(x, jnp.bfloat16 if policy == "lowmem"
                           else jnp.float32)
    return jax.tree_util.tree_map_with_path(draw, sds)


def port_params(arch, policy="f32"):
    """A fresh port model carrying the reference's weights (training
    writes it in place)."""
    _, port_cfg = cfgs(arch)
    dtype = torch.bfloat16 if policy == "lowmem" else torch.float32
    model = port_model.empty(port_cfg, "cpu", dtype)
    model.load_state_dict(lm_params_from_reference(
        port_cfg, jax.tree.map(np.asarray, ref_params(arch, policy)), "cpu"),
        assign=True)
    return model


def batches(cfg, n):
    stream = SyntheticTokenStream(DataConfig(cfg.vocab_size, S, B, seed=3))
    return [{k: v for k, v in stream.next_batch().items()
             if k in ("tokens", "labels")} for _ in range(n)]


@functools.lru_cache(maxsize=None)
def ref_loss_and_grads(arch, dtype_name):
    ref_cfg, _ = cfgs(arch)
    jdt, _ = DTYPES[dtype_name]
    params = ref_params(arch)
    batch = {k: jnp.asarray(v) for k, v in batches(ref_cfg, 1)[0].items()}
    fn = ref_compiled(jax.value_and_grad(
        lambda p, b: ref_model.loss_fn(p, ref_cfg, b, compute_dtype=jdt,
                                       remat=False), has_aux=True),
        params, batch)
    (loss, parts), grads = fn(params, batch)
    return (float(loss), {k: float(v) for k, v in parts.items()},
            [(p, host(g)) for p, g in flatten_with_paths(
                jax.tree.map(np.asarray, grads))])


def port_loss_and_grads(arch, dtype_name, remat):
    _, port_cfg = cfgs(arch)
    _, tdt = DTYPES[dtype_name]
    model = port_params(arch)
    batch = {k: torch.from_numpy(v) for k, v in
             batches(port_cfg, 1)[0].items()}
    loss, parts = port_model.loss_fn(model, port_cfg, batch,
                                     compute_dtype=tdt, remat=remat)
    tree = model.param_tree()
    leaves = flatten_with_paths(tree)
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    return loss, parts, [(path, g) for (path, _), g in zip(leaves, grads)]


# ------------------------------------------------------------ the loss

@pytest.mark.parametrize("z_loss", [1e-4, 0.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_reference(dtype, z_loss):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 3, (3, 7, 300)).astype(np.float32)
    labels = rng.integers(0, 300, (3, 7)).astype(np.int32)
    want = ref_common.cross_entropy(jnp.asarray(logits).astype(jdt),
                                    jnp.asarray(labels), z_loss)
    got = port_common.cross_entropy(torch.from_numpy(logits).to(tdt),
                                    torch.from_numpy(labels), z_loss)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(host(got), host(want), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_reference_float32(arch):
    want_loss, want_parts, want_grads = ref_loss_and_grads(arch, "float32")
    loss, parts, grads = port_loss_and_grads(arch, "float32", remat=False)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    np.testing.assert_allclose(parts["ce"].item(), want_parts["ce"],
                               rtol=1e-5)
    if cfgs(arch)[1].n_experts:
        assert want_parts["aux"] > 0
        np.testing.assert_allclose(parts["aux"].item(), want_parts["aux"],
                                   rtol=1e-5)
    else:
        assert parts["aux"].item() == want_parts["aux"] == 0.0
    assert [p for p, _ in grads] == [p for p, _ in want_grads]
    top = max(np.abs(w).max() for _, w in want_grads)
    for (path, g), (_, w) in zip(grads, want_grads):
        assert g.dtype == torch.float32 and g.shape == w.shape, path
        if path.endswith(ZERO_GRADIENT):
            assert max(np.abs(w).max(), np.abs(host(g)).max()) <= 1e-6 * top
            continue
        scale = np.abs(w).max()
        assert scale > 0, path
        assert np.abs(host(g) - w).max() <= 1e-4 * scale, path


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grad_norm_match_reference_bfloat16(arch):
    want_loss, _, want_grads = ref_loss_and_grads(arch, "bfloat16")
    loss, _, grads = port_loss_and_grads(arch, "bfloat16", remat=True)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=2e-2, atol=2e-2)
    want_norm = np.sqrt(sum(np.sum(np.square(w.astype(np.float64)))
                            for _, w in want_grads))
    got_norm = port_optim.global_norm(dict(grads)).item()
    np.testing.assert_allclose(got_norm, want_norm, rtol=5e-2)
    # The master weights are float32: so are their gradients, the
    # embedding's included (gathered from the float32 table, then cast).
    assert all(g.dtype == torch.float32 for _, g in grads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_give_equal_loss_and_gradients(arch, dtype):
    loss0, _, grads0 = port_loss_and_grads(arch, dtype, remat=False)
    loss1, _, grads1 = port_loss_and_grads(arch, dtype, remat=True)
    assert torch.equal(loss0, loss1)
    for (path, g0), (_, g1) in zip(grads0, grads1):
        assert torch.equal(g0, g1), path


def test_train_mode_logits_equal_the_serving_forward():
    """The train forward casts the weights inside the graph; prefill reads
    the cast cache. Their logits agree bit for bit, with grad enabled and
    under no_grad."""
    _, cfg = cfgs("qwen2-1.5b")
    model = port_params("qwen2-1.5b")
    toks = torch.from_numpy(batches(cfg, 1)[0]["tokens"])
    for dtype in (torch.float32, torch.bfloat16):
        caches = port_model.init_cache(cfg, toks.shape[0], toks.shape[1],
                                       dtype, "cpu")
        want, _ = port_model.prefill(model, cfg, toks, caches,
                                     compute_dtype=dtype)
        got, caches, aux = port_model.forward(model, cfg, toks,
                                              compute_dtype=dtype)
        with torch.no_grad():
            quiet, _, aux0 = port_model.forward(model, cfg, toks,
                                                compute_dtype=dtype)
        assert got.requires_grad and not quiet.requires_grad
        assert not want.requires_grad and caches is None
        assert torch.equal(got.detach(), want)
        assert torch.equal(quiet, want)
        assert aux.shape == aux0.shape == () and aux.item() == 0.0


# ------------------------------------------------------------ the step

class RefF32Step(ref_step.StepConfig):
    @property
    def compute_dtype(self):
        return jnp.float32


class PortF32Step(port_step.StepConfig):
    @property
    def compute_dtype(self):
        return torch.float32


@functools.lru_cache(maxsize=None)
def ref_trajectory(arch, policy, n_steps=3):
    ref_cfg, _ = cfgs(arch)
    step_cfg = RefF32Step(policy=policy)
    opt_cfg = ref_optim.OptConfig(**OPT)
    params = ref_params(arch, policy)
    opt = ref_optim.init_opt_state(params, step_cfg.opt_config(opt_cfg))
    bs = [{k: jnp.asarray(v) for k, v in b.items()}
          for b in batches(ref_cfg, n_steps)]
    fn = ref_compiled(ref_step.make_train_step(ref_cfg, opt_cfg, step_cfg),
                      params, opt, bs[0])
    out = []
    for b in bs:
        params, opt, m = fn(params, opt, b)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    float(m["lr"])))
    return out, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("policy", ["f32", "lowmem"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_train_step_trajectory_matches_reference(arch, policy):
    want, want_params = ref_trajectory(arch, policy)
    _, cfg = cfgs(arch)
    step_cfg = PortF32Step(policy=policy)
    opt_cfg = port_optim.OptConfig(**OPT)
    model = port_params(arch, policy)
    opt = port_optim.init_opt_state(model.param_tree(),
                                    step_cfg.opt_config(opt_cfg))
    step = port_step.make_train_step(cfg, opt_cfg, step_cfg)
    got = []
    for b in batches(cfg, len(want)):
        params, opt, m = step(model, opt,
                              {k: torch.from_numpy(v) for k, v in b.items()})
        assert params is model
        got.append((m["loss"].item(), m["grad_norm"].item(), m["lr"].item()))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4)
    assert opt["step"].item() == len(want)
    dtype = torch.bfloat16 if policy == "lowmem" else torch.float32
    for (path, p), (_, w) in zip(flatten_with_paths(model.param_tree()),
                                 flatten_with_paths(want_params)):
        assert p.dtype == dtype, path
        np.testing.assert_allclose(host(p), np.asarray(w, np.float32),
                                   rtol=1e-2, atol=1e-3, err_msg=path)
