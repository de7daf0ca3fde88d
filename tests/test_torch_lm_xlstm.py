"""The port's xLSTM mixers (`repro_torch.models.xlstm`) against the
reference's (`repro.models.xlstm`) on the CPU, float32: the causal
convolution, one mLSTM and one sLSTM cell step, each forward with its
final state, the decode steps from each package's own state, the
gradients and the initial constants; then both recurrent archs' caches
under a bfloat16 cache dtype, their parameters and optimizer state
carried from the reference, and their launchers.

Weights are the reference's `init_mlstm` / `init_slstm`, with the
constant leaves moved off their initial values by numpy noise so that
each term counts; inputs are numpy from a seed. Tolerances: outputs and
states rtol 1e-5 / atol 1e-6 of the largest |value|; gradients max |diff|
<= 1e-4·max|leaf| (tests/test_torch_lm_train.py's). The bits do not match:
XLA's CPU exp, log1p and tanh round otherwise than torch's, and XLA
contracts multiply-adds into FMAs.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro.models import xlstm as ref_xlstm
from repro.models.common import ParamFactory as RefParamFactory
from repro.train import optim as ref_optim
from repro_torch.checkpoint.ckpt import flatten_with_paths
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import model as port_model
from repro_torch.models import xlstm as port_xlstm
from repro_torch.models.common import ParamFactory, causal_conv
from repro_torch.serve import engine as port_engine
from repro_torch.state import lm_params_from_reference, \
    opt_state_from_reference
from repro_torch.train import optim as port_optim
from repro_torch.train import step as port_step

jax.config.update("jax_default_matmul_precision", "float32")

D, H = 32, 4               # mLSTM d_inner 64, d_head 16; sLSTM d_head 8
B, S = 2, 16
CONSTANTS = {"mlstm": ("conv_b", "b_i", "b_f", "ln_scale"),
             "slstm": ("b_i", "b_f", "b_z", "b_o")}
INIT = {"mlstm": ref_xlstm.init_mlstm, "slstm": ref_xlstm.init_slstm}
MODULE = {"mlstm": port_xlstm.MLSTM, "slstm": port_xlstm.SLSTM}


def host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_close(got, want, label=""):
    got, want = host(got), host(want)
    assert got.shape == want.shape, label
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max(), err_msg=label)


def dims_pair():
    return ref_xlstm.XLSTMDims(D, H), port_xlstm.XLSTMDims(D, H)


@functools.lru_cache(maxsize=None)
def weights(kind):
    """(reference params as numpy, the port's as tensors): one layer."""
    rd, _ = dims_pair()
    params, _ = INIT[kind](RefParamFactory(jax.random.PRNGKey(3)), rd)
    rng = np.random.default_rng(4)
    params = {k: np.asarray(v) for k, v in params.items()}
    for k in CONSTANTS[kind]:
        params[k] = (params[k] + 0.3 * rng.normal(size=params[k].shape)
                     ).astype(np.float32)
    if kind == "slstm":   # a recurrence large enough to matter
        for g in port_xlstm.GATES:
            params[f"r_{g}"] = params[f"r_{g}"] * 10
    return params, {k: torch.from_numpy(v.copy()) for k, v in params.items()}


def inputs(seed=5):
    return np.random.default_rng(seed).normal(0, 1, (B, S, D)).astype(
        np.float32)


REF_FWD = {"mlstm": ref_xlstm.mlstm_forward, "slstm": ref_xlstm.slstm_forward}
REF_DEC = {"mlstm": ref_xlstm.mlstm_decode, "slstm": ref_xlstm.slstm_decode}
PORT_FWD = {"mlstm": port_xlstm.mlstm_forward,
            "slstm": port_xlstm.slstm_forward}
PORT_DEC = {"mlstm": port_xlstm.mlstm_decode,
            "slstm": port_xlstm.slstm_decode}


@functools.lru_cache(maxsize=None)
def ref_forward(kind, s):
    """The reference's forward over the first s positions of inputs()."""
    rd, _ = dims_pair()
    params, _ = weights(kind)
    fn = jax.jit(lambda p, x: REF_FWD[kind](p, x, rd))
    return fn(params, jnp.asarray(inputs()[:, :s]))


def assert_state_close(got, want, label):
    assert type(got).__name__ == type(want).__name__
    for field, g, w in zip(got._fields, got, want):
        assert g.dtype == torch.float32, field
        assert_close(g, w, f"{label} {field}")


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rd, _ = dims_pair()
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(B, S, 2 * D)).astype(np.float32)
    conv = rng.normal(size=(B, 3, 2 * D)).astype(np.float32)
    p = {"conv_w": rng.normal(size=(4, 2 * D)).astype(np.float32),
         "conv_b": rng.normal(size=(2 * D,)).astype(np.float32)}
    want, want_tail = ref_xlstm._causal_conv(
        p, jnp.asarray(xs), rd, jnp.asarray(conv) if with_state else None)
    got, tail = causal_conv(torch.from_numpy(xs),
                            torch.from_numpy(p["conv_w"]),
                            torch.from_numpy(conv) if with_state else None)
    got = got + torch.from_numpy(p["conv_b"])
    got = got * (1 / (1 + torch.exp(-got)))
    assert_close(got, want)
    np.testing.assert_array_equal(host(tail), host(want_tail))


def test_mlstm_cell_matches_reference():
    rng = np.random.default_rng(2)
    dh = 16
    f = lambda *shape, s=1.0: (s * rng.normal(size=shape)).astype(np.float32)
    state = (f(B, H, dh, dh), f(B, H, dh), f(B, H), f(B, 3, 2 * D))
    qkvif = (f(B, H, dh), f(B, H, dh), f(B, H, dh), f(B, H, s=3.0),
             f(B, H, s=3.0))
    want_st, want_h = jax.jit(ref_xlstm._mlstm_cell)(
        ref_xlstm.MLSTMState(*map(jnp.asarray, state)),
        tuple(map(jnp.asarray, qkvif)))
    got_st, got_h = port_xlstm._mlstm_cell(
        port_xlstm.MLSTMState(*map(torch.from_numpy, state)),
        tuple(map(torch.from_numpy, qkvif)))
    assert_close(got_h, want_h, "h")
    assert_state_close(got_st, want_st, "state")


def test_slstm_cell_matches_reference():
    rng = np.random.default_rng(3)
    _, pt = weights("slstm")
    params, _ = weights("slstm")
    dh = D // H
    f = lambda s=1.0: (s * rng.normal(size=(B, H, dh))).astype(np.float32)
    state = (f(), f(), f(), f())
    xg = {g: f(3.0) for g in port_xlstm.GATES}
    want_st, want_h = jax.jit(ref_xlstm._slstm_cell)(
        params, ref_xlstm.SLSTMState(*map(jnp.asarray, state)),
        {g: jnp.asarray(v) for g, v in xg.items()})
    got_st, got_h = port_xlstm._slstm_cell(
        pt, port_xlstm.SLSTMState(*map(torch.from_numpy, state)),
        {g: torch.from_numpy(v) for g, v in xg.items()})
    assert_close(got_h, want_h, "h")
    assert_state_close(got_st, want_st, "state")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_forward_and_final_state_match_reference(kind):
    _, pd = dims_pair()
    _, pt = weights(kind)
    want_y, want_st = ref_forward(kind, S)
    got_y, got_st = PORT_FWD[kind](pt, torch.from_numpy(inputs()), pd)
    assert_close(got_y, want_y, "y")
    assert_state_close(got_st, want_st, "final state")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_matches_reference_and_own_forward(kind):
    """Prefill 10, then 6 decode steps, each package from its own state:
    every step's output and the last state against the reference's; the
    port's steps against its own forward over 16 (positions 10-15)."""
    rd, pd = dims_pair()
    params, pt = weights(kind)
    x = inputs()
    _, rstate = ref_forward(kind, 10)
    _, pstate = PORT_FWD[kind](pt, torch.from_numpy(x[:, :10]), pd)
    dec = jax.jit(lambda p, x, st: REF_DEC[kind](p, x, rd, st))
    steps = []
    for t in range(10, S):
        want, rstate = dec(params, jnp.asarray(x[:, t:t + 1]), rstate)
        got, pstate = PORT_DEC[kind](pt, torch.from_numpy(x[:, t:t + 1]), pd,
                                     pstate)
        assert_close(got, want, f"step {t}")
        steps.append(got)
    assert_state_close(pstate, rstate, "after decode")
    full, _ = PORT_FWD[kind](pt, torch.from_numpy(x), pd)
    np.testing.assert_allclose(host(torch.cat(steps, dim=1)),
                               host(full[:, 10:]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_gradients_match_reference(kind):
    """Through the outputs and the final state's c (m's gradient is not
    stopped, in either package)."""
    rd, pd = dims_pair()
    params, _ = weights(kind)
    x = inputs()
    proj = np.random.default_rng(6).normal(size=(B, S, D)).astype(np.float32)

    def ref_loss(p, x):
        y, st = REF_FWD[kind](p, x, rd)
        return jnp.sum(y * proj) + jnp.sum(st.c) + jnp.sum(st.m)
    want = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(params, jnp.asarray(x))
    pt = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, st = PORT_FWD[kind](pt, xt, pd)
    (torch.sum(y * torch.from_numpy(proj)) + st.c.sum()
     + st.m.sum()).backward()
    pairs = [(k, pt[k].grad, want[0][k]) for k in sorted(pt)]
    pairs.append(("x", xt.grad, want[1]))
    for name, g, w in pairs:
        w = host(w)
        scale = np.abs(w).max()
        assert scale > 0, name
        assert np.abs(host(g) - w).max() <= 1e-4 * scale, name


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_init_matches_the_reference_shapes_and_constants(kind):
    rd, pd = dims_pair()
    ref, _ = INIT[kind](RefParamFactory(jax.random.PRNGKey(0)), rd)
    mod = MODULE[kind](ParamFactory(torch.Generator().manual_seed(0)), pd,
                       repeats=2)
    got = dict(mod.named_parameters())
    assert sorted(got) == sorted(ref)
    for name, w in ref.items():
        assert tuple(got[name].shape) == (2,) + w.shape, name
        if name in CONSTANTS[kind] + ("b_i",):
            for r in range(2):
                np.testing.assert_array_equal(host(got[name][r]),
                                              host(w), err_msg=name)
    if kind == "mlstm":
        assert (got["b_f"] == 3.0).all()
    else:
        assert (got["b_f"] == 1.0).all() and not got["b_o"].any()
        assert abs(got["r_i"].std().item() / 0.02 - 1) < 0.15


def test_states_are_float32_and_stacked():
    _, pd = dims_pair()
    m = port_xlstm.init_mlstm_state(3, pd, "cpu", repeats=2)
    assert [tuple(t.shape) for t in m] == [(2, 3, H, 16, 16), (2, 3, H, 16),
                                           (2, 3, H), (2, 3, 3, 2 * D)]
    assert (m.m == -1e30).all() and not m.c.any()
    s = port_xlstm.init_slstm_state(3, pd, "cpu")
    assert all(tuple(t.shape) == (3, H, D // H) for t in s)
    assert (s.m == -1e30).all() and not s.h.any()
    assert all(t.dtype == torch.float32 for t in (*m, *s))


# ------------------------------------------------------------ the archs

class PortF32Step(port_step.StepConfig):
    @property
    def compute_dtype(self):
        return torch.float32


@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-v0.1-52b"])
def test_bfloat16_cache_dtype_keeps_recurrent_states_float32(arch):
    """ServeConfig(cache_dtype="bfloat16") rounds the KV caches only: the
    recurrent states stay float32, so with no attention layer (xlstm) the
    tokens equal the float32 cache's exactly."""
    cfg = get_config(arch).reduced()
    caches = port_model.init_cache(cfg, 2, 24, torch.bfloat16, "cpu")
    for spec, cache in zip(cfg.pattern, caches):
        want = torch.bfloat16 if spec.mixer == "attn" else torch.float32
        assert all(leaf.dtype == want for leaf in cache), spec
        assert all(leaf.shape[0] == cfg.n_repeats for leaf in cache)
    model = port_model.init_params(cfg, torch.Generator().manual_seed(2))
    prompts = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    runs = {}
    for dtype in ("float32", "bfloat16"):
        eng = port_engine.ServeEngine(
            cfg, model, port_engine.ServeConfig(cache_dtype=dtype),
            PortF32Step())
        runs[dtype] = eng.generate(prompts, 8)
        np.testing.assert_array_equal(eng.generate(prompts, 8), runs[dtype])
    assert runs["bfloat16"].shape == (2, 24)
    assert 0 <= runs["bfloat16"].min() and runs["bfloat16"].max() < \
        cfg.vocab_size
    if arch == "xlstm-125m":
        np.testing.assert_array_equal(runs["bfloat16"], runs["float32"])


def test_serve_forward_writes_each_repeats_state_row():
    """Two repeats of [mLSTM, sLSTM]: prefill writes each repeat's row of
    the stacked states, and they differ by repeat."""
    cfg = dataclasses.replace(get_config("xlstm-125m").reduced(), n_layers=4)
    model = port_model.init_params(cfg, torch.Generator().manual_seed(3))
    caches = port_model.init_cache(cfg, 2, 16, torch.float32, "cpu")
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 16)))
    _, out = port_model.prefill(model, cfg, toks, caches)
    assert out is caches
    for cache in caches:
        assert (cache.m > -1e29).all()
        assert not torch.equal(cache.c[0], cache.c[1])


@pytest.mark.parametrize("moments", ["f32", "int8"])
@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-v0.1-52b"])
def test_reference_state_carries_into_the_port(arch, moments):
    """`lm_params_from_reference` loads the reference's init_params (names,
    shapes and values; the reference's leaf order) and
    `opt_state_from_reference` its optimizer state (int8 blocks over the
    new leaves included), equal to the port's own init_opt_state's
    tree."""
    cfg, ref_cfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    params, _ = ref_model.init_params(ref_cfg, jax.random.PRNGKey(1))
    params_np = jax.tree.map(np.asarray, params)
    model = port_model.empty(cfg, "cpu")
    model.load_state_dict(lm_params_from_reference(cfg, params_np, "cpu"),
                          assign=True)
    got = flatten_with_paths(model.param_tree())
    want = flatten_with_paths(params_np)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, t), (_, w) in zip(got, want):
        np.testing.assert_array_equal(t.detach().numpy(), w, err_msg=path)
    ocfg = ref_optim.OptConfig(moments_dtype=moments)
    opt_np = jax.tree.map(np.asarray, ref_optim.init_opt_state(params, ocfg))
    port = opt_state_from_reference(cfg, opt_np, "cpu")
    own = port_optim.init_opt_state(model.param_tree(), port_optim.OptConfig(
        moments_dtype=moments))
    for (path, t), (_, w), (_, o) in zip(flatten_with_paths(port),
                                         flatten_with_paths(opt_np),
                                         flatten_with_paths(own)):
        np.testing.assert_array_equal(t.numpy(), w, err_msg=path)
        assert t.shape == o.shape and t.dtype == o.dtype, path


@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-v0.1-52b"])
def test_launchers_run_the_recurrent_archs_on_the_cpu(arch, tmp_path,
                                                      capsys):
    serve_launch.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8",
                       "--new-tokens", "4"])
    train_launch.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "16",
                       "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[serve] 8 tokens in" in out and "output (2, 12) on cpu" in out
    assert "[train]" in out, out
