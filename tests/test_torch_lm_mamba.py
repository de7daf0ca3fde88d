"""The port's Mamba mixer (`repro_torch.models.mamba`) against the
reference's (`repro.models.mamba`) on the CPU, float32: softplus, the
associative scan's combine tree, one chunk of the selective scan, the
chunked forward with its state carried across chunks, the decode step from
each package's own state, the gradients, and the initial constants; and
the mixer in bfloat16 (jamba-v0.1-52b's bfloat16 hold: see
tests/test_torch_lm_model.py).

Weights are the reference's `init_mamba`, with the constant leaves (conv_b,
dt_bias, a_log, d_skip) moved off their initial values by numpy noise so
that each term counts; inputs are numpy from a seed. Tolerances: outputs
and states rtol 1e-5 / atol 1e-6 of the largest |value|; gradients max
|diff| <= 1e-4·max|leaf| (tests/test_torch_lm_train.py's). The bits do not
match: XLA's CPU exp and log1p round otherwise than torch's in ~1 element
of 10, and XLA contracts the scan's multiply-adds into FMAs; the scan's
products alone (its decay) are equal bit for bit, the combine tree being
the reference's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as ref_mamba
from repro.models.common import ParamFactory as RefParamFactory
from repro_torch.models import mamba as port_mamba
from repro_torch.models.common import ParamFactory, softplus

jax.config.update("jax_default_matmul_precision", "float32")

AS_WRITTEN = {"xla_allow_excess_precision": False}

D = 32                     # d_inner 64, d_state 16, rank 2
B, S, CHUNK = 2, 32, 8


def host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_close(got, want, label=""):
    got, want = host(got), host(want)
    assert got.shape == want.shape, label
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max(), err_msg=label)


def dims_pair(d=D):
    return ref_mamba.MambaDims(d), port_mamba.MambaDims(d)


@functools.lru_cache(maxsize=None)
def weights(d=D):
    """(reference params as numpy, the port's as tensors): one layer."""
    rd, _ = dims_pair(d)
    params, _ = ref_mamba.init_mamba(
        RefParamFactory(jax.random.PRNGKey(3)), rd)
    rng = np.random.default_rng(4)
    params = {k: np.asarray(v) for k, v in params.items()}
    for k in ("conv_b", "dt_bias", "a_log", "d_skip"):
        params[k] = (params[k] + 0.3 * rng.normal(size=params[k].shape)
                     ).astype(np.float32)
    return params, {k: torch.from_numpy(v.copy()) for k, v in params.items()}


def inputs(s=S, seed=5, d=D):
    return np.random.default_rng(seed).normal(0, 1, (B, s, d)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def ref_forward(s, chunk):
    """The reference's forward over the first s positions of inputs()."""
    rd, _ = dims_pair()
    params, _ = weights()
    fn = jax.jit(lambda p, x: ref_mamba.mamba_forward(p, x, rd, chunk))
    return fn(params, jnp.asarray(inputs()[:, :s]))


def test_softplus_matches_reference_value_and_gradient():
    x = np.concatenate([np.linspace(-40, 40, 801),
                        np.random.default_rng(0).normal(0, 3, 1000)]
                       ).astype(np.float32)
    want = jax.nn.softplus(jnp.asarray(x))
    want_g = jax.grad(lambda t: jnp.sum(jax.nn.softplus(t) * t))(
        jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    got = softplus(t)
    (got * t).sum().backward()
    np.testing.assert_allclose(host(got), host(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(host(t.grad), host(want_g), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("length", [1, 2, 7, 16, 33])
def test_associative_scan_follows_the_reference_tree(length):
    rng = np.random.default_rng(length)
    a = rng.uniform(0.5, 1.0, (2, length, 8, 4)).astype(np.float32)
    b = rng.normal(size=(2, length, 8, 4)).astype(np.float32)
    want_a, want_b = jax.jit(lambda a, b: jax.lax.associative_scan(
        lambda l, r: (l[0] * r[0], l[1] * r[0] + r[1]), (a, b), axis=1))(
            a, b)
    got_a, got_b = port_mamba._associative_scan(
        [torch.from_numpy(a), torch.from_numpy(b)], dim=1)
    np.testing.assert_array_equal(host(got_a), host(want_a))
    assert_close(got_b, want_b)
    # the same recurrence as a sequential loop
    seq = [b[:, 0]]
    for t in range(1, length):
        seq.append(seq[-1] * a[:, t] + b[:, t])
    assert_close(got_b, np.stack(seq, axis=1))


@pytest.mark.parametrize("length", [8, 13])
def test_chunk_scan_matches_reference(length):
    rng = np.random.default_rng(length)
    di, n = 64, 16
    h0 = rng.normal(size=(B, di, n)).astype(np.float32)
    dt = (0.1 * np.abs(rng.normal(size=(B, length, di)))).astype(np.float32)
    b_ = rng.normal(size=(B, length, n)).astype(np.float32)
    c_ = rng.normal(size=(B, length, n)).astype(np.float32)
    x = rng.normal(size=(B, length, di)).astype(np.float32)
    a = (-np.exp(rng.normal(size=(di, n)))).astype(np.float32)
    args = (h0, dt, b_, c_, x, a)
    want_y, want_h = jax.jit(ref_mamba._chunk_scan)(*map(jnp.asarray, args))
    got_y, got_h = port_mamba._chunk_scan(*map(torch.from_numpy, args))
    assert_close(got_y, want_y, "y")
    assert_close(got_h, want_h, "h_last")


@pytest.mark.parametrize("chunk", [CHUNK, S])
def test_mamba_forward_and_state_match_reference(chunk):
    """chunk 8 < S = 32 carries h across four chunks; chunk = S is one."""
    _, pd = dims_pair()
    _, pt = weights()
    want_y, want_st = ref_forward(S, chunk)
    got_y, got_st = port_mamba.mamba_forward(pt, torch.from_numpy(inputs()),
                                             pd, chunk)
    assert_close(got_y, want_y, "y")
    assert isinstance(got_st, port_mamba.MambaState)
    assert got_st.conv.dtype == got_st.ssm.dtype == torch.float32
    assert_close(got_st.conv, want_st.conv, "conv")
    assert_close(got_st.ssm, want_st.ssm, "ssm")


def test_mamba_decode_matches_reference_and_own_forward():
    """Prefill 24, then 8 decode steps, each package from its own state:
    every step's output and the last state against the reference's; the
    port's steps against its own forward over 32 (positions 24-31)."""
    rd, pd = dims_pair()
    params, pt = weights()
    x = inputs()
    _, rstate = ref_forward(24, CHUNK)
    _, pstate = port_mamba.mamba_forward(pt, torch.from_numpy(x[:, :24]), pd,
                                         CHUNK)
    dec = jax.jit(lambda p, x, st: ref_mamba.mamba_decode(p, x, rd, st))
    got_steps = []
    for t in range(24, S):
        want, rstate = dec(params, jnp.asarray(x[:, t:t + 1]), rstate)
        got, pstate = port_mamba.mamba_decode(
            pt, torch.from_numpy(x[:, t:t + 1]), pd, pstate)
        assert_close(got, want, f"step {t}")
        got_steps.append(got)
    assert_close(pstate.conv, rstate.conv, "conv")
    assert_close(pstate.ssm, rstate.ssm, "ssm")
    full, _ = port_mamba.mamba_forward(pt, torch.from_numpy(x), pd, CHUNK)
    np.testing.assert_allclose(host(torch.cat(got_steps, dim=1)),
                               host(full[:, 24:]), rtol=1e-4, atol=1e-5)


def test_mamba_gradients_match_reference():
    rd, pd = dims_pair()
    params, _ = weights()
    x = inputs(16)
    proj = np.random.default_rng(6).normal(size=(B, 16, D)).astype(np.float32)

    def ref_loss(p, x):
        y, st = ref_mamba.mamba_forward(p, x, rd, CHUNK)
        return jnp.sum(y * proj) + jnp.sum(st.ssm)
    want = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(params, jnp.asarray(x))
    pt = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, st = port_mamba.mamba_forward(pt, xt, pd, CHUNK)
    (torch.sum(y * torch.from_numpy(proj)) + st.ssm.sum()).backward()
    pairs = [(k, pt[k].grad, want[0][k]) for k in sorted(pt)]
    pairs.append(("x", xt.grad, want[1]))
    for name, g, w in pairs:
        w = host(w)
        scale = np.abs(w).max()
        assert scale > 0, name
        assert np.abs(host(g) - w).max() <= 1e-4 * scale, name


def test_init_matches_the_reference_shapes_and_constants():
    rd, pd = dims_pair(64)
    ref, _ = ref_mamba.init_mamba(RefParamFactory(jax.random.PRNGKey(0)), rd)
    mod = port_mamba.Mamba(ParamFactory(torch.Generator().manual_seed(0)),
                           pd, repeats=3)
    got = dict(mod.named_parameters())
    assert sorted(got) == sorted(ref)
    for name, w in ref.items():
        assert tuple(got[name].shape) == (3,) + w.shape, name
    # within one float32 ulp: XLA's CPU log(7) is an ulp off the correctly
    # rounded value, which torch.log gives
    for name in ("conv_b", "dt_bias", "a_log", "d_skip"):
        for r in range(3):
            np.testing.assert_array_max_ulp(host(got[name][r]),
                                            host(ref[name]), maxulp=1)
    for name, std in (("in_proj", 64 ** -0.5), ("conv_w", 0.5),
                      ("x_proj", 128 ** -0.5)):
        assert abs(got[name].std().item() / std - 1) < 0.15, name


def test_mamba_forward_checks_the_chunk():
    _, pd = dims_pair()
    _, pt = weights()
    with pytest.raises(ValueError, match="Mamba chunk"):
        port_mamba.mamba_forward(pt, torch.zeros(1, 24, D), pd, 16)


def test_state_is_float32_and_stacked():
    _, pd = dims_pair()
    st = port_mamba.init_mamba_state(3, pd, "cpu", repeats=2)
    assert st.conv.shape == (2, 3, 3, 64) and st.ssm.shape == (2, 3, 64, 16)
    assert st.conv.dtype == st.ssm.dtype == torch.float32
    assert not st.conv.any() and not st.ssm.any()


def test_mamba_bfloat16_matches_reference():
    """The compute dtype bfloat16, a_log and dt_bias read in float32 (as
    the model hands them): prefill over 24 positions in chunks of 8, then 8
    decode steps, outputs and states within 2e-2 (the repo's bfloat16
    tolerance) of the reference's, compiled as written."""
    rd, pd = dims_pair()
    params, pt = weights()
    bf = {k: v if k in port_mamba.AS_STORED else v.to(torch.bfloat16)
          for k, v in pt.items()}
    jbf = {k: jnp.asarray(v) if k in port_mamba.AS_STORED
           else jnp.asarray(v).astype(jnp.bfloat16) for k, v in params.items()}
    x = jnp.asarray(inputs()).astype(jnp.bfloat16)
    xt = torch.from_numpy(inputs()).to(torch.bfloat16)
    fwd = jax.jit(lambda p, x: ref_mamba.mamba_forward(p, x, rd, CHUNK)).lower(
        jbf, x[:, :24]).compile(compiler_options=AS_WRITTEN)
    want, rstate = fwd(jbf, x[:, :24])
    got, pstate = port_mamba.mamba_forward(bf, xt[:, :24], pd, CHUNK)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(host(got), host(want), rtol=2e-2, atol=2e-2)
    dec = jax.jit(lambda p, x, st: ref_mamba.mamba_decode(p, x, rd, st)).lower(
        jbf, x[:, :1], rstate).compile(compiler_options=AS_WRITTEN)
    for t in range(24, S):
        want, rstate = dec(jbf, x[:, t:t + 1], rstate)
        got, pstate = port_mamba.mamba_decode(bf, xt[:, t:t + 1], pd, pstate)
        np.testing.assert_allclose(host(got), host(want), rtol=2e-2,
                                   atol=2e-2, err_msg=f"step {t}")
    for field, g, w in zip(pstate._fields, pstate, rstate):
        assert g.dtype == torch.float32, field
        np.testing.assert_allclose(host(g), host(w), rtol=2e-2, atol=2e-2,
                                   err_msg=field)
