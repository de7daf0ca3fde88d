"""The port's MoE channel (`repro_torch.models.moe`) against the reference's
(`repro.models.moe`) on the CPU: the same weights (the reference's
`init_moe`) and the same inputs (numpy, fixed seed) through the router,
the slot ranking, both dispatches at capacity factors that drop most,
some and no assignments, the gradients, `bf16_grad`, and the four
properties of tests/test_moe.py held on the port; then the two MoE archs
through the serving and training entry points.

Tolerances: routing indices and ranks equal; gate weights and the aux loss
rtol 1e-6; float32 outputs rtol 1e-5 / atol 1e-6 of the largest |output|
(up to ~10 here: the reference draws the experts at 1/√E, and a token's k
weighted slots may cancel to near zero, where float32 products summed in
another order differ by a few ulps of the slots); float32 gradients max
|diff| <= 1e-4·max|leaf|. In bfloat16 the outputs equal the reference's
bit for bit once both form the expert products with the same dot (XLA's):
the float32 sums inside a 16-bit product run in another order in torch's
GEMM than in XLA's, which leaves ~1e-4 of bfloat16 products one ulp apart;
the plain port there stays within the repo's bfloat16 tolerance (2e-2)
with at most 1e-3 of the elements not bit-equal. The reference runs
compiled with bfloat16 rounded as written (`xla_allow_excess_precision`
off) and float32 products in float32.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe
from repro.models.common import ParamFactory as RefParamFactory
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import model as port_model
from repro_torch.models import moe as port_moe
from repro_torch.models.common import ParamFactory

jax.config.update("jax_default_matmul_precision", "float32")

AS_WRITTEN = {"xla_allow_excess_precision": False}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
E, K, D, F = 8, 4, 64, 32
B, S = 2, 64


def host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def dims_pair(cf=1.25, dispatch="grouped", e=E, k=K, d=D, f=F):
    return (ref_moe.MoEDims(d, f, e, k, cf, dispatch),
            port_moe.MoEDims(d, f, e, k, cf, dispatch))


@functools.lru_cache(maxsize=None)
def ref_params(e=E, k=K, d=D, f=F, seed=0, zero_router=False):
    """The reference's `init_moe` as numpy (router zeroed on request)."""
    dims, _ = dims_pair(e=e, k=k, d=d, f=f)
    params, _ = ref_moe.init_moe(RefParamFactory(jax.random.PRNGKey(seed)),
                                 dims)
    params = {n: np.asarray(v) for n, v in params.items()}
    if zero_router:
        params["router"] = np.zeros_like(params["router"])
    return params


def port_params(params, requires_grad=False):
    return {n: torch.tensor(v, requires_grad=requires_grad)
            for n, v in params.items()}


def inputs(shape, seed=1):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def ref_compiled(fn, *spec):
    """`fn` jitted and compiled for arguments shaped (shape, dtype) as
    `spec` gives them (nested dicts as tuples of items)."""
    def abstract(s):
        if isinstance(s, tuple) and s and isinstance(s[0], tuple) \
                and isinstance(s[0][0], str):
            return {n: abstract(v) for n, v in s}
        return jax.ShapeDtypeStruct(*s)
    return jax.jit(fn).lower(*[abstract(s) for s in spec]).compile(
        compiler_options=AS_WRITTEN)


def spec_of(x):
    if isinstance(x, dict):
        return tuple((n, spec_of(v)) for n, v in sorted(x.items()))
    return (tuple(x.shape), x.dtype)


def ref_call(fn, *args):
    return ref_compiled(fn, *[spec_of(a) for a in args])(*args)


@functools.lru_cache(maxsize=None)
def ref_route_fn(dims):
    return lambda p, xt: ref_moe._route(p, xt, dims)


@functools.lru_cache(maxsize=None)
def ref_moe_fn(dims):
    return lambda p, x: ref_moe.apply_moe(p, x, dims)


# ------------------------------------------------------------ routing

@pytest.mark.parametrize("zero_router", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_matches_reference(dtype, zero_router):
    """Equal indices, ties included: a zeroed router makes every
    probability equal, bfloat16 logits make many equal."""
    jdt, tdt = DTYPES[dtype]
    rdims, pdims = dims_pair()
    params = ref_params(zero_router=zero_router)
    xt = inputs((B * S, D))
    gw, gi, aux = ref_call(ref_route_fn(rdims), params,
                           jnp.asarray(xt).astype(jdt))
    tw, ti, taux = port_moe._route(port_params(params),
                                   torch.from_numpy(xt).to(tdt), pdims)
    assert ti.shape == (B * S, K) and tw.dtype == taux.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(gi))
    np.testing.assert_allclose(host(tw), host(gw), rtol=1e-6, atol=0)
    np.testing.assert_allclose(taux.item(), float(aux), rtol=1e-6)
    if zero_router:
        np.testing.assert_array_equal(ti.numpy(),
                                      np.tile(np.arange(K), (B * S, 1)))


def test_route_breaks_ties_by_the_lower_index():
    probs = torch.tensor([[.1, .3, .3, .05, .3, .1, .3, .2]])
    want = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)[1]
    logits = torch.log(probs)
    p = {"router": torch.eye(8)}
    _, idx, _ = port_moe._route(p, logits, port_moe.MoEDims(8, 4, 8, 3))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    np.testing.assert_array_equal(idx.numpy(), [[1, 2, 4]])


@pytest.mark.parametrize("n, e", [(128, 8), (513, 40), (7, 3), (64, 128)])
def test_rank_in_expert_equals_reference(n, e):
    rng = np.random.default_rng(n + e)
    rows = rng.integers(0, e, (3, n)).astype(np.int32)
    rows[1] = rng.integers(0, 2, n)          # two experts take everything
    rows[2] = np.sort(rows[2])
    fn = functools.partial(ref_moe._rank_in_expert, e=e)
    want = np.stack([np.asarray(jax.jit(fn)(jnp.asarray(r))) for r in rows])
    got = port_moe._rank_in_expert(torch.from_numpy(rows).long(), e)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    one = port_moe._rank_in_expert(torch.from_numpy(rows[0]).long(), e)
    np.testing.assert_array_equal(one.numpy(), want[0])


# ------------------------------------------------------------ apply_moe

@pytest.mark.parametrize("cf", [0.25, 1.25, 16.0])
@pytest.mark.parametrize("dispatch", ["grouped", "global"])
def test_apply_moe_float32_matches_reference(dispatch, cf):
    rdims, pdims = dims_pair(cf, dispatch)
    params = ref_params()
    x = inputs((B, S, D))
    y, aux = ref_call(ref_moe_fn(rdims), params, jnp.asarray(x))
    ty, taux = port_moe.apply_moe(port_params(params), torch.from_numpy(x),
                                  pdims)
    assert ty.shape == (B, S, D) and ty.dtype == torch.float32
    scale = np.abs(host(y)).max()
    np.testing.assert_allclose(host(ty), host(y), rtol=1e-5,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(taux.item(), float(aux), rtol=1e-6)


def xla_einsum(eq, a, b):
    """The einsum of two 16-bit tensors as XLA forms it (the reference's
    dot, compiled as written), back as a torch tensor of a's dtype."""
    fn = ref_compiled(lambda u, v: jnp.einsum(eq, u, v),
                      (tuple(a.shape), jnp.bfloat16),
                      (tuple(b.shape), jnp.bfloat16))
    out = fn(jnp.asarray(host(a)).astype(jnp.bfloat16),
             jnp.asarray(host(b)).astype(jnp.bfloat16))
    return torch.tensor(host(out)).to(a.dtype)


@pytest.mark.parametrize("cf", [0.25, 1.25, 16.0])
@pytest.mark.parametrize("dispatch", ["grouped", "global"])
def test_apply_moe_bfloat16_equals_reference_bit_for_bit(dispatch, cf,
                                                         monkeypatch):
    """Routing, ranks, capacity drops, the dispatch, silu and the k-fold
    combine round as the reference's: with XLA's dot for the products the
    outputs are equal in bits. With torch's own products, at most 1e-3 of
    the elements differ (a product's float32 sum order), within 2e-2."""
    rdims, pdims = dims_pair(cf, dispatch)
    params = ref_params()
    x = inputs((B, S, D), seed=2)
    y, aux = ref_call(ref_moe_fn(rdims), params,
                      jnp.asarray(x).astype(jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    plain, _ = port_moe.apply_moe(port_params(params), xt, pdims)
    monkeypatch.setattr(port_moe, "einsum", xla_einsum)
    ty, taux = port_moe.apply_moe(port_params(params), xt, pdims)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_array_equal(host(ty), host(y))
    assert taux.item() == float(aux)
    np.testing.assert_allclose(host(plain), host(y), rtol=2e-2, atol=2e-2)
    assert (host(plain) != host(y)).mean() <= 1e-3


def test_combine_folds_the_k_slots_in_order():
    """bfloat16: the fold left to right equals the reference's scatter-add
    into zeros (moe.py's combine) bit for bit; one float32 sum rounded
    once does not."""
    rng = np.random.default_rng(3)
    n, k, d = 64, 4, 64
    parts = rng.normal(0, 1, (n, k, d)).astype(np.float32)
    jp = jnp.asarray(parts).astype(jnp.bfloat16)
    tok = jnp.repeat(jnp.arange(n), k)
    want = ref_call(lambda v: jnp.zeros((n, d), v.dtype).at[tok].add(
        v.reshape(n * k, d)), jp)
    o = torch.from_numpy(parts).to(torch.bfloat16).reshape(1, n * k, 1, d)
    slot = torch.arange(n * k).reshape(1, n * k)
    keep = torch.ones(1, n * k, dtype=torch.bool)
    got = port_moe._combine(o, slot, keep, torch.ones(1, n, k))
    np.testing.assert_array_equal(host(got[0]), host(want))
    once = torch.tensor(host(jp)).sum(1).to(torch.bfloat16)
    assert (host(once) != host(want)).any()


def test_dispatch_writes_only_the_kept_assignments():
    """A capacity of 1 a expert: every dropped assignment leaves the slot
    of the kept one it would have overwritten as it was."""
    x = torch.arange(1, 7, dtype=torch.float32).reshape(1, 6, 1)
    idx = torch.tensor([[[0], [1], [0], [0], [1], [2]]])
    buf, slot, keep = port_moe._dispatch(x, idx, 1, 3)
    assert buf.shape == (1, 3, 1, 1)
    np.testing.assert_array_equal(buf.reshape(-1).numpy(), [1, 2, 6])
    np.testing.assert_array_equal(keep.numpy(),
                                  [[True, True, False, False, False, True]])
    np.testing.assert_array_equal(slot.numpy(), [[0, 1, 0, 0, 1, 2]])


@pytest.mark.parametrize("cf", [0.25, 16.0])
@pytest.mark.parametrize("dispatch", ["grouped", "global"])
def test_apply_moe_gradients_match_reference(dispatch, cf):
    """d/dx and d/dweights of Σ y·r + aux in float32."""
    rdims, pdims = dims_pair(cf, dispatch)
    params = ref_params()
    x = inputs((B, S, D), seed=4)
    r = inputs((B, S, D), seed=5)

    def ref_loss(p, x):
        y, aux = ref_moe.apply_moe(p, x, rdims)
        return jnp.sum(y * r) + aux
    want = ref_call(jax.grad(ref_loss, argnums=(0, 1)), params,
                    jnp.asarray(x))
    tp = port_params(params, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    y, aux = port_moe.apply_moe(tp, tx, pdims)
    (torch.sum(y * torch.from_numpy(r)) + aux).backward()
    got = {**{n: t.grad for n, t in tp.items()}, "x": tx.grad}
    ref = {**want[0], "x": want[1]}
    assert sorted(got) == sorted(ref)
    for name in got:
        w = host(ref[name])
        scale = np.abs(w).max()
        assert scale > 0, name
        assert np.abs(host(got[name]) - w).max() <= 1e-4 * scale, name


def test_bf16_grad_is_the_identity_with_a_rounded_cotangent():
    g = inputs((4, 33), seed=6) * 1e3
    x = torch.tensor(inputs((4, 33)), requires_grad=True)
    y = port_moe.bf16_grad(x)
    assert torch.equal(y, x)
    y.backward(torch.from_numpy(g))
    want = jax.vjp(ref_moe.bf16_grad, jnp.asarray(host(x)))[1](
        jnp.asarray(g))[0]
    assert x.grad.dtype == torch.float32
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    assert (x.grad.numpy() != g).any()


# ------------------------------------------------------------ tests/test_moe.py on the port

def port_setup(e=8, k=2, d=32, f=16, cf=8.0, dispatch="grouped", seed=0):
    dims = port_moe.MoEDims(d, f, e, k, cf, dispatch)
    moe = port_moe.MoE(ParamFactory(torch.Generator().manual_seed(seed)),
                       dims)
    return dims, {n: t.detach() for n, t in moe.named_parameters()}


def test_grouped_equals_global_with_ample_capacity():
    dims_g, params = port_setup(cf=16.0)
    dims_G = dataclasses.replace(dims_g, dispatch="global")
    x = torch.randn(4, 64, 32, generator=torch.Generator().manual_seed(1))
    y1, aux1 = port_moe.apply_moe(params, x, dims_g)
    y2, aux2 = port_moe.apply_moe(params, x, dims_G)
    torch.testing.assert_close(y1, y2, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(aux1, aux2, rtol=1e-5, atol=0)


def test_matches_dense_reference():
    """Both dispatches match every expert run on every token, mixed by the
    top-k weights."""
    d, f, e, k = 16, 8, 4, 2
    dims, params = port_setup(e, k, d, f, cf=16.0)
    x = torch.randn(2, 32, d, generator=torch.Generator().manual_seed(2))
    xt = x.reshape(-1, d)
    probs = torch.softmax(xt @ params["router"], dim=-1)
    gw, gi = torch.topk(probs, k)
    gw = gw / gw.sum(-1, keepdim=True)
    h = torch.einsum("td,edf->etf", xt, params["wi"])
    g = torch.einsum("td,edf->etf", xt, params["wg"])
    o = torch.einsum("etf,efd->etd", torch.nn.functional.silu(g) * h,
                     params["wo"])
    ref = torch.zeros_like(xt)
    for j in range(k):
        ref = ref + gw[:, j:j + 1] * o[gi[:, j], torch.arange(xt.shape[0])]
    for dispatch in ("grouped", "global"):
        y, _ = port_moe.apply_moe(params, x,
                                  dataclasses.replace(dims,
                                                      dispatch=dispatch))
        torch.testing.assert_close(y.reshape(-1, d), ref, rtol=2e-3,
                                   atol=2e-4)


def test_capacity_drops_bounded():
    dims, params = port_setup(8, 2, 32, 16, cf=0.25)
    x = torch.randn(2, 64, 32, generator=torch.Generator().manual_seed(3))
    y, aux = port_moe.apply_moe(params, x, dims)
    assert torch.isfinite(y).all() and y.abs().max().item() < 1e3
    assert np.isfinite(aux.item())
    gi = port_moe._route(params, x.reshape(-1, 32), dims)[1].reshape(2, -1)
    kept = (port_moe._rank_in_expert(gi, 8) < 5).sum().item()
    assert kept < gi.numel()           # capacity int(0.25·64·2/8)+1 = 5


def test_aux_loss_balanced_router_near_one():
    """A uniform router gives aux = E·Σ (k/E)·(1/E) = k (ties go to the
    lower experts, so the fractions are not k/E each: aux stays k)."""
    e, k = 8, 2
    dims, params = port_setup(e, k, 32, 16, cf=8.0)
    params["router"] = torch.zeros_like(params["router"])
    x = torch.randn(2, 128, 32, generator=torch.Generator().manual_seed(4))
    _, aux = port_moe.apply_moe(params, x, dims)
    assert 0.5 * k <= aux.item() <= 2.0 * k


def test_moe_active_params():
    cfg = get_config("qwen3-moe-235b-a22b")
    active = cfg.active_param_count()
    assert 1.5e10 <= active <= 3.0e10, f"active {active:.3e} (expected ~22B)"
    assert active == ref_get_config("qwen3-moe-235b-a22b").active_param_count()


def test_moe_init_has_the_reference_names_shapes_and_scales():
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(),
                              n_layers=2, d_model=256, moe_d_ff=128)
    model = port_model.init_params(cfg, torch.Generator().manual_seed(0))
    named = dict(model.named_parameters())
    assert [n for n in named if ".moe." in n] == [
        "layers.0.moe.router", "layers.0.moe.wi", "layers.0.moe.wg",
        "layers.0.moe.wo"]
    e = cfg.n_experts
    assert named["layers.0.moe.router"].shape == (2, 256, e)
    assert named["layers.0.moe.wi"].shape == (2, e, 256, 128)
    assert named["layers.0.moe.wo"].shape == (2, e, 128, 256)
    for name, std in [("router", 0.02), ("wi", e ** -0.5), ("wg", e ** -0.5),
                      ("wo", e ** -0.5)]:
        got = named[f"layers.0.moe.{name}"].std().item()
        assert abs(got / std - 1) < 0.1, (name, got, std)
    assert (model.layers[0].norm2 == 1).all()


# ------------------------------------------------------------ state

def test_reference_moe_params_and_int8_opt_state_carry_over():
    """An MoE tree through `state`: the reference's parameters and its int8
    optimizer state after one update, the router's last axis 40 (granite's
    expert count, padded to a block of 128), equal leaf for leaf."""
    from repro.models import model as ref_model
    from repro.train import optim as ref_optim
    from repro_torch.checkpoint.ckpt import flatten_with_paths
    from repro_torch.state import (lm_params_from_reference,
                                   opt_state_from_reference)
    ref_cfg = dataclasses.replace(
        ref_get_config("granite-moe-3b-a800m").reduced(), n_experts=40)
    cfg = dataclasses.replace(
        get_config("granite-moe-3b-a800m").reduced(), n_experts=40)
    params = jax.jit(lambda k: ref_model.init_params(ref_cfg, k)[0])(
        jax.random.PRNGKey(1))
    ocfg = ref_optim.OptConfig(moments_dtype="int8")
    opt = jax.jit(functools.partial(ref_optim.init_opt_state, cfg=ocfg))(
        params)
    _, opt, _ = jax.jit(functools.partial(ref_optim.adamw_update, cfg=ocfg))(
        jax.tree.map(lambda p: p * 0.5, params), opt, params)
    opt_np = jax.tree.map(np.asarray, opt)
    assert opt_np["m"]["layers"][0]["moe"]["router"]["q"].shape[-1] == 40
    assert opt_np["m"]["layers"][0]["moe"]["router"]["scale"].shape[-1] == 1
    port = opt_state_from_reference(cfg, opt_np, "cpu")
    for (path, t), (_, w) in zip(flatten_with_paths(port),
                                 flatten_with_paths(opt_np)):
        assert str(t.dtype).endswith(str(w.dtype)), path
        np.testing.assert_array_equal(t.numpy(), w, err_msg=path)
    model = port_model.empty(cfg, "cpu")
    model.load_state_dict(lm_params_from_reference(
        cfg, jax.tree.map(np.asarray, params), "cpu"), assign=True)
    for (path, t), (_, w) in zip(flatten_with_paths(model.param_tree()),
                                 flatten_with_paths(params)):
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(w),
                                      err_msg=path)


# ------------------------------------------------------------ entry points

@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "qwen3-moe-235b-a22b"])
def test_launch_serve_and_train_run_the_moe_archs(arch, tmp_path, capsys):
    serve_launch.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8",
                       "--new-tokens", "4"])
    train_launch.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--steps", "2", "--policy", "lowmem",
                       "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[serve] 8 tokens in" in out and "output (2, 12) on cpu" in out
    assert out.strip().splitlines()[-1].startswith("[train] done: first ")


def test_serving_forward_returns_the_layers_aux():
    """Prefill sums the layers' aux as the train forward does (float32,
    the same value); decode's one-token step drops nothing."""
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(),
                              n_layers=2)
    model = port_model.init_params(cfg, torch.Generator().manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        _, _, want = model(toks, compute_dtype=torch.float32)
    caches = port_model.init_cache(cfg, 2, 17, torch.float32, "cpu")
    _, _, aux = model(toks, "prefill", caches, compute_dtype=torch.float32)
    assert aux.dtype == torch.float32 and aux.item() > 0
    assert torch.equal(aux, want)
    _, _, aux1 = model(toks[:, :1], "decode", caches, 16, torch.float32)
    assert aux1.item() > 0
