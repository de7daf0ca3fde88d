"""The port's AdamW (`repro_torch.train.optim`) against the reference's
(`repro.train.optim`) on the CPU, given the same gradients: the schedule,
the int8 block quantization, the state's tree, and five update steps with
clipping binding under float32 and int8 moments, over a tree whose leaves
have last axes that are not multiples of the 128-wide block. Plus the port
counterparts of the reference's own optimizer tests
(tests/test_substrate.py).

Tolerances: the schedule, params, float32 moments, the int8 scales, lr and
grad_norm within rtol 1e-6 (float32 ops in the same order; a reduction's
summation order and a transcendental's last ulp may differ), moments with
an atol of 1e-6 times their leaf's largest magnitude besides (b1·m +
(1 - b1)·g cancels near zero, where an ulp of its operands is a large
relative error); int8 `q` equal except ±1 at a rounding tie, on a handful
of elements.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro.train import optim as ref_optim
from repro_torch.checkpoint.ckpt import flatten_with_paths
from repro_torch.configs import get_config
from repro_torch.state import opt_state_from_reference
from repro_torch.train import optim as port_optim

SHAPES = {"embed": (40, 300), "final_norm": (130,),
          "layers": ({"attn": {"wq": (3, 64, 2, 16)},
                      "norm1": (3, 256)},)}
N_STEPS = 5


def host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def tree_of(shapes, fn):
    if isinstance(shapes, dict):
        return {k: tree_of(v, fn) for k, v in shapes.items()}
    if isinstance(shapes, tuple) and shapes and not isinstance(shapes[0],
                                                                int):
        return tuple(tree_of(v, fn) for v in shapes)
    return fn(shapes)


def draws(seed):
    """Params and N_STEPS gradient trees (norm ~30: clipping binds)."""
    rng = np.random.default_rng(seed)
    params = tree_of(SHAPES, lambda s: rng.normal(0, 0.5, s).astype(
        np.float32))
    grads = [tree_of(SHAPES, lambda s: rng.normal(0, 0.2, s).astype(
        np.float32)) for _ in range(N_STEPS)]
    return params, grads


def to_port(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@functools.lru_cache(maxsize=None)
def ref_run(moments):
    cfg = ref_optim.OptConfig(lr=1e-2, warmup_steps=2, decay_steps=8,
                              moments_dtype=moments)
    params, grads = draws(0)
    params = jax.tree.map(jnp.asarray, params)
    opt = ref_optim.init_opt_state(params, cfg)
    metrics = []
    for g in grads:
        params, opt, m = ref_optim.adamw_update(
            jax.tree.map(jnp.asarray, g), opt, params, cfg)
        metrics.append((float(m["lr"]), float(m["grad_norm"])))
    return cfg, jax.tree.map(np.asarray, params), \
        jax.tree.map(np.asarray, opt), metrics


def port_run(moments):
    cfg = port_optim.OptConfig(lr=1e-2, warmup_steps=2, decay_steps=8,
                               moments_dtype=moments)
    params, grads = draws(0)
    params = to_port(params)
    opt = port_optim.init_opt_state(params, cfg)
    metrics = []
    for g in grads:
        out, opt, m = port_optim.adamw_update(to_port(g), opt, params, cfg)
        assert out is params
        metrics.append((m["lr"].item(), m["grad_norm"].item()))
    return params, opt, metrics


# ------------------------------------------------------------ pieces

def test_schedule_matches_reference():
    for cfg_kw in ({}, {"warmup_steps": 0, "decay_steps": 50},
                   {"warmup_steps": 20, "decay_steps": 100, "lr": 1e-3}):
        ref_cfg = ref_optim.OptConfig(**cfg_kw)
        cfg = port_optim.OptConfig(**cfg_kw)
        steps = np.array([0, 1, 2, 7, 19, 20, 21, 50, 99, 100, 199, 200, 201,
                          5000, 9999, 10_000, 20_000], np.int32)
        want = np.asarray(ref_optim.schedule(ref_cfg, jnp.asarray(steps)))
        got = port_optim.schedule(cfg, torch.from_numpy(steps))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(host(got), want, rtol=1e-6)


@pytest.mark.parametrize("shape", [(300,), (3, 128), (2, 3, 130), (5, 1)])
def test_quantize_i8_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.normal(0, 1, shape) * rng.lognormal(0, 2, shape[-1])).astype(
        np.float32)
    q_ref, s_ref = ref_optim.quantize_i8(jnp.asarray(x), 128)
    q, s = port_optim.quantize_i8(torch.from_numpy(x), 128)
    assert q.dtype == torch.int8 and tuple(q.shape) == shape
    assert tuple(s.shape) == s_ref.shape == shape[:-1] + (-(-shape[-1] //
                                                            128),)
    np.testing.assert_allclose(host(s), np.asarray(s_ref), rtol=1e-6)
    assert np.abs(host(q).astype(int) - np.asarray(q_ref).astype(int)
                  ).max() <= 1
    back = port_optim.dequantize_i8(q, s, 128)
    want = ref_optim.dequantize_i8(q_ref, s_ref, 128)
    np.testing.assert_allclose(host(back), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * np.abs(x).max())


def test_quantize_rounds_half_to_even():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]])
    q, s = port_optim.quantize_i8(x, 128)
    assert s.item() == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2]]


@pytest.mark.parametrize("moments", ["f32", "int8"])
def test_init_opt_state_keeps_the_reference_tree(moments):
    params, _ = draws(1)
    ref = ref_optim.init_opt_state(jax.tree.map(jnp.asarray, params),
                                   ref_optim.OptConfig(moments_dtype=moments))
    port = port_optim.init_opt_state(
        to_port(params), port_optim.OptConfig(moments_dtype=moments))
    want = [(p, a.shape, str(a.dtype)) for p, a in flatten_with_paths(
        jax.tree.map(np.asarray, ref))]
    got = [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in flatten_with_paths(port)]
    assert got == want
    assert all(not t.any() for _, t in flatten_with_paths(port))


def test_global_norm_sums_leaves_in_the_reference_order():
    params, _ = draws(2)
    want = float(ref_optim.global_norm(jax.tree.map(jnp.asarray, params)))
    got = port_optim.global_norm(to_port(params))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


# ------------------------------------------------------------ the update

@pytest.mark.parametrize("moments", ["f32", "int8"])
def test_adamw_update_matches_reference_given_the_same_gradients(moments):
    _, want_p, want_o, want_m = ref_run(moments)
    params, opt, metrics = port_run(moments)
    # clipping binds at every step
    assert all(gn > 1.0 for _, gn in want_m)
    np.testing.assert_allclose(np.array(metrics), np.array(want_m),
                               rtol=1e-6)
    assert opt["step"].dtype == torch.int32 and opt["step"].item() == N_STEPS
    for (path, p), (_, w) in zip(flatten_with_paths(params),
                                 flatten_with_paths(want_p)):
        np.testing.assert_allclose(host(p), w, rtol=1e-6, atol=1e-7,
                                   err_msg=path)
    got_o = flatten_with_paths({"m": opt["m"], "v": opt["v"]})
    ref_o = flatten_with_paths({"m": want_o["m"], "v": want_o["v"]})
    assert [p for p, _ in got_o] == [p for p, _ in ref_o]
    off_by_one = 0
    for (path, t), (_, w) in zip(got_o, ref_o):
        if path.endswith("/q"):
            diff = np.abs(host(t).astype(int) - w.astype(int))
            assert diff.max() <= 1, path
            off_by_one += int((diff == 1).sum())
        else:
            np.testing.assert_allclose(host(t), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=path)
    assert off_by_one <= 8, off_by_one


def test_opt_state_from_reference_carries_the_int8_state():
    cfg = get_config("qwen2-1.5b").reduced()
    sds, _ = ref_model.abstract_params(ref_get_config("qwen2-1.5b").reduced())
    params = jax.tree.map(lambda s: jnp.ones(s.shape, s.dtype), sds)
    ocfg = ref_optim.OptConfig(moments_dtype="int8")
    opt = ref_optim.init_opt_state(params, ocfg)
    _, opt, _ = jax.jit(functools.partial(ref_optim.adamw_update, cfg=ocfg))(
        jax.tree.map(lambda p: p * 0.5, params), opt, params)
    opt_np = jax.tree.map(np.asarray, opt)
    port = opt_state_from_reference(cfg, opt_np, "cpu")
    for (path, t), (_, w) in zip(flatten_with_paths(port),
                                 flatten_with_paths(opt_np)):
        assert str(t.dtype).endswith(str(w.dtype)), path
        np.testing.assert_array_equal(host(t), w, err_msg=path)
    with pytest.raises(ValueError, match="parameters"):
        opt_state_from_reference(cfg, {"m": {"embed": opt_np["m"]["embed"]},
                                       "v": opt_np["v"],
                                       "step": opt_np["step"]}, "cpu")


# ------------------------------------------------------------ the reference's own tests

def test_adamw_converges_quadratic():
    cfg = port_optim.OptConfig(lr=0.1, warmup_steps=1, decay_steps=200,
                               weight_decay=0.0, clip_norm=100.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = port_optim.init_opt_state(params, cfg)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}       # d/dw ||w||²
        params, opt, m = port_optim.adamw_update(grads, opt, params, cfg)
    assert params["w"].abs().max().item() < 0.15


def test_adamw_int8_converges_like_f32():
    """int8-moment Adam reaches the same optimum as f32 Adam (trajectories
    may transiently diverge — Adam is sign-like early — but both must land
    on the quadratic's minimum w* = -0.2)."""
    rng = np.random.default_rng(0)
    w0 = rng.normal(0, 1, (4, 256)).astype(np.float32)
    finals = {}
    for name, dt in (("f32", "f32"), ("int8", "int8")):
        cfg = port_optim.OptConfig(lr=0.05, warmup_steps=1, decay_steps=400,
                                   weight_decay=0.0, moments_dtype=dt)
        p = {"w": torch.from_numpy(w0.copy())}
        o = port_optim.init_opt_state(p, cfg)
        for _ in range(250):
            g = {"w": p["w"] * 0.5 + 0.1}     # minimum at w* = -0.2
            p, o, _ = port_optim.adamw_update(g, o, p, cfg)
        finals[name] = p["w"]
    for name, w in finals.items():
        err = (w + 0.2).abs().max().item()
        assert err < 0.05, f"{name} did not converge: {err}"


def test_grad_clipping():
    cfg = port_optim.OptConfig(lr=1e-3, clip_norm=1.0)
    params = {"w": torch.zeros(3)}
    opt = port_optim.init_opt_state(params, cfg)
    _, _, m = port_optim.adamw_update({"w": torch.full((3,), 1e6)}, opt,
                                      params, cfg)
    assert m["grad_norm"].item() > 1e5  # reported raw norm


def test_update_writes_bfloat16_params_in_place():
    """The lowmem policy's bfloat16 parameters are updated in float32 and
    rounded back into the same tensors."""
    cfg = port_optim.OptConfig(lr=1e-2, warmup_steps=1, moments_dtype="int8")
    w = torch.ones(2, 200, dtype=torch.bfloat16)
    ptr = w.data_ptr()
    params = {"w": w}
    opt = port_optim.init_opt_state(params, cfg)
    q_ptr = opt["m"]["w"]["q"].data_ptr()
    port_optim.adamw_update({"w": torch.ones(2, 200, dtype=torch.bfloat16)},
                            opt, params, cfg)
    assert params["w"] is w and w.data_ptr() == ptr and w.dtype == torch.bfloat16
    assert opt["m"]["w"]["q"].data_ptr() == q_ptr
    assert (w < 1).all()
