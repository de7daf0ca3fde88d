"""The port's cross-attention (`repro_torch.models.attention.
cross_attention`, the `xattn` layers and `vision_proj`) and audio
codebooks (the [K, V, D] embedding summed over K streams, the [K, D, V]
head, logits [B, K, S, V]) against the reference on the CPU, through the
model, serving, training, the state carriers, checkpoints and the
launchers.

llama-3.2-vision-90b reduced is one period of 5 layers (4 attention, 1
cross-attention to an 8-token vision source of width 32); musicgen-large
reduced is its 1-layer pattern, here 2 layers (4 codebooks of 128).
Weights are the reference's `init_params` with every `xattn/gate` set to
0.5 before both packages load them: at its zero init tanh(0) makes the
layer's output, and the gradient of every xattn weight but the gate,
exactly 0, so a parity test would hold nothing there
(`test_zero_gate_matches_the_reference` keeps the zero gate). Inputs are
numpy from a seed: tokens, labels and the vision source.

Tolerances: float32 compute rtol/atol 1e-4 on logits (the cross-attention
alone rtol 1e-5, its gradients 1e-5 of the leaf's largest), bfloat16 2e-2
(the reference's own, tests/test_models_smoke.py); every gradient leaf
max |diff| <= 1e-4·max|leaf| at float32, the gradient norm within 5e-2 at
bfloat16; greedy tokens exactly. The reference runs compiled with XLA's
excess precision off (see tests/test_torch_lm_model.py), except the
engine held to tests/test_engine_extra.py, which runs as that test runs
it (jitted with the defaults). In bfloat16, musicgen's logits are held
with the self-attention's RoPE projections and chunked softmax computed
by the reference's (`reference_attention` says why); the vision arch's
bfloat16 logits are held as the port computes them.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import model as ref_model
from repro.serve import engine as ref_engine
from repro.train import optim as ref_optim
from repro.train import step as ref_step
from repro_torch.checkpoint import ckpt as port_ckpt
from repro_torch.checkpoint.ckpt import flatten_with_paths
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import attention as port_attn
from repro_torch.models import model as port_model
from repro_torch.serve import engine as port_engine
from repro_torch.state import (lm_params_from_reference,
                               opt_state_from_reference)
from repro_torch.train import optim as port_optim
from repro_torch.train import step as port_step

jax.config.update("jax_default_matmul_precision", "float32")

VISION, AUDIO = "llama-3.2-vision-90b", "musicgen-large"
ARCHS = [VISION, AUDIO]
B, S, PREFILL, DECODES = 2, 16, 8, 6
GATE = 0.5
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
AS_WRITTEN = {"xla_allow_excess_precision": False}
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=10)


def ref_compiled(fn, *args):
    """fn jitted and compiled for `args` with bfloat16 rounded as written."""
    return jax.jit(fn).lower(*args).compile(compiler_options=AS_WRITTEN)


def host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def cfgs(arch):
    """Both configs reduced: the vision arch to its 5-layer period,
    musicgen to 2 layers."""
    n = 2 if arch == AUDIO else len(get_config(arch).pattern)
    return (dataclasses.replace(ref_get_config(arch).reduced(), n_layers=n),
            dataclasses.replace(get_config(arch).reduced(), n_layers=n))


def set_gates(params_np, value):
    """Every xattn layer's gate [R] set to `value`, in place."""
    for layer in params_np["layers"]:
        if "xattn" in layer:
            layer["xattn"]["gate"] = np.full_like(layer["xattn"]["gate"],
                                                  value)
    return params_np


def port_from(cfg, params_np, dtype=torch.float32):
    model = port_model.empty(cfg, "cpu", dtype)
    model.load_state_dict(lm_params_from_reference(cfg, params_np, "cpu"),
                          assign=True)
    return model


@functools.lru_cache(maxsize=None)
def ref_params(arch, gate=GATE, policy="f32"):
    """The reference's init_params as numpy, the gates set; cast to
    bfloat16 for the lowmem policy."""
    ref_cfg, _ = cfgs(arch)
    params, _ = ref_model.init_params(ref_cfg, jax.random.PRNGKey(7))
    params = set_gates(jax.tree.map(np.asarray, params), gate)
    if policy == "lowmem":
        params = jax.tree.map(lambda a: np.asarray(a, jnp.bfloat16), params)
    return params


@functools.lru_cache(maxsize=None)
def weights(arch, gate=GATE):
    """The reference's parameters and the port model carrying them."""
    params = ref_params(arch, gate)
    return params, port_from(cfgs(arch)[1], params)


def inputs(cfg, seed=11, s=S):
    """Tokens [B, S] ([B, K, S] audio), labels of the same shape, and the
    vision source [B, n_vision_tokens, d_vision] (None without one)."""
    rng = np.random.default_rng(seed)
    shape = (B, cfg.n_codebooks, s) if cfg.n_codebooks else (B, s)
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    vision = (rng.normal(0, 1, (B, cfg.n_vision_tokens, cfg.d_vision))
              .astype(np.float32) if cfg.n_vision_tokens else None)
    return toks, labels, vision


_COMPILED = {}


def _jnp(t: torch.Tensor):
    a = jnp.asarray(t.detach().float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


def _ref_call(key, fn, *tensors):
    """fn over the tensors through the reference, compiled as written; the
    result in the first tensor's dtype."""
    args = [_jnp(t) for t in tensors]
    key = (key,) + tuple((a.shape, a.dtype) for a in args)
    if key not in _COMPILED:
        _COMPILED[key] = jax.jit(fn).lower(*args).compile(
            compiler_options=AS_WRITTEN)
    out = _COMPILED[key](*args)
    return torch.from_numpy(np.array(out.astype(jnp.float32))).to(
        tensors[0].dtype)


def _ref_project_qkv(p, x, dims, positions):
    names = sorted(p)
    rd = ref_attn.AttnDims(*dataclasses.astuple(dims))
    return tuple(_ref_call(
        ("qkv", i, rd, tuple(names)),
        lambda x, pos, *ws, i=i: ref_attn._project_qkv(
            dict(zip(names, ws)), x, rd, pos)[i],
        x, positions, *(p[n] for n in names)) for i in range(3))


def _ref_chunked(q, k, v, q_chunk=512, k_chunk=1024):
    return _ref_call(("chunked", q_chunk, k_chunk),
                     lambda q, k, v: ref_attn.chunked_causal_attention(
                         q, k, v, q_chunk, k_chunk), q, k, v)


@contextlib.contextmanager
def reference_attention(active: bool = True):
    """While active, the port's self-attention projections with RoPE
    (`_project_qkv`) and chunked softmax (`chunked_causal_attention`) are
    the reference's, forward only. XLA's CPU sin, cos and exp are
    approximations (and its fusions pick their own): float32 results a
    few ulps from torch's now and then flip a bfloat16 rounding, and
    musicgen's head (scale 1/√K = 0.5, four times a dense head's at these
    widths) spreads one flip into logits ~0.1 apart. Their float32
    arithmetic is held in tests/test_torch_lm_model.py; substituted, the
    bfloat16 hold checks the rest of the port's bfloat16 program (the
    codebook sum and heads among it) bit for bit."""
    if not active:
        yield
        return
    saved = port_attn._project_qkv, port_attn.chunked_causal_attention
    port_attn._project_qkv = _ref_project_qkv
    port_attn.chunked_causal_attention = _ref_chunked
    try:
        with torch.no_grad():
            yield
    finally:
        port_attn._project_qkv, port_attn.chunked_causal_attention = saved


@functools.lru_cache(maxsize=None)
def ref_program(arch, dtype_name, kind):
    """The reference's train forward, prefill, decode forward or
    decode_step, compiled for the arch's parameter shapes (any gate) and
    `inputs()`."""
    ref_cfg, _ = cfgs(arch)
    jdt, _, _ = DTYPES[dtype_name]
    params = ref_params(arch)
    toks, _, vision = inputs(ref_cfg)
    jt, jv = jnp.asarray(toks), None if vision is None else jnp.asarray(vision)
    rc = ref_model.init_cache(ref_cfg, B, S, dtype=jnp.float32)
    if kind == "train":
        return ref_compiled(lambda p, t, v: ref_model.forward(
            p, ref_cfg, t, "train", vision=v, compute_dtype=jdt,
            remat=False)[0], params, jt, jv)
    if kind == "prefill":
        return ref_compiled(lambda p, t, c, v: ref_model.prefill(
            p, ref_cfg, t, c, vision=v, compute_dtype=jdt), params,
            jt[..., :PREFILL], rc, jv)
    if kind == "decode":
        return ref_compiled(lambda p, t, c, pos, v: ref_model.forward(
            p, ref_cfg, t, "decode", caches=c, pos=pos, vision=v,
            compute_dtype=jdt)[:2], params, jt[..., :1], rc, jnp.int32(0),
            jv)
    return ref_compiled(lambda p, t, c, pos, v: ref_model.decode_step(
        p, ref_cfg, t, c, pos, vision=v, compute_dtype=jdt)[0],
        params, jt[..., :1], rc, jnp.int32(0), jv)


@functools.lru_cache(maxsize=None)
def runs(arch, dtype_name, gate=GATE, steps=True):
    """Both packages' logits and caches: the teacher-forced forward over S,
    and with `steps` prefill of PREFILL tokens, DECODES decode steps, and
    decode_step's tokens after them."""
    ref_cfg, port_cfg = cfgs(arch)
    _, tdt, _ = DTYPES[dtype_name]
    params, model = weights(arch, gate)
    toks, _, vision = inputs(ref_cfg)
    jt, jv = jnp.asarray(toks), None if vision is None else jnp.asarray(vision)
    tt = torch.from_numpy(toks)
    tv = None if vision is None else torch.from_numpy(vision)
    out = {"ref": {}, "port": {}}
    prog = functools.partial(ref_program, arch, dtype_name)

    out["ref"]["train"] = host(prog("train")(params, jt, jv))
    attn = functools.partial(reference_attention, arch == AUDIO
                             and dtype_name == "bfloat16")
    with attn():
        out["port"]["train"] = host(port_model.forward(
            model, port_cfg, tt, "train", compute_dtype=tdt, vision=tv)[0])

    if not steps:
        return out
    rc = ref_model.init_cache(ref_cfg, B, S, dtype=jnp.float32)
    logits, rc = prog("prefill")(params, jt[..., :PREFILL], rc, jv)
    ref_logits = [host(logits)]
    for t in range(PREFILL, PREFILL + DECODES):
        logits, rc = prog("decode")(params, jt[..., t:t + 1], rc,
                                    jnp.int32(t), jv)
        ref_logits.append(host(logits))
    last = PREFILL + DECODES
    if dtype_name == "float32":   # the greedy tokens are held in float32
        out["ref"]["next"] = np.asarray(prog("decode_step")(
            params, jt[..., last:last + 1], rc, jnp.int32(last), jv))
    out["ref"]["steps"] = np.concatenate(ref_logits, axis=-2)
    out["ref"]["cache"] = [[host(x) for x in c] for c in rc]

    tc = port_model.init_cache(port_cfg, B, S, dtype=torch.float32,
                               device="cpu")
    with attn():
        logits, tc = port_model.prefill(model, port_cfg,
                                        tt[..., :PREFILL], tc,
                                        compute_dtype=tdt, vision=tv)
        port_logits = [host(logits)]
        for t in range(PREFILL, PREFILL + DECODES):
            logits, tc, _ = port_model.forward(
                model, port_cfg, tt[..., t:t + 1], "decode", tc, t,
                tdt, vision=tv)
            port_logits.append(host(logits))
    out["port"]["steps"] = np.concatenate(port_logits, axis=-2)
    out["port"]["cache"] = [[host(x) for x in c] for c in tc]
    if dtype_name == "float32":
        nxt, _ = port_model.decode_step(
            model, port_cfg, tt[..., last:last + 1],
            [type(c)(*(x.clone() for x in c)) for c in tc], last, tdt,
            vision=tv)
        out["port"]["next"] = nxt.numpy()
    return out


# ------------------------------------------------------------ cross-attention

XD = ref_attn.AttnDims(32, 4, 2, 8)     # d 32, 4 heads, 2 KV heads, dh 8
XD_PORT = port_attn.AttnDims(32, 4, 2, 8)
D_SOURCE, XS, XT = 24, 6, 10            # a source of 10 tokens of width 24


def xattn_case():
    """One cross-attention layer's weights (the reference's init, the gate
    at GATE), x [2, 6, 32], a source [2, 10, 24] and an output cotangent."""
    from repro.models.common import ParamFactory as RefParamFactory
    params, _ = ref_attn.init_cross_attention(
        RefParamFactory(jax.random.PRNGKey(3)), XD, D_SOURCE)
    params = {k: np.asarray(v) for k, v in params.items()}
    params["gate"] = np.float32(GATE)
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, XS, XD.d_model)).astype(np.float32)
    src = rng.normal(0, 1, (2, XT, D_SOURCE)).astype(np.float32)
    cot = rng.normal(0, 1, (2, XS, XD.d_model)).astype(np.float32)
    return params, x, src, cot


@functools.lru_cache(maxsize=None)
def xattn_ref_program(dtype_name):
    jdt, _, _ = DTYPES[dtype_name]
    params, x, src, cot = xattn_case()

    def ref_loss(p, x, src):
        y = ref_attn.cross_attention(p, x.astype(jdt), src, XD)
        return jnp.sum(y.astype(jnp.float32) * cot), y
    return ref_compiled(
        jax.value_and_grad(ref_loss, argnums=(0, 1, 2), has_aux=True),
        params, x, src)


def xattn_both(dtype_name, gate=GATE):
    """(reference, port) of the output and the gradients of
    sum(out · cot) for the weights (float32, cast inside), x and source."""
    _, tdt, _ = DTYPES[dtype_name]
    params, x, src, cot = xattn_case()
    params["gate"] = np.float32(gate)
    (_, want_y), want_g = xattn_ref_program(dtype_name)(params, x, src)

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    ts = torch.tensor(src, requires_grad=True)
    y = port_attn.cross_attention({k: v.to(tdt) for k, v in tp.items()},
                                  tx.to(tdt), ts, XD_PORT)
    (y.float() * torch.from_numpy(cot)).sum().backward()
    got_g = ({k: tp[k].grad for k in params}, tx.grad, ts.grad)
    return (want_y, want_g), (y, got_g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_forward_and_gradients_match(dtype):
    """Forward and gradients for wq, wk, wv, wo, gate, x and the source:
    float32 rtol 1e-5 (atol 1e-6 of the largest), bfloat16 2e-2."""
    (want_y, want_g), (got_y, got_g) = xattn_both(dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    atol = 1e-6 if dtype == "float32" else 2e-2
    assert got_y.dtype == DTYPES[dtype][1]
    w = host(want_y)
    np.testing.assert_allclose(host(got_y), w, rtol=tol,
                               atol=atol * np.abs(w).max())
    named = [(f"params/{k}", got_g[0][k], want_g[0][k]) for k in want_g[0]]
    named += [("x", got_g[1], want_g[1]), ("source", got_g[2], want_g[2])]
    for name, g, w in named:
        w = host(w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(host(g), w, rtol=tol,
                                   atol=atol * np.abs(w).max(), err_msg=name)


def test_zero_gate_matches_the_reference():
    """At the init's zero gate the layer's output is exactly 0 in both, so
    is every xattn weight's gradient but the gate's, which matches; the
    model's logits equal the reference's there too (float32, 1e-4)."""
    (want_y, want_g), (got_y, got_g) = xattn_both("float32", gate=0.0)
    assert not host(want_y).any() and not host(got_y).any()
    for k in ("wq", "wk", "wv", "wo"):
        assert not host(want_g[0][k]).any() and not host(got_g[0][k]).any()
    w = host(want_g[0]["gate"])
    assert w != 0
    np.testing.assert_allclose(host(got_g[0]["gate"]), w, rtol=1e-5)
    r = runs(VISION, "float32", gate=0.0, steps=False)
    np.testing.assert_allclose(r["port"]["train"], r["ref"]["train"],
                               rtol=1e-4, atol=1e-4)


def test_a_vision_model_without_a_source_raises():
    _, cfg = cfgs(VISION)
    _, model = weights(VISION)
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="xattn layer at pattern position 4"):
        port_model.forward(model, cfg, toks, compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="vision source"):
        port_engine.ServeEngine(cfg, model, port_engine.ServeConfig()
                                ).generate(np.zeros((1, 4), np.int32), 2)


# ------------------------------------------------------------ codebooks

@pytest.mark.parametrize("stored", ["float32", "bfloat16"])
def test_codebook_embed_sum_is_bit_equal_in_bfloat16(stored):
    """The K rows summed in the stored dtype, k = 0..K-1, then cast to
    bfloat16: the reference's bits. From a float32 table, casting the
    table first and summing in bfloat16 gives other bits."""
    ref_cfg, cfg = cfgs(AUDIO)
    rng = np.random.default_rng(2)
    table = (rng.normal(0, 1, (cfg.n_codebooks, cfg.vocab_size, cfg.d_model))
             * 0.02).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, cfg.n_codebooks, 64))
    toks = toks.astype(np.int32)
    jtable = jnp.asarray(table, getattr(jnp, stored))
    want = ref_compiled(lambda e, t: ref_model.embed_tokens(
        {"embed": e}, ref_cfg, t).astype(jnp.bfloat16), jtable, toks)(
            jtable, toks)
    ttable = torch.from_numpy(table).to(getattr(torch, stored))
    got = port_model.embed_tokens({"embed": ttable}, cfg,
                                  torch.from_numpy(toks)).to(torch.bfloat16)
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)
    if stored == "float32":
        cast_first = port_model.embed_tokens(
            {"embed": ttable.to(torch.bfloat16)}, cfg,
            torch.from_numpy(toks))
        assert (cast_first.float().numpy() != want).any()


def test_init_shapes_and_scales():
    """musicgen: embed [K, V, D] at 0.02, the head [K, D, V] at 1/√K (the
    reference's pf.dense takes fan-in from shape[0]); the vision arch:
    vision_proj [d_vision, D] at 1/√d_vision, xattn wk/wv [D, kv, dh] (the
    source arrives projected), the gate zero."""
    cfg = dataclasses.replace(get_config(AUDIO).reduced(), d_model=256)
    m = port_model.init_params(cfg, torch.Generator().manual_seed(0))
    assert m.embed.shape == (4, 128, 256) and m.lm_head.shape == (4, 256, 128)
    assert abs(m.embed.std().item() / 0.02 - 1) < 0.05
    assert abs(m.lm_head.std().item() / 0.5 - 1) < 0.05
    vcfg = dataclasses.replace(get_config(VISION).reduced(), d_vision=256)
    v = port_model.init_params(vcfg, torch.Generator().manual_seed(0))
    x = v.layers[4].xattn
    assert v.vision_proj.shape == (256, 64)
    assert abs(v.vision_proj.std().item() * 16 - 1) < 0.05
    assert x.wq.shape == (1, 64, 4, 16) and x.wk.shape == (1, 64, 2, 16)
    assert x.wo.shape == (1, 4, 16, 64) and x.gate.shape == (1,)
    assert not x.gate.any()
    assert port_model.init_cache(vcfg, 1, 8, device="cpu")[4] == ()


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_tree_maps_one_to_one(arch):
    params, model = weights(arch)
    want = [(p, np.shape(a)) for p, a in flatten_with_paths(params)]
    got = [(p, tuple(t.shape)) for p, t in
           flatten_with_paths(model.param_tree())]
    assert got == want
    names = dict(got)
    if arch == VISION:
        assert names["vision_proj"] == (32, 64)
        assert names["layers/4/xattn/wk"] == (1, 64, 2, 16)
        assert names["layers/4/xattn/gate"] == (1,)
    else:
        assert names["embed"] == (4, 128, 64)
        assert names["lm_head"] == (4, 64, 128)


# ------------------------------------------------------------ the model

CASES = [(a, d) for a in ARCHS for d in DTYPES]


@pytest.mark.parametrize("arch, dtype", CASES)
def test_forward_logits_match_reference(arch, dtype):
    r = runs(arch, dtype)
    _, cfg = cfgs(arch)
    want = (B, 4, S, 128) if arch == AUDIO else (B, S, 128)
    assert r["port"]["train"].shape == want
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(r["port"]["train"], r["ref"]["train"],
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch, dtype", CASES)
def test_prefill_and_decode_logits_match_reference(arch, dtype):
    r = runs(arch, dtype)
    tol = DTYPES[dtype][2]
    assert r["port"]["steps"].shape[-2] == PREFILL + DECODES
    np.testing.assert_allclose(r["port"]["steps"], r["ref"]["steps"],
                               rtol=tol, atol=tol)
    for got, want in zip(r["port"]["cache"], r["ref"]["cache"]):
        assert len(got) == len(want)     # () for the xattn position
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_tokens_equal_reference(arch):
    r = runs(arch, "float32")
    want = (B, 4, 1) if arch == AUDIO else (B, 1)
    assert r["port"]["next"].dtype == np.int32
    assert r["port"]["next"].shape == want
    np.testing.assert_array_equal(r["port"]["next"], r["ref"]["next"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_plus_decode_reproduces_own_forward(arch):
    """The counterpart of tests/test_models_smoke.py::
    test_prefill_then_decode_matches_forward (float32, 2e-2), here at
    1e-4: the cross-attention recomputes K and V from the source at every
    step, the codebooks' caches are a dense model's."""
    r = runs(arch, "float32")
    n = PREFILL + DECODES
    np.testing.assert_allclose(r["port"]["steps"],
                               r["port"]["train"][..., :n, :],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tied_codebook_head_matches_reference(dtype):
    """A tied codebook head (no config ties one; the reference's branch):
    `bsd,kvd->bksv` against the stored table, so the logits promote to
    float32 under bfloat16 compute, as jnp promotes."""
    jdt, tdt, tol = DTYPES[dtype]
    ref_cfg, cfg = (dataclasses.replace(c, n_layers=1, tie_embeddings=True)
                    for c in cfgs(AUDIO))
    params, _ = ref_model.init_params(ref_cfg, jax.random.PRNGKey(4))
    params = jax.tree.map(np.asarray, params)
    assert "lm_head" not in params
    toks, _, _ = inputs(cfg)
    want = ref_compiled(lambda p, t: ref_model.forward(
        p, ref_cfg, t, compute_dtype=jdt, remat=False)[0], params, toks)(
            params, toks)
    with reference_attention(dtype == "bfloat16"):
        got, _, _ = port_model.forward(port_from(cfg, params), cfg,
                                       torch.from_numpy(toks),
                                       compute_dtype=tdt)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(host(got), host(want), rtol=tol, atol=tol)


# ------------------------------------------------------------ the loss

@functools.lru_cache(maxsize=None)
def ref_loss_and_grads(arch, dtype_name):
    ref_cfg, _ = cfgs(arch)
    jdt, _, _ = DTYPES[dtype_name]
    params = ref_params(arch)
    toks, labels, vision = inputs(ref_cfg, seed=3)
    batch = {"tokens": toks, "labels": labels}
    if vision is not None:
        batch["vision"] = vision
    fn = ref_compiled(jax.value_and_grad(
        lambda p, b: ref_model.loss_fn(p, ref_cfg, b, compute_dtype=jdt,
                                       remat=False), has_aux=True),
        params, batch)
    (loss, _), grads = fn(params, batch)
    return float(loss), [(p, host(g)) for p, g in flatten_with_paths(
        jax.tree.map(np.asarray, grads))]


def port_loss_and_grads(arch, dtype_name):
    _, cfg = cfgs(arch)
    _, tdt, _ = DTYPES[dtype_name]
    model = port_from(cfg, ref_params(arch))
    toks, labels, vision = inputs(cfg, seed=3)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    if vision is not None:
        batch["vision"] = torch.from_numpy(vision)
    loss, _ = port_model.loss_fn(model, cfg, batch, compute_dtype=tdt)
    leaves = flatten_with_paths(model.param_tree())
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    return loss, [(path, g) for (path, _), g in zip(leaves, grads)]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_reference_float32(arch):
    want_loss, want = ref_loss_and_grads(arch, "float32")
    loss, got = port_loss_and_grads(arch, "float32")
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, path
        scale = np.abs(w).max()
        assert scale > 0, path     # a nonzero gate: every leaf takes part
        assert np.abs(host(g) - w).max() <= 1e-4 * scale, path


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grad_norm_match_reference_bfloat16(arch):
    want_loss, want = ref_loss_and_grads(arch, "bfloat16")
    loss, got = port_loss_and_grads(arch, "bfloat16")
    np.testing.assert_allclose(loss.item(), want_loss, rtol=2e-2, atol=2e-2)
    want_norm = np.sqrt(sum(np.sum(np.square(w.astype(np.float64)))
                            for _, w in want))
    got_norm = port_optim.global_norm(dict(got)).item()
    np.testing.assert_allclose(got_norm, want_norm, rtol=5e-2)


class RefF32Step(ref_step.StepConfig):
    @property
    def compute_dtype(self):
        return jnp.float32


class PortF32Step(port_step.StepConfig):
    @property
    def compute_dtype(self):
        return torch.float32


def step_batches(cfg, n):
    out = []
    for i in range(n):
        toks, labels, vision = inputs(cfg, seed=20 + i)
        batch = {"tokens": toks, "labels": labels}
        if vision is not None:
            batch["vision"] = vision
        out.append(batch)
    return out


@pytest.mark.parametrize("policy", ["f32", "lowmem"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_train_step_matches_reference(arch, policy):
    """Two steps at float32 compute (the lowmem policy: bfloat16
    parameters, int8 moments, the codebooks summed in bfloat16): loss,
    grad norm and lr rtol 1e-4, the parameters after them rtol 1e-2 /
    atol 1e-3."""
    ref_cfg, cfg = cfgs(arch)
    opt_cfg = ref_optim.OptConfig(**OPT)
    ref_cfg_step = RefF32Step(policy=policy)
    params = ref_params(arch, policy=policy)
    opt = ref_optim.init_opt_state(params, ref_cfg_step.opt_config(opt_cfg))
    bs = step_batches(ref_cfg, 2)
    fn = ref_compiled(ref_step.make_train_step(ref_cfg, opt_cfg,
                                               ref_cfg_step),
                      params, opt, bs[0])
    want = []
    for b in bs:
        params, opt, m = fn(params, opt, b)
        want.append((float(m["loss"]), float(m["grad_norm"]),
                     float(m["lr"])))

    step_cfg = PortF32Step(policy=policy)
    model = port_from(cfg, ref_params(arch, policy=policy),
                      step_cfg.param_dtype)
    popt = port_optim.init_opt_state(
        model.param_tree(), step_cfg.opt_config(port_optim.OptConfig(**OPT)))
    step = port_step.make_train_step(cfg, port_optim.OptConfig(**OPT),
                                     step_cfg)
    got = []
    for b in bs:
        _, popt, m = step(model, popt,
                          {k: torch.from_numpy(v) for k, v in b.items()})
        got.append((m["loss"].item(), m["grad_norm"].item(), m["lr"].item()))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4)
    for (path, p), (_, w) in zip(flatten_with_paths(model.param_tree()),
                                 flatten_with_paths(
                                     jax.tree.map(np.asarray, params))):
        assert p.dtype == step_cfg.param_dtype, path
        np.testing.assert_allclose(host(p), np.asarray(w, np.float32),
                                   rtol=1e-2, atol=1e-3, err_msg=path)


# ------------------------------------------------------------ serving

def test_musicgen_generate_equals_the_reference_engine_test():
    """tests/test_engine_extra.py::test_musicgen_serve_multicodebook's
    weights (PRNGKey(3)), prompts and engine (bfloat16 compute, float32
    caches): the port's tokens equal the reference's."""
    ref_cfg = dataclasses.replace(ref_get_config(AUDIO).reduced(), q_chunk=8,
                                  k_chunk=8)
    cfg = dataclasses.replace(get_config(AUDIO).reduced(), q_chunk=8,
                              k_chunk=8)
    params, _ = ref_model.init_params(ref_cfg, jax.random.PRNGKey(3))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, cfg.n_codebooks, 8)).astype(np.int32)
    want = ref_engine.ServeEngine(ref_cfg, params,
                                  ref_engine.ServeConfig(batch=2)).generate(
                                      prompts, n_new=4)
    model = port_from(cfg, jax.tree.map(np.asarray, params))
    got = port_engine.ServeEngine(cfg, model, port_engine.ServeConfig(
        batch=2)).generate(prompts, n_new=4)
    assert got.dtype == np.int32 and got.shape == (2, cfg.n_codebooks, 12)
    np.testing.assert_array_equal(got[..., :8], prompts)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_equals_reference_at_float32(arch):
    """Both engines at float32 compute, the vision source given to
    prefill and every decode step: equal tokens."""
    ref_cfg, cfg = cfgs(arch)
    params, model = weights(arch)
    toks, _, vision = inputs(cfg, seed=5)
    prompts = toks[..., :PREFILL]
    want = ref_engine.ServeEngine(ref_cfg, params, ref_engine.ServeConfig(),
                                  RefF32Step()).generate(prompts, 6, vision)
    got = port_engine.ServeEngine(cfg, model, port_engine.ServeConfig(),
                                  PortF32Step()).generate(prompts, 6, vision)
    assert got.shape == prompts.shape[:-1] + (PREFILL + 6,)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ state, ckpt

@pytest.mark.parametrize("moments", ["f32", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_from_reference(arch, moments):
    """The reference's optimizer state for these trees (the xattn leaves,
    vision_proj, the [K, ...] embed and head) becomes the port's, every
    leaf equal."""
    _, cfg = cfgs(arch)
    params, model = weights(arch)
    opt = ref_optim.init_opt_state(params, ref_optim.OptConfig(
        moments_dtype=moments))
    opt = jax.tree.map(lambda a: np.asarray(a) + 1, opt)   # not all zeros
    got = opt_state_from_reference(cfg, opt, "cpu")
    like = port_optim.init_opt_state(model.param_tree(), port_optim.OptConfig(
        moments_dtype=moments))
    got_l, want_l = flatten_with_paths(got), flatten_with_paths(opt)
    assert [p for p, _ in got_l] == [p for p, _ in flatten_with_paths(like)]
    for (path, g), (_, w) in zip(got_l, want_l):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=path)
    if arch == AUDIO:
        m = got["m"]["embed"]
        assert (m if moments == "f32" else m["q"]).shape == (4, 128, 64)
    other = AUDIO if arch == VISION else VISION
    with pytest.raises(ValueError, match="does not hold"):
        opt_state_from_reference(cfgs(other)[1], opt, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_round_trips_both_ways(arch, tmp_path):
    """The port's save restores in the reference (and back into the
    port), the reference's save restores into the port: every leaf
    equal."""
    _, cfg = cfgs(arch)
    params, model = weights(arch)
    mgr = port_ckpt.CheckpointManager(str(tmp_path / "port"),
                                      async_save=False)
    mgr.save(3, {"params": model.param_tree()})
    _, state = ref_ckpt.CheckpointManager(str(tmp_path / "port")).restore(
        {"params": params})
    for (path, a), (_, b) in zip(flatten_with_paths(
            jax.tree.map(np.asarray, state["params"])), flatten_with_paths(
                params)):
        np.testing.assert_array_equal(a, b, err_msg=path)
    _, back = mgr.restore({"params": model.param_tree()})
    again = port_from(cfg, back["params"])
    for (name, a), (_, b) in zip(model.named_parameters(),
                                 again.named_parameters()):
        assert torch.equal(a, b), name

    ref_mgr = ref_ckpt.CheckpointManager(str(tmp_path / "ref"))
    ref_mgr.save(5, {"params": params})
    ref_mgr.wait()
    _, got = port_ckpt.CheckpointManager(str(tmp_path / "ref")).restore(
        {"params": model.param_tree()})
    loaded = port_from(cfg, got["params"])
    for (name, a), (_, b) in zip(model.named_parameters(),
                                 loaded.named_parameters()):
        assert torch.equal(a, b), name


# ------------------------------------------------------------ the launchers

def test_launch_serve_musicgen_on_the_cpu(capsys):
    serve_launch.main(["--arch", AUDIO, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8",
                       "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "[serve] 8 tokens in" in out and "output (2, 4, 12) on cpu" in out


def test_launch_serve_refuses_the_vision_arch():
    """The launcher passes no vision source, as the reference's does: the
    xattn layers' ValueError, raised before any weight is built."""
    with pytest.raises(ValueError, match="xattn layer at pattern position"):
        serve_launch.main(["--arch", VISION, "--reduced", "--device", "cpu",
                           "--batch", "1", "--prompt-len", "4",
                           "--new-tokens", "2"])


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_refuses_codebook_and_vision_archs(arch, capsys):
    with pytest.raises(SystemExit) as exc:
        train_launch.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--steps", "1"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f"--arch {arch}: its batches need" in err
    assert "synthetic corpus has [B, S] token streams" in err
