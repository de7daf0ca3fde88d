"""The decoder LM over a repeating layer pattern (counterpart of
`repro.models.model`). A layer's mixer is GQA self-attention, tanh-gated
cross-attention to a vision source (`xattn`), Mamba (`models/mamba.py`),
mLSTM or sLSTM (`models/xlstm.py`); its channel the SwiGLU MLP, the routed
MoE (`models/moe.py`) or none. An audio model (`n_codebooks` K) reads
tokens [B, K, S], sums the K codebooks' embeddings and gives logits
[B, K, S, V].

`DecoderLM` is an `nn.Module` whose parameters map one to one onto the
reference's tree: `embed` ([V, D], or [K, V, D]), `final_norm`, `lm_head`
(untied heads; [D, V] or [K, D, V]), `vision_proj` [d_vision, D] (a vision
model) and `layers.<pattern pos>.<name>`, each layer weight stacked over
the repeats with a leading [R] axis. Where the reference `lax.scan`s the
stack, the port loops over R in Python. Modes:
  * train   — full-sequence forward, CE loss (+ MoE aux, `loss_fn`), no
              caches; the weights cast inside the graph (autograd follows
              whenever grad is enabled), `remat` checkpoints one repeat of
              the pattern
  * prefill — full-sequence forward + cache build (under torch.no_grad)
  * decode  — one-token step against the caches (under torch.no_grad)

Caches are per-pattern-position NamedTuples with a leading [R] axis: a
`KVCache` for attention (in the cache dtype), a `MambaState`,
`MLSTMState` or `SLSTMState` for the recurrent mixers (float32 whatever the
cache dtype), `()` for cross-attention (its source is given to every call
and projected anew, as the reference does). They are written in place:
attention writes its positions, a recurrent mixer's new state is copied
over its row. The functional
entry points of the reference (`init_params`, `init_cache`, `forward`,
`loss_fn`, `prefill`, `decode_step`, ...) are thin functions over the
module.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.engine import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import common
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.common import (ParamFactory, cross_entropy, einsum,
                                       rms_norm)

MODES = ("train", "prefill", "decode")
MIXERS = ("attn", "xattn", "mamba", "mlstm", "slstm")
CHANNELS = ("mlp", "moe", "none")
# Each mixer's leaves that it reads at their stored dtype (the reference
# casts them to float32 from its master, or adds them uncast), not cast to
# the compute dtype; norms are read so everywhere.
AS_STORED = {"mamba": mamba_lib.AS_STORED,
             "mlstm": xlstm_lib.MLSTM_AS_STORED,
             "slstm": xlstm_lib.SLSTM_AS_STORED}


# ------------------------------------------------------------ dims helpers

def attn_dims(cfg: ModelConfig) -> attn_lib.AttnDims:
    return attn_lib.AttnDims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.head_dim, cfg.qkv_bias, cfg.rope_theta)


def moe_dims(cfg: ModelConfig) -> moe_lib.MoEDims:
    return moe_lib.MoEDims(cfg.d_model, cfg.moe_d_ff or cfg.d_ff,
                           cfg.n_experts, cfg.top_k, cfg.capacity_factor,
                           cfg.moe_dispatch)


def mamba_dims(cfg: ModelConfig) -> mamba_lib.MambaDims:
    return mamba_lib.MambaDims(cfg.d_model, cfg.mamba_expand,
                               cfg.mamba_d_state, cfg.mamba_d_conv)


def xlstm_dims(cfg: ModelConfig) -> xlstm_lib.XLSTMDims:
    return xlstm_lib.XLSTMDims(cfg.d_model, cfg.n_heads,
                               cfg.xlstm_proj_factor)


# ------------------------------------------------------------ the module

class Layer(nn.Module):
    """One pattern position's weights, stacked over the repeats."""

    def __init__(self, pf: ParamFactory, spec: LayerSpec, cfg: ModelConfig):
        super().__init__()
        r = cfg.n_repeats
        if spec.mixer not in MIXERS:
            raise ValueError(spec.mixer)
        if spec.channel not in CHANNELS:
            raise ValueError(spec.channel)
        self.norm1 = pf.ones((cfg.d_model,), ("embed",), r)
        if spec.mixer == "attn":
            self.attn = attn_lib.Attention(pf, attn_dims(cfg), r)
        elif spec.mixer == "xattn":
            # the source reaches the layer projected to d_model
            self.xattn = attn_lib.CrossAttention(pf, attn_dims(cfg),
                                                 cfg.d_model, r)
        elif spec.mixer == "mamba":
            self.mamba = mamba_lib.Mamba(pf, mamba_dims(cfg), r)
        elif spec.mixer == "mlstm":
            self.mlstm = xlstm_lib.MLSTM(pf, xlstm_dims(cfg), r)
        else:
            self.slstm = xlstm_lib.SLSTM(pf, xlstm_dims(cfg), r)
        if spec.channel == "mlp":
            self.norm2 = pf.ones((cfg.d_model,), ("embed",), r)
            self.mlp = mlp_lib.MLP(pf, cfg.d_model, cfg.d_ff, r)
        elif spec.channel == "moe":
            self.norm2 = pf.ones((cfg.d_model,), ("embed",), r)
            self.moe = moe_lib.MoE(pf, moe_dims(cfg), r)


def _unbind_tree(module: nn.Module) -> dict:
    """A pattern position's stacked weights as the reference's nested
    dict, each leaf unbound over the repeats into one view a layer. Under
    autograd the layers' gradients are then stacked once; indexing p[r]
    for each layer would add a zero-filled gradient of the whole stack
    per layer."""
    out = {name: _unbind_tree(child)
           for name, child in module.named_children()}
    for name, p in module.named_parameters(recurse=False):
        out[name] = p.unbind(0)
    return out


def _pick(tree: dict, r: int) -> dict:
    """Layer r's weights of an `_unbind_tree`, as stored."""
    return {name: _pick(v, r) if isinstance(v, dict) else v[r]
            for name, v in tree.items()}


def cast_layer(tree: dict, dtype, stored=frozenset()) -> dict:
    """One layer's weights as its forward reads them: norms (rms_norm reads
    them in float32) and each mixer's `AS_STORED` leaves as stored, the
    rest in `dtype`."""
    return {name: cast_layer(v, dtype, AS_STORED.get(name, ()))
            if isinstance(v, dict)
            else v if name.startswith("norm") or name in stored
            else v.to(dtype)
            for name, v in tree.items()}


def _layer_weights(tree: dict, r: int, dtype) -> dict:
    """Layer r's weights of an `_unbind_tree`, cast by `cast_layer`."""
    return cast_layer(_pick(tree, r), dtype)


def head_weight(cfg: ModelConfig, top, dtype: torch.dtype) -> torch.Tensor:
    """The head as `output_logits` reads it, from `top(name)` (the stored
    top-level leaves): in `dtype`, except a tied codebook head, read as
    stored (the reference's einsum promotes)."""
    if not cfg.tie_embeddings:
        return top("lm_head").to(dtype)
    return top("embed") if cfg.n_codebooks else top("embed").to(dtype)


class OwnWeights:
    """A model's own parameters as `train_forward` reads them: `top(name)`
    a top-level leaf as stored, `layer(i, r)` repeat r of pattern position
    i as the reference's nested dict, as stored (views of the stacks, so
    that autograd stacks a stack's gradients once)."""

    def __init__(self, model: "DecoderLM"):
        self.model = model
        self.stacks = [_unbind_tree(layer) for layer in model.layers]

    def top(self, name: str) -> torch.Tensor:
        return getattr(self.model, name)

    def layer(self, i: int, r: int) -> dict:
        return _pick(self.stacks[i], r)


class DecoderLM(nn.Module):
    """The decoder. Build it with `init_params` (random, from a
    generator) or `empty(cfg, device)` followed by `load_state_dict`."""

    def __init__(self, cfg: ModelConfig, pf: ParamFactory):
        super().__init__()
        self.cfg = cfg
        if cfg.n_codebooks:
            k = cfg.n_codebooks
            self.embed = pf.dense((k, cfg.vocab_size, cfg.d_model),
                                  ("codebooks", "vocab", "embed"), scale=0.02)
            # fan-in K, as the reference's
            head = ((k, cfg.d_model, cfg.vocab_size),
                    ("codebooks", "embed", "vocab"))
        else:
            self.embed = pf.embedding(cfg.vocab_size, cfg.d_model)
            head = ((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
        self.final_norm = pf.ones((cfg.d_model,), ("embed",))
        if not cfg.tie_embeddings:
            self.lm_head = pf.dense(*head)
        if cfg.n_vision_tokens:
            self.vision_proj = pf.dense((cfg.d_vision, cfg.d_model),
                                        ("vision_embed", "embed"))
        self.layers = nn.ModuleList(Layer(pf, spec, cfg)
                                    for spec in cfg.pattern)
        # each parameter's logical axes by name (loading replaces the
        # Parameter objects, not their names)
        self._axes = {name: p.logical_axes
                      for name, p in self.named_parameters()}
        self._compute = None   # (key, weights in a compute dtype)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def param_tree(self) -> dict:
        """The parameters as the reference's tree: nested dicts, `layers` a
        tuple over pattern positions (checkpoint names and `like`)."""
        tree: dict = {}
        for name, p in self.named_parameters():
            *path, leaf = name.split(".")
            node = tree
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = p
        tree["layers"] = tuple(tree["layers"][str(i)]
                               for i in range(len(self.layers)))
        return tree

    @torch.no_grad()
    def compute_weights(self, dtype: torch.dtype) -> dict:
        """The weights in the compute dtype, cast once and kept until a
        parameter changes (the reference casts `w.astype(x.dtype)` inside
        each einsum; the rounding is the same). Layer weights come as
        [repeat][pattern pos] -> the reference's per-layer dict."""
        params = list(self.parameters())
        key = (dtype, tuple((p.data_ptr(), p._version) for p in params))
        if self._compute is None or self._compute[0] != key:
            self._compute = None   # free the old copy before casting anew
            stacks = [_unbind_tree(layer) for layer in self.layers]
            weights = {
                # the codebooks' rows are summed as stored, then cast
                "embed": (self.embed if self.cfg.n_codebooks
                          else self.embed.to(dtype)),
                "head": self.head_weight(dtype),
                "layers": [[_layer_weights(stack, r, dtype)
                            for stack in stacks]
                           for r in range(self.cfg.n_repeats)]}
            if self.cfg.n_vision_tokens:
                weights["vision_proj"] = self.vision_proj.to(dtype)
            self._compute = (key, weights)
        return self._compute[1]

    def head_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """The head as `output_logits` reads it (`head_weight`)."""
        return head_weight(self.cfg, functools.partial(getattr, self), dtype)

    def param_axes(self) -> dict:
        """Each parameter's logical axes, in the tree of `param_tree()`."""
        return param_axes(self)

    def forward(self, tokens: torch.Tensor, mode: str = "train",
                caches=None, pos: int | None = None,
                compute_dtype: torch.dtype = torch.bfloat16,
                remat: bool = True, vision: torch.Tensor | None = None):
        """tokens int [B,S] ([B,K,S] with K codebooks). Returns (logits
        [B,S,V] or [B,K,S,V], caches, aux); the caches are written in
        place. `vision` [B,T,d_vision] is projected to d_model once, in the
        compute dtype, and read by every xattn layer; a model with xattn
        layers raises a ValueError without it. aux is the MoE auxiliary
        loss of each repeat's last pattern position, summed over the
        repeats (a float32 scalar; 0 where that position has no MoE
        channel): the reference's scan body adds the aux of its last layer
        only, so a pattern with MoE layers elsewhere (jamba's) counts one
        of them a repeat, and the port does the same. Train mode casts the
        weights inside the graph (`remat` checkpoints each repeat of the
        pattern); prefill and decode run under torch.no_grad from the cast
        cache."""
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        if (caches is None) != (mode == "train"):
            raise ValueError("mode 'train' takes no caches; prefill and "
                             "decode need them")
        require_source(self.cfg, vision)
        if mode == "train":
            return self._train_forward(tokens, compute_dtype, remat, vision)
        with torch.no_grad():
            return self._serve_forward(tokens, mode, caches, pos,
                                       compute_dtype, vision)

    def _serve_forward(self, tokens, mode, caches, pos, compute_dtype,
                       vision):
        cfg = self.cfg
        w = self.compute_weights(compute_dtype)
        x = embed_tokens(w, cfg, tokens).to(compute_dtype)
        if vision is not None and cfg.n_vision_tokens:
            vision = einsum("btd,de->bte", vision.to(compute_dtype),
                            w["vision_proj"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for r, layer_ws in enumerate(w["layers"]):
            common.phase_boundary("repeat")
            for i, spec in enumerate(cfg.pattern):
                # a cache's leaves at repeat r; () for a cross-attention
                cache = type(caches[i])(*(leaf[r] for leaf in caches[i]))
                x, new, a = apply_layer(spec, layer_ws[i], x, cfg, mode,
                                        cache, pos, vision)
                for row, leaf in zip(cache, new):
                    if leaf is not row:   # a recurrent mixer's new state
                        row.copy_(leaf)
            aux = aux + a   # the last pattern position's (see forward)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        logits = output_logits(w, cfg, x)
        return logits, caches, aux

    def _train_forward(self, tokens, compute_dtype, remat, vision):
        return train_forward(self.cfg, OwnWeights(self), tokens,
                             compute_dtype, remat, vision)


def train_forward(cfg: ModelConfig, weights, tokens, compute_dtype, remat,
                  vision):
    """The reference's train forward under autograd over `weights` (an
    `OwnWeights`, or the mesh step's gathering source in sharding/lm.py):
    the embedding gathered from the stored table, then cast (its gradient
    then sums in the parameter's dtype); each layer's weights read inside
    the checkpointed body and cast there, as `w.astype(x.dtype)`; one
    checkpoint per repeat, as `jax.checkpoint` over the scan body.
    Returns (logits, None, aux)."""
    x = embed_tokens({"embed": weights.top("embed")}, cfg,
                     tokens).to(compute_dtype)
    if vision is not None and cfg.n_vision_tokens:
        vision = einsum("btd,de->bte", vision.to(compute_dtype),
                        weights.top("vision_proj").to(compute_dtype))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(x, aux, r):
        common.phase_boundary("repeat")
        for i, spec in enumerate(cfg.pattern):
            p = cast_layer(weights.layer(i, r), compute_dtype)
            x, _, a = apply_layer(spec, p, x, cfg, "train", vision=vision)
        return x, aux + a

    for r in range(cfg.n_repeats):
        if remat:
            x, aux = checkpoint(body, x, aux, r, use_reentrant=False)
        else:
            x, aux = body(x, aux, r)
    x = rms_norm(x, weights.top("final_norm"), cfg.norm_eps)
    logits = output_logits(
        {"head": head_weight(cfg, weights.top, compute_dtype)}, cfg, x)
    return logits, None, aux


# ------------------------------------------------------------ functional API

def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32) -> DecoderLM:
    """A DecoderLM drawn from `generator`, on the generator's device, with
    the reference's shapes, names and scales (jax.random and
    torch.Generator draw different numbers: carry the reference's weights
    with `repro_torch.state.lm_params_from_reference`)."""
    return DecoderLM(cfg, ParamFactory(generator, dtype))


def empty(cfg: ModelConfig, device="cuda",
          dtype: torch.dtype = torch.float32) -> DecoderLM:
    """A DecoderLM with uninitialised parameters on `device`, to load."""
    return DecoderLM(cfg, ParamFactory(None, dtype, resolve_device(device)))


def param_axes(model: DecoderLM) -> dict:
    """The logical axes of `model`'s parameters in the tree of its
    `param_tree()` (the reference's axes tree)."""
    tree: dict = {}
    for name, axes in model._axes.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = axes
    tree["layers"] = tuple(tree["layers"][str(i)]
                           for i in range(len(model.layers)))
    return tree


def abstract_params(cfg: ModelConfig, dtype: torch.dtype = torch.float32):
    """(parameter tree, axes tree) of `cfg` on the "meta" device: the
    shapes and dtypes of `init_params`, nothing allocated (the dry run's
    path)."""
    model = DecoderLM(cfg, ParamFactory(None, dtype, torch.device("meta")))
    return model.param_tree(), param_axes(model)


def init_layer_cache(spec: LayerSpec, cfg: ModelConfig, batch: int,
                     max_len: int, dtype, device, repeats: int | None = None):
    """One pattern position's cache: a KVCache in `dtype`, a recurrent
    mixer's state in float32 whatever `dtype`, or () for cross-attention
    (its source is static: no cache)."""
    if spec.mixer == "xattn":
        return ()
    if spec.mixer == "attn":
        return attn_lib.init_kv_cache(batch, attn_dims(cfg), max_len, dtype,
                                      device, repeats)
    if spec.mixer == "mamba":
        return mamba_lib.init_mamba_state(batch, mamba_dims(cfg), device,
                                          repeats)
    if spec.mixer == "mlstm":
        return xlstm_lib.init_mlstm_state(batch, xlstm_dims(cfg), device,
                                          repeats)
    return xlstm_lib.init_slstm_state(batch, xlstm_dims(cfg), device, repeats)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    """Tuple over pattern positions; leaves stacked [R, ...] (on "meta",
    shapes only)."""
    device = (torch.device("meta") if str(device) == "meta"
              else resolve_device(device))
    return tuple(init_layer_cache(spec, cfg, batch, max_len, dtype, device,
                                  cfg.n_repeats)
                 for spec in cfg.pattern)


def layer_cache_axes(spec: LayerSpec):
    """The logical axes of one pattern position's cache (`()` for
    cross-attention)."""
    if spec.mixer == "attn":
        return attn_lib.kv_cache_axes()
    if spec.mixer == "mamba":
        return mamba_lib.mamba_state_axes()
    if spec.mixer == "mlstm":
        return xlstm_lib.mlstm_state_axes()
    if spec.mixer == "slstm":
        return xlstm_lib.slstm_state_axes()
    return ()


def cache_axes(cfg: ModelConfig):
    """The logical axes of `init_cache`'s tree, "layers" leading each
    stacked leaf."""
    out = []
    for spec in cfg.pattern:
        ax = layer_cache_axes(spec)
        out.append(type(ax)(*(("layers",) + a for a in ax)) if ax else ())
    return tuple(out)


def apply_layer(spec: LayerSpec, p, x, cfg: ModelConfig, mode: str,
                cache=None, pos=None, vision=None):
    """One layer: the pre-norm mixer, then the pre-norm MLP or MoE channel
    (or none), each with its residual. Returns (x, cache, aux): attention
    writes its KV cache in place and returns it; a recurrent mixer returns
    its new state (prefill starts from zeros, decode from `cache`; train
    mode returns `cache` as given); cross-attention reads `vision` (the
    projected source) in every mode and returns `cache` as given. aux is
    the MoE channel's load-balancing loss (a float32 scalar), 0.0 for the
    others."""
    aux = 0.0
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if spec.mixer == "xattn":
        y = attn_lib.cross_attention(p["xattn"], h, vision, attn_dims(cfg))
    elif spec.mixer == "attn":
        if mode == "train":
            y = attn_lib.attention_train(p["attn"], h, attn_dims(cfg),
                                         cfg.q_chunk, cfg.k_chunk)
        elif mode == "prefill":
            y, cache = attn_lib.attention_prefill(
                p["attn"], h, attn_dims(cfg), cache, cfg.q_chunk, cfg.k_chunk)
        else:
            y, cache = attn_lib.attention_decode(p["attn"], h, attn_dims(cfg),
                                                 cache, int(pos))
    elif spec.mixer == "mamba":
        if mode == "decode":
            y, cache = mamba_lib.mamba_decode(p["mamba"], h, mamba_dims(cfg),
                                              cache)
        else:
            y, st = mamba_lib.mamba_forward(p["mamba"], h, mamba_dims(cfg),
                                            cfg.mamba_chunk)
            cache = st if mode == "prefill" else cache
    elif spec.mixer == "mlstm":
        if mode == "decode":
            y, cache = xlstm_lib.mlstm_decode(p["mlstm"], h, xlstm_dims(cfg),
                                              cache)
        else:
            y, st = xlstm_lib.mlstm_forward(p["mlstm"], h, xlstm_dims(cfg))
            cache = st if mode == "prefill" else cache
    else:
        if mode == "decode":
            y, cache = xlstm_lib.slstm_decode(p["slstm"], h, xlstm_dims(cfg),
                                              cache)
        else:
            y, st = xlstm_lib.slstm_forward(p["slstm"], h, xlstm_dims(cfg))
            cache = st if mode == "prefill" else cache
    x = x + y
    if spec.channel == "mlp":
        h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
        x = x + mlp_lib.apply_mlp(p["mlp"], h2)
    elif spec.channel == "moe":
        h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
        y2, aux = moe_lib.apply_moe(p["moe"], h2, moe_dims(cfg))
        x = x + y2
    return x, cache, aux


def require_source(cfg: ModelConfig, vision) -> None:
    """Raise the ValueError of an xattn layer without a source, before any
    work: a model with cross-attention needs `vision`."""
    if vision is None:
        for i, spec in enumerate(cfg.pattern):
            if spec.mixer == "xattn":
                raise ValueError(f"{cfg.name}: the xattn layer at pattern "
                                 f"position {i} needs a vision source, and "
                                 f"vision is None")


def embed_tokens(weights: dict, cfg: ModelConfig, tokens):
    """The embedding rows of `tokens` [B,S], in the dtype of
    weights["embed"] (`DecoderLM.compute_weights`). With K codebooks,
    tokens [B,K,S]: the K rows summed in the table's stored dtype, in
    order k = 0..K-1, as the reference sums them (the caller casts)."""
    emb = weights["embed"]
    if cfg.n_codebooks:
        return functools.reduce(torch.add, [emb[k][tokens[:, k]]
                                            for k in range(cfg.n_codebooks)])
    return emb[tokens]


def output_logits(weights: dict, cfg: ModelConfig, x):
    """The head over `weights` (`DecoderLM.compute_weights`): tied
    `bsd,vd->bsv` or untied `bsd,dv->bsv`, in x's dtype; with codebooks
    `bsd,kdv->bksv` (untied) or `bsd,kvd->bksv` against the stored table
    (tied), in the dtype x and the table promote to, as jnp promotes."""
    head = weights["head"]
    if cfg.n_codebooks:
        if cfg.tie_embeddings:
            dt = torch.promote_types(x.dtype, head.dtype)
            return einsum("bsd,kvd->bksv", x.to(dt), head.to(dt))
        return einsum("bsd,kdv->bksv", x, head)
    if cfg.tie_embeddings:
        return einsum("bsd,vd->bsv", x, head)
    return einsum("bsd,dv->bsv", x, head)


def _model_for(params: DecoderLM, cfg: ModelConfig) -> DecoderLM:
    if params.cfg != cfg:
        raise ValueError(f"params were built for {params.cfg.name}, "
                         f"not for the config given ({cfg.name})")
    return params


def forward(params: DecoderLM, cfg: ModelConfig, tokens, mode: str = "train",
            caches=None, pos=None, compute_dtype=torch.bfloat16,
            remat: bool = True, vision=None):
    """tokens int [B,S] ([B,K,S] audio). Returns (logits, caches, aux)."""
    return _model_for(params, cfg)(tokens, mode, caches, pos, compute_dtype,
                                   remat, vision)


def loss_fn(params: DecoderLM, cfg: ModelConfig, batch,
            compute_dtype=torch.bfloat16, remat: bool = True,
            aux_weight: float = 0.01):
    """(ce + aux_weight·aux/max(n_layers, 1), {"ce", "aux"}) over
    batch["tokens"] and batch["labels"], int [B,S] ([B,K,S] audio) on the
    model's device, and batch.get("vision") for a vision model."""
    logits, _, aux = forward(params, cfg, batch["tokens"], "train",
                             compute_dtype=compute_dtype, remat=remat,
                             vision=batch.get("vision"))
    ce = cross_entropy(logits, batch["labels"])
    return ce + aux_weight * aux / max(cfg.n_layers, 1), {"ce": ce, "aux": aux}


def decode_step(params: DecoderLM, cfg: ModelConfig, tokens, caches, pos,
                compute_dtype=torch.bfloat16, vision=None):
    """One serve step: tokens [B,1] ([B,K,1] audio) at position `pos`.
    Returns (next_tokens int32 [B,1] or [B,K,1], caches); the argmax is
    taken on logits in the compute dtype (the first maximum, as
    jnp.argmax)."""
    logits, caches, _ = forward(params, cfg, tokens, "decode", caches=caches,
                                pos=pos, compute_dtype=compute_dtype,
                                vision=vision)
    nxt = torch.argmax(logits[..., -1, :], dim=-1).to(torch.int32)
    return nxt[..., None], caches


def prefill(params: DecoderLM, cfg: ModelConfig, tokens, caches,
            compute_dtype=torch.bfloat16, vision=None):
    logits, caches, _ = forward(params, cfg, tokens, "prefill", caches=caches,
                                compute_dtype=compute_dtype, vision=vision)
    return logits, caches

