"""GQA self-attention (counterpart of `repro.models.attention`): chunked
causal attention with an online softmax for train and prefill, and the
cache-based one-token path for decode; and the tanh-gated cross-attention
to a vision source (no cache: K and V are recomputed from the source in
every mode, as the reference does).

The dtype flow follows the reference step by step: scores in the compute
dtype, scaled there and masked with NEG_INF; the running max and sum in
float32, into which `acc * corr + p·v` promotes; decode in float32 over the
whole cache. A Python scalar keeps a tensor's dtype in torch as a weak
scalar does in jnp; where jnp rounds a scalar to a bfloat16 operand, the
port passes it as a 0-dim tensor of that dtype.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.models.common import (ParamFactory, apply_rope, einsum,
                                       rope_cos_sin)

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    qkv_bias: bool = False
    rope_theta: float = 1e6


class Attention(nn.Module):
    """wq [d, h, dh], wk/wv [d, kv, dh], wo [h, dh, d] (scale 1/√(h·dh)),
    optional bq/bk/bv; each stacked over `repeats` layers."""

    def __init__(self, pf: ParamFactory, dims: AttnDims,
                 repeats: int | None = None):
        super().__init__()
        d, h, kv, dh = dims.d_model, dims.n_heads, dims.n_kv, dims.d_head
        self.wq = pf.dense((d, h, dh), ("embed", "q_heads", "head"), repeats)
        self.wk = pf.dense((d, kv, dh), ("embed", "kv_heads", "head"),
                           repeats)
        self.wv = pf.dense((d, kv, dh), ("embed", "kv_heads", "head"),
                           repeats)
        self.wo = pf.dense((h, dh, d), ("q_heads", "head", "embed"), repeats,
                           scale=1.0 / (h * dh) ** 0.5)
        if dims.qkv_bias:
            self.bq = pf.zeros((h, dh), ("q_heads", "head"), repeats)
            self.bk = pf.zeros((kv, dh), ("kv_heads", "head"), repeats)
            self.bv = pf.zeros((kv, dh), ("kv_heads", "head"), repeats)


def _project_qkv(p, x, dims: AttnDims, positions):
    """x [B,S,D] -> q [B,H,S,dh], k/v [B,KV,S,dh] with RoPE applied."""
    q = einsum("bsd,dhk->bhsk", x, p["wq"])
    k = einsum("bsd,dhk->bhsk", x, p["wk"])
    v = einsum("bsd,dhk->bhsk", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"][None, :, None, :]
        k = k + p["bk"][None, :, None, :]
        v = v + p["bv"][None, :, None, :]
    cos, sin = rope_cos_sin(positions, dims.d_head, dims.rope_theta)
    q = apply_rope(q, cos[:, None], sin[:, None])
    k = apply_rope(k, cos[:, None], sin[:, None])
    return q, k, v


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, q_chunk: int = 512,
                             k_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax causal attention.

    q [B,H,S,dh], k/v [B,KV,S,dh] with H = G·KV (GQA). Returns [B,H,S,dh].
    Loops over q chunks (outer) and kv chunks (inner) carrying (acc,
    row_max, row_sum); kv chunks wholly in a q chunk's future are skipped,
    so causal work is ~S²/2 (the reference's lax.cond).
    """
    b, h, s, dh = q.shape
    kvh = k.shape[1]
    g = h // kvh
    q_chunk = min(q_chunk, s)
    k_chunk = min(k_chunk, s)
    if s % q_chunk or s % k_chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunks "
                         f"({q_chunk}, {k_chunk})")
    nq, nk = s // q_chunk, s // k_chunk
    scale = torch.tensor(dh ** -0.5, dtype=q.dtype)

    qc = q.reshape(b, kvh, g, nq, q_chunk, dh)
    kc = k.reshape(b, kvh, nk, k_chunk, dh)
    vc = v.reshape(b, kvh, nk, k_chunk, dh)
    ar_q = torch.arange(q_chunk, device=q.device)
    ar_k = torch.arange(k_chunk, device=q.device)

    outs = []
    for qi in range(nq):
        qblk = qc[:, :, :, qi]
        q_pos = qi * q_chunk + ar_q
        acc = torch.zeros((b, kvh, g, q_chunk, dh), dtype=torch.float32,
                          device=q.device)
        mx = torch.full((b, kvh, g, q_chunk), NEG_INF, dtype=torch.float32,
                        device=q.device)
        sm = torch.zeros((b, kvh, g, q_chunk), dtype=torch.float32,
                         device=q.device)
        for kj in range(nk):
            if kj * k_chunk > qi * q_chunk + q_chunk - 1:
                break   # this chunk and every later one lie in the future
            kblk, vblk = kc[:, :, kj], vc[:, :, kj]
            k_pos = kj * k_chunk + ar_k
            s_ = einsum("bkgqd,bkcd->bkgqc", qblk, kblk) * scale
            causal = q_pos[:, None] >= k_pos[None, :]
            s_ = torch.where(causal, s_, NEG_INF)
            new_mx = torch.maximum(mx, s_.amax(dim=-1))
            p = torch.exp(s_ - new_mx[..., None])
            corr = torch.exp(mx - new_mx)
            sm = sm * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + einsum(
                "bkgqc,bkcd->bkgqd", p.to(vblk.dtype), vblk)
            mx = new_mx
        outs.append(acc / torch.clamp_min(sm, 1e-30)[..., None])
    out = torch.stack(outs, dim=3)                       # [B,KV,G,nq,qc,dh]
    return out.reshape(b, h, s, dh).to(q.dtype)


def attention_train(p, x, dims: AttnDims, q_chunk: int = 512,
                    k_chunk: int = 1024):
    """Full-sequence causal self-attention (train / prefill forward)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    q, k, v = _project_qkv(p, x, dims, positions)
    out = chunked_causal_attention(q, k, v, q_chunk, k_chunk)
    return einsum("bhsk,hkd->bsd", out, p["wo"])


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, KV, S_max, dh]
    v: torch.Tensor  # [B, KV, S_max, dh]


def init_kv_cache(batch: int, dims: AttnDims, max_len: int,
                  dtype=torch.bfloat16, device=None,
                  repeats: int | None = None) -> KVCache:
    """Zeros [B, KV, max_len, dh], stacked [R, ...] over `repeats` layers."""
    shape = ((repeats,) if repeats else ()) + (batch, dims.n_kv, max_len,
                                               dims.d_head)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def kv_cache_axes() -> KVCache:
    """Logical axes of a (one layer's) KVCache."""
    ax = ("batch", "kv_heads", "seq", "head")
    return KVCache(ax, ax)


def attention_prefill(p, x, dims: AttnDims, cache: KVCache,
                      q_chunk: int = 512, k_chunk: int = 1024):
    """Prefill: train-style attention, and k/v written into the cache's
    first S positions in place."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    q, k, v = _project_qkv(p, x, dims, positions)
    out = chunked_causal_attention(q, k, v, q_chunk, k_chunk)
    cache.k[:, :, :s] = k.to(cache.k.dtype)
    cache.v[:, :, :s] = v.to(cache.v.dtype)
    return einsum("bhsk,hkd->bsd", out, p["wo"]), cache


def attention_decode(p, x, dims: AttnDims, cache: KVCache, pos: int):
    """Single-token decode: x [B,1,D] at position `pos`; k/v written into
    the cache at `pos` in place, then float32 attention over the whole
    cache masked to positions <= pos."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, dims, positions)       # q [B,H,1,dh]
    cache.k[:, :, pos:pos + 1] = k.to(cache.k.dtype)
    cache.v[:, :, pos:pos + 1] = v.to(cache.v.dtype)
    kvh = dims.n_kv
    g = dims.n_heads // kvh
    qg = q.reshape(b, kvh, g, dims.d_head)              # squeeze S=1
    kk = cache.k.float()
    vv = cache.v.float()
    s_ = einsum("bkgd,bksd->bkgs", qg.float(), kk)
    s_ = s_ * dims.d_head ** -0.5
    valid = torch.arange(kk.shape[2], device=x.device) <= pos
    s_ = torch.where(valid, s_, NEG_INF)
    w = torch.softmax(s_, dim=-1)
    out = einsum("bkgs,bksd->bkgd", w, vv)
    out = out.reshape(b, 1, dims.n_heads, dims.d_head).to(x.dtype)
    return einsum("bshk,hkd->bsd", out, p["wo"]), cache


# --------------------------------------------------------------- cross-attn

class CrossAttention(nn.Module):
    """wq [d, h, dh], wk/wv [d_source, kv, dh], wo [h, dh, d] (scale
    1/√(h·dh)) and the tanh gate, a zero scalar; each stacked over
    `repeats` layers."""

    def __init__(self, pf: ParamFactory, dims: AttnDims, d_source: int,
                 repeats: int | None = None):
        super().__init__()
        d, h, kv, dh = dims.d_model, dims.n_heads, dims.n_kv, dims.d_head
        self.wq = pf.dense((d, h, dh), ("embed", "q_heads", "head"), repeats)
        self.wk = pf.dense((d_source, kv, dh),
                           ("vision_embed", "kv_heads", "head"), repeats)
        self.wv = pf.dense((d_source, kv, dh),
                           ("vision_embed", "kv_heads", "head"), repeats)
        self.wo = pf.dense((h, dh, d), ("q_heads", "head", "embed"), repeats,
                           scale=1.0 / (h * dh) ** 0.5)
        # a scalar: the reference marks its axes (None,)
        self.gate = pf.zeros((), (None,), repeats)


def cross_attention(p, x, source, dims: AttnDims):
    """x [B,S,D] attends to source [B,T,Ds] (no causal mask, no RoPE): q
    from x, k and v from the source in x's dtype, scores and softmax in
    float32, the output back in x's dtype through wo, scaled by
    tanh(gate) (the gate in x's dtype)."""
    b, s, _ = x.shape
    kvh = dims.n_kv
    g = dims.n_heads // kvh
    src = source.to(x.dtype)
    q = einsum("bsd,dhk->bhsk", x, p["wq"])
    k = einsum("btd,dhk->bhtk", src, p["wk"])
    v = einsum("btd,dhk->bhtk", src, p["wv"])
    qg = q.reshape(b, kvh, g, s, dims.d_head)
    s_ = einsum("bkgsd,bktd->bkgst", qg.float(),
                k.float()) * dims.d_head ** -0.5
    w = torch.softmax(s_, dim=-1)
    out = einsum("bkgst,bktd->bkgsd", w, v.float())
    out = out.reshape(b, dims.n_heads, s, dims.d_head).to(x.dtype)
    y = einsum("bhsk,hkd->bsd", out, p["wo"])
    return torch.tanh(p["gate"].to(x.dtype)) * y
