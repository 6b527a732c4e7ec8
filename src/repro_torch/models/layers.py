"""Transformer building blocks of the PyTorch port (mirror of
``repro.models.layers``): norms, embeddings, MLP, RoPE, GQA attention.

Layouts stay the JAX package's: activations (B, S, D), per-head tensors
(B, S, H, Dh), projection weights ``wq`` (d, h, dh) and ``wo`` (h, dh, d),
so bridged parameters and the parity tests compare like with like. Every
numerical choice of the original is kept: fp32 norm statistics, fp32 tied
unembedding, the half-split RoPE layout, fp32 softmax with a -1e30 mask.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import common

NEG_INF = -1e30


# -----------------------------------------------------------------------------
# Init (plain dicts of tensors; ``lead`` prepends a stacked-layer dim)
# -----------------------------------------------------------------------------

def init_rmsnorm(d: int, lead=(), *, device) -> dict:
    # norm scales stay fp32 whatever the weights' dtype (layers.py:58)
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=torch.float32,
                                device=device)}


def init_embed(vocab: int, d: int, *, generator, device, dtype) -> dict:
    # 1/sqrt(d) keeps tied-unembedding logits O(1) at init
    return {"w": common.trunc_normal((vocab, d), 1.0 / math.sqrt(d),
                                     generator=generator, device=device,
                                     dtype=dtype)}


def init_unembed(d: int, vocab: int, *, generator, device, dtype) -> dict:
    return {"w": common.fan_in_init((d, vocab), fan_in=d, generator=generator,
                                    device=device, dtype=dtype)}


def init_mlp(d: int, d_ff: int, lead=(), *, gated: bool, generator, device,
             dtype) -> dict:
    lead = tuple(lead)
    kw = dict(generator=generator, device=device, dtype=dtype)
    parts = {"w_in": common.fan_in_init(lead + (d, d_ff), fan_in=d, **kw)}
    if gated:
        parts["w_gate"] = common.fan_in_init(lead + (d, d_ff), fan_in=d, **kw)
    parts["w_out"] = common.fan_in_init(lead + (d_ff, d), fan_in=d_ff, **kw)
    return parts


def init_attention(cfg: "AttnConfig", lead=(), *, generator, device,
                   dtype) -> dict:
    lead = tuple(lead)
    d, h, kvh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(generator=generator, device=device, dtype=dtype)
    parts = {
        "wq": common.fan_in_init(lead + (d, h, dh), fan_in=d, **kw),
        "wk": common.fan_in_init(lead + (d, kvh, dh), fan_in=d, **kw),
        "wv": common.fan_in_init(lead + (d, kvh, dh), fan_in=d, **kw),
        "wo": common.fan_in_init(lead + (h, dh, d), fan_in=h * dh, **kw),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", h), ("bk", kvh), ("bv", kvh)):
            parts[name] = torch.zeros(lead + (heads, dh), dtype=dtype,
                                      device=device)
    return parts


# -----------------------------------------------------------------------------
# Norms, embedding, MLP
# -----------------------------------------------------------------------------

def rms_norm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    # mean of squares in fp32, the inverse cast back to x's dtype before the
    # products (layers.py:63-66)
    var = torch.mean(x.square(), dim=-1, keepdim=True, dtype=torch.float32)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * params["scale"].to(x.dtype)


def embed(params, tokens: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    dt = compute_dtype or params["w"].dtype
    return params["w"][tokens].to(dt)


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits in fp32 (layers.py:133-136)."""
    return x.float() @ params["w"].float().t()


def apply_unembed(params, x: torch.Tensor) -> torch.Tensor:
    return x.float() @ params["w"].float()


def _act(name: str):
    return {"silu": F.silu,
            # jax.nn.gelu(approximate=True) is the tanh form
            "gelu": lambda t: F.gelu(t, approximate="tanh"),
            "relu": F.relu}[name]


def mlp(params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    act_fn = _act(act)
    h = x @ params["w_in"].to(x.dtype)
    if "w_gate" in params:
        h = act_fn(x @ params["w_gate"].to(x.dtype)) * h
    else:
        h = act_fn(h)
    return h @ params["w_out"].to(x.dtype)


# -----------------------------------------------------------------------------
# Rotary embeddings (half-split layout, layers.py:206-221)
# -----------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs             # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -----------------------------------------------------------------------------
# Attention (GQA, windows)
# -----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    causal: bool = True
    # sliding window in tokens; <0 = global/full attention
    window: int = -1
    pos_emb: str = "rope"                     # "rope" | "none"
    softmax_scale: Optional[float] = None

    @property
    def scale(self) -> float:
        return self.softmax_scale or (1.0 / math.sqrt(self.head_dim))


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _project_qkv(params, cfg: AttnConfig, x: torch.Tensor, positions):
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.pos_emb != "none":
        raise NotImplementedError(f"pos_emb={cfg.pos_emb!r}: not ported yet")
    return q, k, v


def attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
                   window: int) -> torch.Tensor:
    """(.., Sq, Sk) bool mask; window <= 0 means full attention."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    m = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        m &= diff >= 0
    if window > 0:
        m &= diff < window
    return m


def sdpa(q, k, v, mask, scale: float) -> torch.Tensor:
    """Reference scaled-dot-product attention with GQA head grouping.

    q: (B,Sq,H,Dh), k/v: (B,Sk,Hkv,Dh); mask broadcastable to (B,H,Sq,Sk).
    fp32 softmax; masked logits are -1e30, so an all-masked row averages V
    (the decode kernel returns zeros there instead). Returns q.dtype.
    """
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    qg = q.reshape(b, sq, hkv, rep, dh)
    logits = torch.einsum("bqhrd,bnhd->bhrqn", qg.float() * scale, k.float())
    # logits: (B, Hkv, rep, Sq, Sk)
    mask_b = mask[:, None, None] if mask.ndim == 3 else mask[None, None, None]
    logits = torch.where(mask_b, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhrqn,bnhd->bqhrd", probs, v.float())
    return out.reshape(b, sq, h, dh).to(q.dtype)


# above this many KV positions the S x S logits tensor is too large; the
# exact q-chunked path takes over (layers.py:371-375)
_CHUNKED_SDPA_THRESHOLD = 8192
_SDPA_Q_CHUNK = 1024


def sdpa_q_chunked(q, k, v, q_pos, k_pos, *, causal: bool, window: int,
                   scale: float, chunk: int = _SDPA_Q_CHUNK) -> torch.Tensor:
    """Exact attention over query chunks (O(chunk*Sk) live memory); the same
    semantics as sdpa + attention_mask. A Python loop stands in for the
    original's ``lax.scan``."""
    sq = q.shape[1]
    outs = []
    for s0 in range(0, sq, chunk):
        p_i = q_pos[:, s0:s0 + chunk]
        mask = attention_mask(p_i, k_pos, causal=causal, window=window)
        outs.append(sdpa(q[:, s0:s0 + chunk], k, v, mask, scale))
    return torch.cat(outs, dim=1)


@dataclasses.dataclass
class KVCache:
    """Append cache: k/v (B, S_max, Hkv, Dh) — or with a leading stacked
    layer dim — updated in place by the decode step."""
    k: torch.Tensor
    v: torch.Tensor
