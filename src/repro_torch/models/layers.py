"""Transformer building blocks of the PyTorch port (mirror of
``repro.models.layers``): norms, embeddings, MLP, RoPE and M-RoPE, GQA
attention, and the cross attention of the encoder-decoder family.

Layouts stay the JAX package's: activations (B, S, D), per-head tensors
(B, S, H, Dh), projection weights ``wq`` (d, h, dh) and ``wo`` (h, dh, d),
so bridged parameters and the parity tests compare like with like. Every
numerical choice of the original is kept: fp32 norm statistics, fp32 tied
unembedding, the half-split RoPE layout, fp32 softmax with a -1e30 mask.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import common

NEG_INF = -1e30


def wl(w, dtype):
    """Weight loader: an int8-served leaf ``{"q8", "s8"}`` is dequantized
    at use (codes and scale cast to ``dtype``, then multiplied, as
    ``repro.models.layers.wl`` does); a plain tensor is cast."""
    if isinstance(w, dict) and "q8" in w:
        return w["q8"].to(dtype) * w["s8"].to(dtype)
    return w.to(dtype)


def q8_matmul(x: torch.Tensor, w: dict, contract_ndim: int = 1
              ) -> torch.Tensor:
    """x (..., contract dims) @ an int8 weight leaf through
    ``ops.int8_matmul`` (K4 on the card, its plain version on the CPU):
    int8 loads, the widen in registers, the per-channel scale on the
    output. ``w`` is {"q8", "s8"} with its first ``contract_ndim`` dims
    contracted; returns (..., *w["q8"].shape[contract_ndim:])."""
    q = w["q8"]
    kdim = math.prod(q.shape[:contract_ndim])
    out_shape = q.shape[contract_ndim:]
    sv = torch.broadcast_to(w["s8"], (1,) * contract_ndim + tuple(out_shape))
    lead = x.shape[:-contract_ndim]
    y = ops.int8_matmul(x.reshape(*lead, kdim), q.reshape(kdim, -1),
                        sv.reshape(-1))
    return y.reshape(*lead, *out_shape)


# -----------------------------------------------------------------------------
# Init (plain dicts of tensors; ``lead`` prepends a stacked-layer dim)
# -----------------------------------------------------------------------------

def init_rmsnorm(d: int, lead=(), *, device) -> dict:
    # norm scales stay fp32 whatever the weights' dtype (layers.py:58)
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=torch.float32,
                                device=device)}


def init_layernorm(d: int, lead=(), *, device) -> dict:
    # scale ones and bias zeros in fp32 whatever the weights' dtype
    # (layers.py:99-101)
    shape = tuple(lead) + (d,)
    return {"scale": torch.ones(shape, dtype=torch.float32, device=device),
            "bias": torch.zeros(shape, dtype=torch.float32, device=device)}


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

class _RMSNorm(torch.autograd.Function):
    """``rms_norm`` with the reference's custom VJP (layers.py:62-87): the
    forward takes the mean of squares in fp32 and casts the inverse back to
    x's dtype before the products; the backward stays in x's dtype with
    fp32 reductions only, and ``dscale`` is summed in fp32."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        var = torch.mean(x.square(), dim=-1, keepdim=True,
                         dtype=torch.float32)
        inv32 = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, inv32, scale)
        return x * inv32.to(x.dtype) * scale.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, inv32, scale = ctx.saved_tensors
        inv = inv32.to(x.dtype)
        g = dy * scale.to(x.dtype)
        dot = torch.sum((g * x).float(), dim=-1, keepdim=True)
        corr = inv32 ** 3 * (dot / x.shape[-1])
        dx = g * inv - x * corr.to(x.dtype)
        dscale = torch.sum((dy * x * inv).float(),
                           dim=tuple(range(x.dim() - 1))).to(scale.dtype)
        return dx, dscale, None


def rms_norm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return _RMSNorm.apply(x, params["scale"], eps)


def layer_norm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The reference's op order (layers.py:105-113): the mean and the mean
    of the squares (squared in x's dtype) in fp32, var = E[x^2] - mu^2 and
    its rsqrt in fp32, then (x - mu) * inv, the scale and the bias in x's
    dtype, each cast to it first. A bf16 x so rounds where XLA rounds."""
    mu = torch.mean(x, dim=-1, keepdim=True, dtype=torch.float32)
    var = torch.mean(x.square(), dim=-1, keepdim=True,
                     dtype=torch.float32) - mu.square()
    inv = torch.rsqrt(var + eps)
    y = (x - mu.to(x.dtype)) * inv.to(x.dtype)
    return y * params["scale"].to(x.dtype) + params["bias"].to(x.dtype)


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


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)`` as XLA expands it: x * (0.5 * (1 +
    tanh(sqrt(2/pi) * (x + 0.044715 * (x * x * x))))), the constants and
    every op rounded to x's dtype (``F.gelu`` rounds a bf16 x once, which
    differs from XLA in a third of the elements). The encoder-decoder's
    MLP uses it, so its bf16 blocks give JAX's bits."""
    def c(v: float) -> float:
        return float(torch.tensor(v, dtype=x.dtype))

    inner = c(math.sqrt(2.0 / math.pi)) * (x + c(0.044715) * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def mlp(params, x: torch.Tensor, act: str = "silu",
        int8_kernel: bool = False) -> torch.Tensor:
    act_fn = _act(act)
    w_in = params["w_in"]
    if int8_kernel and isinstance(w_in, dict) and "q8" in w_in:
        h = q8_matmul(x, w_in)
        if "w_gate" in params:
            h = act_fn(q8_matmul(x, params["w_gate"])) * h
        else:
            h = act_fn(h)
        return q8_matmul(h, params["w_out"])
    h = x @ wl(w_in, x.dtype)
    if "w_gate" in params:
        h = act_fn(x @ wl(params["w_gate"], x.dtype)) * h
    else:
        h = act_fn(h)
    return h @ wl(params["w_out"], x.dtype)


# -----------------------------------------------------------------------------
# Rotary embeddings: RoPE and M-RoPE (half-split layout, layers.py:206-245)
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


def apply_mrope(x: torch.Tensor, positions_thw: torch.Tensor,
                sections: Tuple[int, int, int],
                theta: float = 10000.0) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl, layers.py:224): three position streams
    (t, h, w) rotate disjoint frequency sections of the head dim.

    x: (B, S, H, Dh); positions_thw: (B, S, 3); sections sum to Dh // 2:
    frequency i takes the stream of the section it falls in."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} must sum to {half}")
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    sec_id = torch.cat([torch.full((s,), i, dtype=torch.long,
                                   device=x.device)
                        for i, s in enumerate(sections)])          # (half,)
    angles = positions_thw.float()[..., sec_id] * freqs           # (B, S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def positions_for(pos_emb: str, positions: torch.Tensor) -> torch.Tensor:
    """(..., S) positions as ``_project_qkv`` takes them: broadcast to the
    three identical (t, h, w) streams (..., S, 3) under M-RoPE, as the
    reference's decode and prefill do for text tokens
    (transformer.py:326, :448)."""
    if pos_emb == "mrope":
        return positions[..., None].expand(*positions.shape, 3)
    return positions


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
    pos_emb: str = "rope"                     # "rope" | "mrope" | "none"
    mrope_sections: Tuple[int, int, int] = (0, 0, 0)
    softmax_scale: Optional[float] = None
    # int8-served projections go through q8_matmul (the K4 seam)
    int8_kernel: bool = False

    @property
    def scale(self) -> float:
        return self.softmax_scale or (1.0 / math.sqrt(self.head_dim))


def _project(x: torch.Tensor, w) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    w = wl(w, x.dtype)
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _q8_active(cfg: AttnConfig, w) -> bool:
    return cfg.int8_kernel and isinstance(w, dict) and "q8" in w


def _project_qkv(params, cfg: AttnConfig, x: torch.Tensor, positions):
    if _q8_active(cfg, params["wq"]):
        q = q8_matmul(x, params["wq"])
        k = q8_matmul(x, params["wk"])
        v = q8_matmul(x, params["wv"])
    else:
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
    elif cfg.pos_emb == "mrope":
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    elif cfg.pos_emb != "none":
        raise ValueError(f"pos_emb={cfg.pos_emb!r}: rope, mrope or none")
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


def attention(params, cfg: AttnConfig, x: torch.Tensor,
              positions: Optional[torch.Tensor] = None,
              window: Optional[int] = None,
              arange_positions: bool = False) -> torch.Tensor:
    """Full-sequence (training) self-attention (layers.py:407-435).

    ``arange_positions`` is the caller's promise that ``positions`` is the
    0..S-1 arange (``None`` synthesizes it and sets the promise): the
    precondition of the flash route, whose mask is by index, not by the
    positions tensor. Causal attention with an int window then goes
    through ``ops.flash_attention_train`` (K6 forward, K7/K8 backward on
    the card); other positions, and M-RoPE as in the reference, take the
    masked ``sdpa``, or ``sdpa_q_chunked`` above 8192 keys. M-RoPE
    positions are (B, S, 3); the mask reads their first stream. The
    reference's ``flash_vjp`` switch has no counterpart: no switch turns a
    kernel off on the card.
    """
    b, s, _ = x.shape
    if positions is None:
        positions = positions_for(
            cfg.pos_emb, torch.arange(s, device=x.device).expand(b, s))
        arange_positions = True
    q, k, v = _project_qkv(params, cfg, x, positions)
    pos1d = positions[..., 0] if positions.dim() == 3 else positions
    w = cfg.window if window is None else window
    if (arange_positions and cfg.causal and isinstance(w, int)
            and cfg.pos_emb != "mrope"):
        out = ops.flash_attention_train(q, k, v, scale=cfg.scale,
                                        causal=True, window=w)
    elif s > _CHUNKED_SDPA_THRESHOLD:
        out = sdpa_q_chunked(q, k, v, pos1d, pos1d,
                             causal=cfg.causal, window=w, scale=cfg.scale)
    else:
        mask = attention_mask(pos1d, pos1d, causal=cfg.causal, window=w)
        out = sdpa(q, k, v, mask, cfg.scale)
    return out_proj(params, cfg, out)


def out_proj(params, cfg: AttnConfig, out: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd", out, wo); an int8-served wo goes through
    K4."""
    wo = params["wo"]
    if _q8_active(cfg, wo):
        return q8_matmul(out, wo, contract_ndim=2)
    wo = wl(wo, out.dtype)
    h, dh, d = wo.shape
    return out.flatten(-2) @ wo.reshape(h * dh, d)


def cross_attention(params, cfg: AttnConfig, x: torch.Tensor,
                    kv_src: torch.Tensor) -> torch.Tensor:
    """Attention of x (B, Sq, D) over an encoder output kv_src (B, Sk, D)
    (layers.py:489-503): no rotary embedding, the biases on q, k and v
    when the config has them, a mask of all ones, the masked ``sdpa``, and
    ``wo`` through ``wl``."""
    q = _project(x, params["wq"])
    k = _project(kv_src, params["wk"])
    v = _project(kv_src, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    mask = torch.ones((x.shape[0], q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=x.device)
    return out_proj(params, cfg, sdpa(q, k, v, mask, cfg.scale))


@dataclasses.dataclass
class KVCache:
    """Append cache: k/v (B, S_max, Hkv, Dh) — or with a leading stacked
    layer dim — updated in place by the decode step."""
    k: torch.Tensor
    v: torch.Tensor
