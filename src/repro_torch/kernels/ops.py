"""Public kernel entry points of the port (mirror of ``repro.kernels.ops``):
decode attention (K1), paged decode and prefill attention (K2, K3), the
paged multi-query verify attention of speculative decode (K5), each with
its int8-KV mode, the int8 weight matmul (K4) and its differentiable form
(forward K4 with fp32 output, backward K9), the inference flash attention
(K10, with its int8-KV mode), the differentiable training flash
attention, whose forward is K6 and whose backward is K7 (dQ) and K8 (dK,
dV), and the ternary weight matmul (K11) of the CNN workloads.

Dispatch goes by the tensors' device, never by what the machine has: CPU
tensors take the plain PyTorch version (``ref``), CUDA tensors take the
hand-written kernel, which runs or raises. There is no fallback from one to
the other and no switch that turns a kernel off on the card. Unlike the
JAX wrappers, these pad nothing: the kernels mask by length, and padding
would copy the cache or the chunk on every call of every layer.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import int8_matmul as _im
from repro_torch.kernels import paged_decode_attention as _pda
from repro_torch.kernels import paged_prefill_attention as _ppa
from repro_torch.kernels import paged_verify_attention as _pva
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ternary_matmul as _tm
from repro_torch.quant.ternary import TernaryWeight


def _scale_pair(name: str, k_scale, v_scale) -> None:
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: pass both KV scales or neither")


def _channel_scale(scale: torch.Tensor, n: int) -> torch.Tensor:
    """A () per-tensor, (N,) per-channel or keepdims scale as (N,) fp32."""
    sc = scale.float()
    return torch.broadcast_to(sc.reshape(-1, n) if sc.dim() else sc,
                              (1, n)).reshape(n)


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x: (..., K) @ int8 weight (K, N) with per-channel scale -> (..., N)
    in x's dtype (K4).

    ``scale`` may be () per-tensor, (N,) per-channel, or any keepdims shape
    broadcastable to (1, N) (``quant.int8.quantize_weight``'s ``s8``).
    """
    k, n = q.shape
    sc = _channel_scale(scale, n)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if x.device.type == "cpu":
        y = _ref.int8_matmul_ref(x2, q, sc)
    elif x.device.type == "cuda":
        y = _im.int8_matmul(x2.contiguous(), q, sc.contiguous())
    else:
        raise ValueError(f"int8_matmul: no kernel for device {x.device}")
    return y.reshape(*lead, n)


def ternary_matmul(x: torch.Tensor, w: TernaryWeight) -> torch.Tensor:
    """x: (..., K) @ ternary weight (K, N) -> (..., N) in x's dtype (K11)."""
    k, n = w.q.shape
    sc = w.scale.reshape(n).float()
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if x.device.type == "cpu":
        y = _ref.ternary_matmul_ref(x2, w.q, sc)
    elif x.device.type == "cuda":
        y = _tm.ternary_matmul(x2.contiguous(), w.q.contiguous(),
                               sc.contiguous())
    else:
        raise ValueError(f"ternary_matmul: no kernel for device {x.device}")
    return y.reshape(*lead, n)


def ternary_dense(x: torch.Tensor, w: TernaryWeight,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = ternary_matmul(x, w)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, scale: Optional[float] = None,
                     window: int = -1,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Serve-core decode attention with per-slot lengths (K1).

    q: (B, H, D) — the one new token per slot; k/v: (B, Sk, Hkv, D)
    slot-major KV cache; lengths: (B,) int32 valid prefix per slot (0 = dead
    slot -> zeros). ``k_scale``/``v_scale`` (B, Sk, Hkv) fp32 enable the
    int8-KV mode: k/v are int8 codes, dequantized inside the kernel.
    """
    _scale_pair("decode_attention", k_scale, v_scale)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return _ref.decode_attention_ref(q, k, v, lengths, scale=scale,
                                         window=window, k_scale=k_scale,
                                         v_scale=v_scale)
    if q.device.type == "cuda":
        return _da.decode_attention(q, k, v, lengths, scale=scale,
                                    window=window, k_scale=k_scale,
                                    v_scale=v_scale)
    raise ValueError(f"decode_attention: no kernel for device {q.device}")


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, *,
                           scale: Optional[float] = None, window: int = -1,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Serve-core decode attention through a paged KV pool (K2).

    q: (B, H, D) — the one new token per slot; k_pool/v_pool:
    (P, page_size, Hkv, D) the shared block pool; page_table: (B, NB) int32
    (entries past a slot's length point at the sink page); lengths: (B,)
    int32 valid logical prefix per slot (0 = dead slot -> zeros).
    ``k_scale``/``v_scale`` (P, page_size, Hkv) fp32 enable the int8-KV
    mode.
    """
    _scale_pair("paged_decode_attention", k_scale, v_scale)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return _ref.paged_decode_attention_ref(
            q, k_pool, v_pool, page_table, lengths, scale=scale,
            window=window, k_scale=k_scale, v_scale=v_scale)
    if q.device.type == "cuda":
        return _pda.paged_decode_attention(
            q, k_pool, v_pool, page_table, lengths, scale=scale,
            window=window, k_scale=k_scale, v_scale=v_scale)
    raise ValueError(f"paged_decode_attention: no kernel for device "
                     f"{q.device}")


def paged_verify_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, *,
                           scale: Optional[float] = None, window: int = -1,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Multi-query decode attention through a paged KV pool for the
    speculative verify pass (K5).

    q: (B, T, H, D) — T query lanes per slot (the pending token and the
    drafts), already written to the pool at positions ``lengths - T + t``;
    k_pool/v_pool: (P, page_size, Hkv, D); page_table: (B, NB) int32;
    lengths: (B,) int32 valid logical prefix per slot INCLUDING the T lanes
    (0 = dead slot -> zeros). Lane t attends keys ``<= lengths - T + t``,
    read from the pool in its storage dtype. A row with no valid key is
    zeros. ``k_scale``/``v_scale`` (P, page_size, Hkv) fp32 enable the
    int8-KV mode.
    """
    _scale_pair("paged_verify_attention", k_scale, v_scale)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return _ref.paged_verify_attention_ref(
            q, k_pool, v_pool, page_table, lengths, scale=scale,
            window=window, k_scale=k_scale, v_scale=v_scale)
    if q.device.type == "cuda":
        return _pva.paged_verify_attention(
            q, k_pool, v_pool, page_table, lengths, scale=scale,
            window=window, k_scale=k_scale, v_scale=v_scale)
    raise ValueError(f"paged_verify_attention: no kernel for device "
                     f"{q.device}")


def paged_prefill_attention(q: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, page_table: torch.Tensor,
                            starts: torch.Tensor, lens: torch.Tensor, *,
                            scale: Optional[float] = None, window: int = -1,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Chunk-prefill attention through a paged KV pool (K3).

    q: (B, C, H, D) chunk queries; k_new/v_new: (B, C, Hkv, D) the chunk's
    K/V in q's dtype (what the in-chunk attention sees — dense-prefill
    numerics); k_pool/v_pool: (P, page_size, Hkv, D) the pool holding the
    cached prefix [0, starts[b]) (read in storage dtype — decode
    numerics); page_table: (B, NB) int32; starts/lens: (B,) int32
    cached-prefix length and valid chunk tokens per row (lens 0 = dead
    row). Rows at or past ``lens`` come back as zeros.
    ``k_scale``/``v_scale`` (P, page_size, Hkv) fp32 enable the int8-KV
    mode for the cached prefix; the chunk's own K/V stay in q's dtype.
    """
    _scale_pair("paged_prefill_attention", k_scale, v_scale)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return _ref.paged_prefill_attention_ref(
            q, k_new, v_new, k_pool, v_pool, page_table, starts, lens,
            scale=scale, window=window, k_scale=k_scale, v_scale=v_scale)
    if q.device.type == "cuda":
        return _ppa.paged_prefill_attention(
            q, k_new, v_new, k_pool, v_pool, page_table, starts, lens,
            scale=scale, window=window, k_scale=k_scale, v_scale=v_scale)
    raise ValueError(f"paged_prefill_attention: no kernel for device "
                     f"{q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None, causal: bool = True,
                    window: int = -1,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GQA-aware flash attention, forward only (K10; mirror of
    ``repro.kernels.ops.flash_attention``). q (B, Sq, H, D), k/v (B, Sk,
    Hkv, D) -> (B, Sq, H, D) in q's dtype; query i lines up with key i.

    ``k_scale``/``v_scale`` (B, Sk, Hkv) enable the int8-KV mode: k/v are
    int8 codes, each row times its fp32 scale as the kernel reads it.
    Nothing is padded (the kernel masks by length), so the JAX wrapper's
    escape to ``attention_ref`` for ragged shapes has no counterpart. A row
    with no valid key (Sq > Sk under a window, whose keys then lie past the
    last one) is zeros; the JAX wrapper gives it ``attention_ref``'s average
    of V.
    """
    _scale_pair("flash_attention", k_scale, v_scale)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    kw = dict(scale=float(scale), causal=bool(causal), window=int(window),
              k_scale=k_scale, v_scale=v_scale)
    if q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, **kw)
    if q.device.type == "cuda":
        if k_scale is not None:
            kw.update(k_scale=k_scale.float().contiguous(),
                      v_scale=v_scale.float().contiguous())
        return _fa.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), **kw)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


# -----------------------------------------------------------------------------
# Training fast path: differentiable int8 matmul (K4 forward, K9 backward)
# -----------------------------------------------------------------------------

class _Int8MatmulTrain(torch.autograd.Function):
    """Forward: K4 with fp32 output, saving (q, scale, y); backward: dx
    through K9 in x's dtype, dscale recovered from the saved fp32 output
    (``repro.kernels.int8_matmul.int8_matmul_vjp``), no gradient for the
    frozen int8 codes. CPU tensors take the plain versions."""

    @staticmethod
    def forward(ctx, x2, q, sc):
        if x2.device.type == "cpu":
            y = _ref.int8_matmul_ref(x2, q, sc, out_dtype=torch.float32)
        elif x2.device.type == "cuda":
            y = _im.int8_matmul(x2.contiguous(), q, sc.contiguous(),
                                out_dtype=torch.float32)
        else:
            raise ValueError(f"int8_matmul_train: no kernel for device "
                             f"{x2.device}")
        ctx.save_for_backward(q, sc, y)
        ctx.x_dtype = x2.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        q, sc, y = ctx.saved_tensors
        dy32 = dy.float()
        if dy32.device.type == "cpu":
            dx = _ref.int8_matmul_dx_ref(dy32, q, sc, ctx.x_dtype)
        else:
            dx = _im.int8_matmul_dx(dy32.contiguous(), q, sc.contiguous(),
                                    ctx.x_dtype)
        # y = acc * scale => dscale[n] = sum_m dy[m, n] * y[m, n] / scale[n]
        # (int8_matmul.py:172-176), in plain torch as the reference does
        safe = torch.where(sc == 0, torch.ones_like(sc), sc)
        dscale = (dy32 * y).sum(0) / safe
        return dx, None, dscale


def int8_matmul_train(x: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Differentiable int8 matmul (mirror of
    ``repro.kernels.ops.int8_matmul_train``): x (..., K) @ int8 q (K, N)
    with a () / (N,) / keepdims scale -> (..., N) in x's dtype. The
    forward runs K4 with fp32 output, cast to x's dtype after; dx runs K9;
    dscale is recovered from the saved fp32 output and takes the scale's
    own shape; the codes get no gradient. Nothing is padded (the JAX
    wrapper pads the scale with ones; the kernels mask by length)."""
    k, n = q.shape
    lead = x.shape[:-1]
    y = _Int8MatmulTrain.apply(x.reshape(-1, k), q,
                               _channel_scale(scale, n))
    return y.reshape(*lead, n).to(x.dtype)


# -----------------------------------------------------------------------------
# Training fast path: differentiable flash attention (K6 forward, K7/K8
# backward)
# -----------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """Forward saves (q, k, v, out, lse); backward recomputes p from lse
    tile by tile, so no (Sq, Sk) probability tensor is kept between the
    passes on the card."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window):
        if q.device.type == "cpu":
            out, lse = _ref.flash_attention_fwd_ref(
                q, k, v, scale=scale, causal=causal, window=window)
        elif q.device.type == "cuda":
            out, lse = _fa.flash_attention_fwd(
                q.contiguous(), k.contiguous(), v.contiguous(), scale=scale,
                causal=causal, window=window)
        else:
            raise ValueError(f"flash_attention_train: no kernel for device "
                             f"{q.device}")
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.statics = dict(scale=scale, causal=causal, window=window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.to(q.dtype)
        if q.device.type == "cpu":
            dq, dk, dv = _ref.flash_attention_bwd_ref(
                q, k, v, out, lse, dout, **ctx.statics)
        else:
            q, k, v, dout = (t.contiguous() for t in (q, k, v, dout))
            # delta = rowsum(dO * O) in plain torch, as the reference
            # computes it outside its kernels (flash_attention.py:328-330)
            delta = (dout.float() * out.float()).sum(-1) \
                .transpose(1, 2).contiguous()
            dq = _fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta,
                                            **ctx.statics)
            dk, dv = _fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                                 **ctx.statics)
        return dq, dk, dv, None, None, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: Optional[float] = None,
                          causal: bool = True,
                          window: int = -1) -> torch.Tensor:
    """Differentiable flash attention (mirror of
    ``repro.kernels.ops.flash_attention_train``): q (B, Sq, H, D), k/v (B,
    Sk, Hkv, D) -> (B, Sq, H, D) in q's dtype; query i lines up with key i.

    On the card the forward is K6 and the backward K7 and K8; on the CPU
    their plain versions. Nothing is padded (the kernels mask by length),
    so the JAX wrapper's escape to ``attention_ref`` for ragged shapes has
    no counterpart; the results agree. A row with no valid key gives zeros
    and no gradient.
    """
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, float(scale), bool(causal),
                                 int(window))
