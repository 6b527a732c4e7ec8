"""Symmetric int8 quantization for the serving fast path (mirror of the
serving half of ``repro.quant.int8``).

Row-wise codes for the KV cache (one fp32 scale per (slot, position,
kv-head)) and per-output-channel weight leaves ``{"q8", "s8"}``. The
arithmetic is the original's, op for op, in fp32: ``torch.round`` rounds
half to even like ``jnp.round``, so the same fp32 inputs give the same
codes and scales bit for bit. Also the per-channel ``Int8Weight``
quantizers of the gradient-compression side (``quantize_stochastic``
draws its noise from an explicit ``torch.Generator``: ``jax.random``'s
bits are not reproduced) and the cells' serving transform
``quantize_params_for_serving``, which maps meta tensors to meta leaves,
the counterpart of the reference's ``ShapeDtypeStruct`` branch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass
class Int8Weight:
    q: torch.Tensor        # int8
    scale: torch.Tensor    # fp32, per-last-dim-channel (keepdims)


def _channel_scale(w32: torch.Tensor, axis: int, floor: float
                   ) -> torch.Tensor:
    red = tuple(i for i in range(w32.dim()) if i != axis % w32.dim())
    amax = w32.abs().amax(dim=red, keepdim=True) if red else w32.abs()
    return amax.clamp_min(floor) / 127.0


def quantize(w: torch.Tensor, axis: int = -1) -> Int8Weight:
    """Symmetric int8 with one fp32 scale per channel of ``axis``."""
    w32 = w.float()
    scale = _channel_scale(w32, axis, 1e-12)
    q = torch.round(w32 / scale).clamp(-127, 127).to(torch.int8)
    return Int8Weight(q=q, scale=scale)


def dequantize(iw: Int8Weight, dtype=torch.float32) -> torch.Tensor:
    return (iw.q.float() * iw.scale).to(dtype)


def quantize_stochastic(w: torch.Tensor, axis: int = -1, *,
                        generator: Optional[torch.Generator] = None
                        ) -> Int8Weight:
    """Stochastic rounding (unbiased): round(w / scale + u - 1/2), u
    uniform on [0, 1) from ``generator``."""
    w32 = w.float()
    scale = _channel_scale(w32, axis, 1e-12)
    scaled = w32 / scale
    noise = torch.rand(scaled.shape, generator=generator,
                       device=w.device) - 0.5
    q = torch.round(scaled + noise).clamp(-127, 127).to(torch.int8)
    return Int8Weight(q=q, scale=scale)


def quant_error(w: torch.Tensor, iw: Int8Weight) -> float:
    """Relative Frobenius error of the dequantized weight."""
    w32 = w.float()
    num = torch.linalg.vector_norm(w32 - dequantize(iw))
    den = torch.clamp(torch.linalg.vector_norm(w32), min=1e-12)
    return float(num / den)

# scale floor: an all-zero channel still gets a positive scale, so dequant
# is exact zero and division never produces inf/nan
SCALE_FLOOR = 1e-12

# weight-leaf names the serving transform quantizes (linear layers only;
# embeddings, norms and routers stay high precision)
SERVING_QUANT_KEYS = frozenset({"wq", "wk", "wv", "wo", "w_in", "w_gate",
                                "w_out", "w_z", "w_x"})

# trailing output-channel dims per weight name: q/k/v and SSD in-projections
# map embed -> (heads, head_dim); all others have one trailing output dim
_OUT_DIMS = {"wq": 2, "wk": 2, "wv": 2, "w_z": 2, "w_x": 2}


def weight_out_dims(name: str) -> int:
    """Trailing output-channel dim count of a SERVING_QUANT_KEYS leaf."""
    return _OUT_DIMS.get(name, 1)


def quantize_rowwise(x: torch.Tensor, axis: int = -1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over ONE axis; every other axis keeps its own scale.
    Returns (codes int8 of x's shape, scale fp32 with ``axis`` removed)."""
    x32 = x.float()
    ax = axis % x32.dim()
    amax = x32.abs().amax(dim=ax, keepdim=True)
    scale = amax.clamp_min(SCALE_FLOOR) / 127.0
    q = torch.round(x32 / scale).clamp(-127, 127).to(torch.int8)
    return q, scale.squeeze(ax)


def dequantize_rowwise(q: torch.Tensor, scale: torch.Tensor, axis: int = -1,
                       dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale.float().unsqueeze(axis)).to(dtype)


def quantize_weight(w: torch.Tensor, lead: int = 0, out_dims: int = 1
                    ) -> dict:
    """Per-channel int8 weight leaf: reduces |w| over the contraction dims
    (between the ``lead`` stack dims and the trailing ``out_dims`` channel
    dims), keeping them as size 1, so ``s8`` broadcasts against ``q8``.
    Returns {"q8", "s8"}."""
    w32 = w.float()
    red = tuple(range(lead, w32.dim() - out_dims))
    amax = w32.abs().amax(dim=red, keepdim=True) if red else w32.abs()
    scale = amax.clamp_min(SCALE_FLOOR) / 127.0
    q = torch.round(w32 / scale).clamp(-127, 127).to(torch.int8)
    return {"q8": q, "s8": scale}


# -----------------------------------------------------------------------------
# The cells' int8-weight serving transform (int8.py:125-160)
# -----------------------------------------------------------------------------

def _q8_leaf(w: torch.Tensor, stacked: bool) -> dict:
    """tensor -> {"q8", "s8"}: one fp32 scale per layer if ``stacked``,
    else one per tensor. A meta tensor gives meta leaves of those shapes
    and dtypes."""
    s_shape = (w.shape[0],) if stacked else ()
    if w.is_meta:
        return {"q8": torch.empty(w.shape, dtype=torch.int8, device="meta"),
                "s8": torch.empty(s_shape, dtype=torch.float32,
                                  device="meta")}
    if stacked:
        # layer by layer: the same codes and scales, one layer's fp32
        # temporaries at a time
        parts = [_q8_leaf(w[r], False) for r in range(w.shape[0])]
        return {"q8": torch.stack([p["q8"] for p in parts]),
                "s8": torch.stack([p["s8"] for p in parts])}
    w32 = w.float()
    scale = w32.abs().amax().clamp_min(1e-12) / 127.0
    q = torch.round(w32 / scale).clamp(-127, 127).to(torch.int8)
    return {"q8": q, "s8": scale}


def quantize_params_for_serving(params, axes):
    """(params, axes) -> their int8-served versions: the linear weights of
    ``SERVING_QUANT_KEYS`` become {"q8": int8, "s8": fp32 per-layer scale}
    with axes {"q8": the weight's, "s8": ("stack",) or ()}; everything
    else passes through."""
    def walk(p, a):
        if not isinstance(p, dict):
            return p, a
        out_p, out_a = {}, {}
        for k, v in p.items():
            if (k in SERVING_QUANT_KEYS and not isinstance(v, dict)
                    and v.dim() >= 2):
                stacked = (isinstance(a[k], tuple) and len(a[k]) > 0
                           and a[k][0] == "stack")
                out_p[k] = _q8_leaf(v, stacked)
                out_a[k] = {"q8": a[k], "s8": ("stack",) if stacked else ()}
            else:
                out_p[k], out_a[k] = walk(v, a[k])
        return out_p, out_a

    return walk(params, axes)
