"""Symmetric int8 quantization for the serving fast path (mirror of the
serving half of ``repro.quant.int8``).

Row-wise codes for the KV cache (one fp32 scale per (slot, position,
kv-head)) and per-output-channel weight leaves ``{"q8", "s8"}``. The
arithmetic is the original's, op for op, in fp32: ``torch.round`` rounds
half to even like ``jnp.round``, so the same fp32 inputs give the same
codes and scales bit for bit. The gradient-compression quantizers
(``Int8Weight``, ``quantize_stochastic``) and the dry-run transform
(``quantize_params_for_serving``) are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

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
