"""Ternary and binary weight reduction (TWN-style), the paper's inference
mode (port of ``repro.quant.ternary``).

Ternarization (Ternary Weight Networks): threshold Δ = 0.7·E|w| per output
channel (the last dim); q = sign(w)·1[|w|>Δ]; scale α = E[|w| : |w|>Δ].
w ≈ α·q with q ∈ {-1,0,+1} stored as int8, the codes the ternary matmul
kernel (K11) consumes with α directly.

The trees are the port's plain nested dicts of tensors; a quantized leaf
becomes a ``TernaryWeight``. Torch sums the mean |w| in another order than
XLA, so a weight within fp32 rounding of Δ may take the other code.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch


@dataclasses.dataclass
class TernaryWeight:
    q: torch.Tensor        # int8 in {-1,0,1}, same shape as w
    scale: torch.Tensor    # per-output-channel fp32 scale (broadcast on last dim)


def _sum(x: torch.Tensor, red: Tuple[int, ...],
         keepdim: bool = False) -> torch.Tensor:
    # jnp reduces over no axis when ``axis=()``; torch's ``dim=()`` would
    # reduce over all of them
    return x.sum(dim=red, keepdim=keepdim) if red else x


def _mean(x: torch.Tensor, red: Tuple[int, ...],
          keepdim: bool = False) -> torch.Tensor:
    return x.mean(dim=red, keepdim=keepdim) if red else x


def ternarize(w: torch.Tensor, threshold_scale: float = 0.7) -> TernaryWeight:
    """Per-output-channel (last dim) TWN ternarization."""
    w32 = w.float()
    red = tuple(range(w32.dim() - 1))
    a = w32.abs()
    delta = threshold_scale * _mean(a, red, keepdim=True)
    q = torch.where(a > delta, torch.sign(w32), torch.zeros_like(w32))
    nz = torch.clamp(_sum(q.abs(), red), min=1.0)
    scale = _sum(a * q.abs(), red) / nz
    return TernaryWeight(q=q.to(torch.int8), scale=scale.float())


def binarize(w: torch.Tensor) -> TernaryWeight:
    """BWN binarization: q = sign(w), alpha = E|w| (a ternary with no zeros)."""
    w32 = w.float()
    red = tuple(range(w32.dim() - 1))
    q = torch.where(w32 >= 0, 1, -1).to(torch.int8)
    return TernaryWeight(q=q, scale=_mean(w32.abs(), red).float())


def dequantize(tw: TernaryWeight, dtype=torch.float32) -> torch.Tensor:
    return (tw.q.float() * tw.scale).to(dtype)


def quant_error(w: torch.Tensor, tw: TernaryWeight) -> float:
    """Relative L2 reconstruction error."""
    w32 = w.float()
    num = torch.linalg.vector_norm(w32 - dequantize(tw))
    den = torch.clamp(torch.linalg.vector_norm(w32), min=1e-12)
    return float(num / den)


# -- bitplane packing (the PIM representation) --------------------------------

def to_bitplanes(tw: TernaryWeight) -> Tuple[torch.Tensor, torch.Tensor]:
    """q in {-1,0,1} -> (plus, minus) uint8 planes with q = plus - minus."""
    return (tw.q > 0).to(torch.uint8), (tw.q < 0).to(torch.uint8)


def from_bitplanes(plus: torch.Tensor, minus: torch.Tensor,
                   scale: torch.Tensor) -> TernaryWeight:
    return TernaryWeight(q=plus.to(torch.int8) - minus.to(torch.int8),
                         scale=scale)


# -- tree-level model reduction -----------------------------------------------

def quantize_tree(params: Any, *, mode: str = "ternary",
                  predicate: Optional[Callable[[str, torch.Tensor], bool]]
                  = None) -> Any:
    """Quantize every >=2-D weight leaf (by default) in a params tree.

    Leaves selected by ``predicate(path, leaf)`` (path as ``"fc0/w"``)
    become TernaryWeight nodes; others pass through. Use with
    ``dequantize_tree`` or a quant-aware matmul.
    """
    fn = {"ternary": ternarize, "binary": binarize}[mode]

    def pred(path: str, x) -> bool:
        if predicate is not None:
            return predicate(path, x)
        return hasattr(x, "ndim") and x.ndim >= 2 and "embed" not in path

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (str(k),)) for k, v in t.items()}
        name = "/".join(path)
        return fn(t) if pred(name, t) else t

    return walk(params, ())


def dequantize_tree(params: Any, dtype=torch.float32) -> Any:
    if isinstance(params, dict):
        return {k: dequantize_tree(v, dtype) for k, v in params.items()}
    if isinstance(params, TernaryWeight):
        return dequantize(params, dtype)
    return params
