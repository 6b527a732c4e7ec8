"""Public kernel entry points of the port (mirror of ``repro.kernels.ops``).

Dispatch goes by the tensors' device, never by what the machine has: CPU
tensors take the plain PyTorch version (``ref``), CUDA tensors take the
hand-written kernel, which runs or raises. There is no fallback from one to
the other and no switch that turns a kernel off on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import ref as _ref


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, scale: Optional[float] = None,
                     window: int = -1) -> torch.Tensor:
    """Serve-core decode attention with per-slot lengths (K1).

    q: (B, H, D) — the one new token per slot; k/v: (B, Sk, Hkv, D)
    slot-major KV cache; lengths: (B,) int32 valid prefix per slot (0 = dead
    slot -> zeros). Unlike ``repro.kernels.ops.decode_attention`` this does
    not pad Sk to a block multiple: the kernel masks by length, and padding
    would copy the whole cache on every call of every layer.
    """
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return _ref.decode_attention_ref(q, k, v, lengths, scale=scale,
                                         window=window)
    if q.device.type == "cuda":
        return _da.decode_attention(q, k, v, lengths, scale=scale,
                                    window=window)
    raise ValueError(f"decode_attention: no kernel for device {q.device}")
