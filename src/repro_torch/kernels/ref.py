"""Plain PyTorch versions of the port's kernels (the correctness contracts).

The CPU path of ``ops`` runs these, and ``chip_smoke.py`` holds each CUDA
kernel against them on the card. Nothing on the card's main path calls them.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, *, scale: float,
                         window: int = -1) -> torch.Tensor:
    """What ``repro.kernels.decode_attention._decode_kernel`` computes, as
    tag-masked fp32 softmax attention (``layers.sdpa``).

    q: (B, H, D); k/v: (B, Sk, Hkv, D); lengths: (B,) valid prefix per slot.
    The query sits at position ``lengths - 1``; keys at ``>= lengths`` or,
    with ``window > 0``, at ``lengths - 1 - pos >= window`` are masked. An
    all-masked row of ``sdpa`` averages V, but a dead slot (length 0) must
    return zeros, so those rows are zeroed. Returns (B, H, D) in q.dtype.
    """
    sk = k.shape[1]
    lengths = lengths.to(torch.int64)
    pos = torch.arange(sk, device=k.device)[None]               # (1, Sk)
    tags = torch.where(pos < lengths[:, None], pos, -1)         # (B, Sk)
    q_pos = (lengths - 1)[:, None]                              # (B, 1)
    mask = layers.attention_mask(q_pos, tags, causal=True, window=window)
    mask &= (tags >= 0)[:, None, :]
    out = layers.sdpa(q[:, None], k, v, mask, scale)[:, 0]
    return torch.where((lengths > 0)[:, None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))
