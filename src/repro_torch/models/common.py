"""Initializers of the PyTorch port (mirror of ``repro.models.common``).

Parameters are plain nested dicts of tensors with the JAX tree's keys and
layouts, so ``bridge.params_from_numpy`` maps one onto the other array by
array. ``Axed`` and the logical-axis trees of the original are sharding
metadata for the TPU mesh and have no counterpart here. Random draws come
from an explicit ``torch.Generator``; they do not reproduce ``jax.random``'s
bits, so tests that compare the two frameworks bridge JAX's weights.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def trunc_normal(shape: Sequence[int], stddev: float, *,
                 generator: torch.Generator, device: torch.device,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, stddev) truncated at two standard deviations, drawn in fp32 and
    then cast, as ``jax.random.truncated_normal(-2, 2) * stddev`` is."""
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, stddev, -2.0 * stddev, 2.0 * stddev,
                                generator=generator)
    return w.to(dtype)


def fan_in_init(shape: Sequence[int], fan_in: Optional[int] = None, *,
                generator: torch.Generator, device: torch.device,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    fi = fan_in if fan_in is not None else math.prod(shape[:-1]) or 1
    return trunc_normal(shape, 1.0 / math.sqrt(fi), generator=generator,
                        device=device, dtype=dtype)
