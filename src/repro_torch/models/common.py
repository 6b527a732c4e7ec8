"""Initializers of the PyTorch port (mirror of ``repro.models.common``).

Parameters are plain nested dicts of tensors with the JAX tree's keys and
layouts, so ``bridge.params_from_numpy`` maps one onto the other array by
array. The original's ``Axed`` pairs each tree with its logical axes; here
the axes are a tree of their own, built from the config alone by a
function beside each init (``transformer.lm_axes``, ``caches_axes``,
``encdec.encdec_axes``, ``dec_caches_axes``, ``optim.adamw.opt_state_axes``)
and mapped onto a mesh by ``parallel.sharding``. Random draws come
from an explicit ``torch.Generator``; they do not reproduce ``jax.random``'s
bits, so tests that compare the two frameworks bridge JAX's weights.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

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


def flatten(tree: dict) -> Tuple[List[torch.Tensor],
                                Callable[[Sequence], dict]]:
    """(leaves, rebuild) of a nested dict of tensors, leaves in dict order:
    ``rebuild(new)`` puts ``new`` leaves back in the same structure (the
    counterpart of ``jax.tree.flatten`` / ``unflatten`` for the port's
    parameter trees)."""
    keys = []

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                keys.append((path + (k,), v))

    walk(tree, ())

    def rebuild(new):
        out: dict = {}
        for (path, _), v in zip(keys, new):
            d = out
            for k in path[:-1]:
                d = d.setdefault(k, {})
            d[path[-1]] = v
        return out

    return [v for _, v in keys], rebuild
