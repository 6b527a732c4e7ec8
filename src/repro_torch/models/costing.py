"""Dtype-aware modeled traffic/compute for LM serving (mirror of the dense
subset of ``repro.models.costing``).

The serve engine bills every tick's bytes and FLOPs through these, from the
resident tensors' real sizes, so the port's ``CarbonAccountant`` report
equals the JAX engine's on the same workload:

* a weight of E elements costs 2E FLOPs per token regardless of storage
  dtype;
* causal full-sequence attention costs 2 * n_attn * (H*Dh) * S FLOPs per
  token (the causal half of the 4x qk+pv term).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import torch

from repro_torch.models import transformer as tf_lib

PyTree = Any

# linear-layer weights (``repro.quant.int8.SERVING_QUANT_KEYS``): the
# matmul weights a token streams
SERVING_QUANT_KEYS = frozenset({"wq", "wk", "wv", "wo", "w_in", "w_gate",
                                "w_out", "w_z", "w_x"})


def _leaves(tree: PyTree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))


def tree_bytes(tree: PyTree) -> int:
    """Resident bytes of a tree of tensors — dtype-aware."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def kv_bytes(caches: PyTree) -> int:
    """Bytes of the K/V payload (excludes position tags)."""
    return sum(tree_bytes(entry["kv"]) for entry in caches.values())


def matmul_weight_elems(params: PyTree, cfg: tf_lib.LMConfig) -> float:
    """Logical matmul-weight elements executed per token, the unembedding
    projection included; norms and biases excluded."""
    total = 0.0

    def walk(p):
        nonlocal total
        for k, v in p.items():
            if isinstance(v, dict):
                walk(v)
            elif k in SERVING_QUANT_KEYS and v.dim() >= 2:
                total += v.numel()

    walk(params)
    if cfg.tie_embeddings:
        total += params["embed"]["w"].numel()
    else:
        total += params["unembed"]["w"].numel()
    return total


def attn_layers(cfg: tf_lib.LMConfig) -> int:
    pat = sum(1 for sp in cfg.pattern if sp.kind == "attn") * cfg.repeats
    return pat + sum(1 for sp in cfg.tail if sp.kind == "attn")


def decode_tick_flops(matmul_elems: float, n_attn: int, attn_dims: int,
                      ctx_sum: float, n_active: int) -> float:
    """Modeled FLOPs of one plain decode tick: every active slot streams
    the matmul weights for one token and attends its live context
    (``ctx_sum`` = sum over active slots of prompt + generated so far)."""
    return (2.0 * matmul_elems * n_active
            + 4.0 * n_attn * attn_dims * ctx_sum)


def prefill_span_flops(matmul_elems: float, n_attn: int, attn_dims: int,
                       start: float, n_tok: float) -> float:
    """Modeled FLOPs of ONE prefill row's chunk ``[start, start + n_tok)``:
    each token streams the matmul weights once; causal attention over the
    span sums to ``end^2 - start^2``."""
    end = float(start) + float(n_tok)
    return (2.0 * matmul_elems * float(n_tok)
            + 2.0 * n_attn * attn_dims * (end * end - float(start) ** 2))
