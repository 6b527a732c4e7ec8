"""Dtype-aware modeled traffic/compute for LM serving and training (mirror
of ``repro.models.costing``).

The serve engine bills every tick's bytes and FLOPs through these, and the
train engine every step's, from the resident tensors' real sizes, so the
port's ``CarbonAccountant`` report equals the JAX engine's on the same
workload:

* a weight of E elements costs 2E FLOPs per token regardless of storage
  dtype;
* causal full-sequence attention costs 2 * n_attn * (H*Dh) * S FLOPs per
  token (the causal half of the 4x qk+pv term).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import torch

from repro_torch.core import energy
from repro_torch.models import transformer as tf_lib
from repro_torch.quant.int8 import SERVING_QUANT_KEYS

PyTree = Any


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
    """Resident bytes of a tree of tensors — dtype-aware (int8 leaves bill
    1 byte)."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def kv_bytes(caches: PyTree) -> int:
    """Bytes of the K/V payload (codes + scales; excludes position tags
    and SSD states, as the reference's does)."""
    return sum(tree_bytes(entry[key]) for entry in caches.values()
               for key in ("kv", "kv_scale") if key in entry)


def matmul_weight_elems(params: PyTree, cfg: tf_lib.LMConfig) -> float:
    """Logical matmul-weight elements executed per token, the unembedding
    projection included; norms, biases and routers excluded. An int8 leaf
    counts its codes: int8 changes bytes, not FLOPs. MoE experts count at
    their top_k / n_experts activation fraction. An SSD block bills its
    ``SERVING_QUANT_KEYS`` leaves (``w_z``, ``w_x``, ``w_out``), not
    ``w_b``, ``w_c`` or ``w_dt``; zamba2's ``shared_attn`` group is billed
    once, however many sites run it: the reference's model."""
    total = 0.0
    moe_frac = (cfg.moe_cfg.top_k / cfg.moe_cfg.n_experts
                if cfg.moe_cfg is not None else 1.0)

    def walk(p, frac):
        nonlocal total
        for k, v in p.items():
            if isinstance(v, dict):
                if "q8" not in v:
                    walk(v, moe_frac if k == "moe" else frac)
                elif k in SERVING_QUANT_KEYS:
                    total += frac * v["q8"].numel()
            elif k in SERVING_QUANT_KEYS and v.dim() >= 2:
                total += frac * v.numel()

    walk(params, 1.0)
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


def block_recompute_flops(matmul_elems: float, n_attn: int, attn_dims: int,
                          start_tok: int, n_tok: int) -> float:
    """Modeled FLOPs to *recompute* one cached KV block of ``n_tok`` tokens
    whose first token sits at absolute position ``start_tok`` (= block
    depth x page size): each token streams the matmul weights once and
    causally attends its own prefix,

        2 * matmul_elems * n_tok
        + 4 * n_attn * attn_dims * sum_{p=start}^{start+n-1} (p + 1).

    The paged engine's cost-aware eviction divides this by the block's
    resident bytes, so deeper blocks are the last to go."""
    n = float(n_tok)
    attn_keys = n * float(start_tok) + n * (n + 1.0) / 2.0
    return 2.0 * matmul_elems * n + 4.0 * n_attn * attn_dims * attn_keys


def prefill_span_flops(matmul_elems: float, n_attn: int, attn_dims: int,
                       start: float, n_tok: float) -> float:
    """Modeled FLOPs of ONE prefill row's chunk ``[start, start + n_tok)``:
    each token streams the matmul weights once; causal attention over the
    span sums to ``end^2 - start^2``."""
    end = float(start) + float(n_tok)
    return (2.0 * matmul_elems * float(n_tok)
            + 2.0 * n_attn * attn_dims * (end * end - float(start) ** 2))


def spec_verify_flops(matmul_elems: float, n_attn: int, attn_dims: int,
                      ctx_sum: float, n_active: int, width: int) -> float:
    """Modeled FLOPs of one speculative verification pass: a q-block of
    ``width`` tokens per active slot through the matmul weights ONCE, with
    causal attention — lane t of a slot at live context c attends c + t
    keys, so the attention term is ``sum_t (c + t) = width*c +
    width*(width-1)/2`` per slot."""
    return (2.0 * matmul_elems * width * n_active
            + 4.0 * n_attn * attn_dims
            * (width * ctx_sum + n_active * width * (width - 1) / 2.0))


def spec_oracle_draft_flops(matmul_elems: float, n_attn: int, attn_dims: int,
                            ctx_sum: float, n_active: int, k: int) -> float:
    """Modeled FLOPs of the ``oracle`` drafter: ``k`` sequential plain
    decode passes of the target model itself, context growing by one per
    pass."""
    return sum(decode_tick_flops(matmul_elems, n_attn, attn_dims,
                                 ctx_sum + j * n_active, n_active)
               for j in range(k))


def expected_replay_ticks(interval: int) -> float:
    """Expected ticks of journal replay a warm restart pays, for a crash
    uniform over the checkpoint cycle: snapshots land every ``interval``
    ticks, so the tail since the last one is uniform on ``[0, interval)``
    with mean ``(interval - 1) / 2``. 0.0 when snapshots are off."""
    if interval <= 0:
        return 0.0
    return (float(interval) - 1.0) / 2.0


def durability_overhead_bytes_per_tick(snapshot_bytes: float,
                                       journal_bytes_per_tick: float,
                                       interval: int) -> float:
    """Steady-state durability write traffic a tick: every tick appends a
    journal record, and every ``interval`` ticks a whole snapshot lands.
    Shrinking the interval raises this while
    :func:`expected_replay_ticks` (the recompute of a recovery) falls."""
    amortized = (float(snapshot_bytes) / float(interval)
                 if interval > 0 else 0.0)
    return float(journal_bytes_per_tick) + amortized


def lm_train_step_cost(params: PyTree, cfg: tf_lib.LMConfig, *,
                       batch: int, seq_len: int,
                       opt_state: PyTree = None) -> energy.TrainStepCost:
    """Per-optimizer-step modeled cost of one LM training step
    (costing.py:174): the backward is twice the forward's FLOPs, reads the
    weights and writes fp32 grads; the update reads the grads, reads and
    writes the optimizer state and the weights. ``params`` is the live
    weight tree, ``opt_state`` the optimizer state tree."""
    tokens = float(batch) * float(seq_len)
    w_elems = matmul_weight_elems(params, cfg)
    attn_dims = cfg.n_heads * cfg.resolved_head_dim
    attn_flops_tok = 2.0 * attn_layers(cfg) * attn_dims * seq_len
    fwd_flops = (2.0 * w_elems + attn_flops_tok) * tokens
    weight_bytes = float(tree_bytes(params))
    n_params = float(sum(t.numel() for t in _leaves(params)))
    grad_bytes = 4.0 * n_params                    # grads are fp32
    opt_bytes_ = float(tree_bytes(opt_state)) if opt_state is not None \
        else 0.0
    return energy.TrainStepCost(
        fwd_flops=fwd_flops,
        bwd_flops=2.0 * fwd_flops,
        fwd_bytes=weight_bytes,
        bwd_bytes=weight_bytes + grad_bytes,
        opt_bytes=grad_bytes + 2.0 * opt_bytes_ + 2.0 * weight_bytes,
        tokens=tokens,
        samples=float(batch),
    )
