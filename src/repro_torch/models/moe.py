"""Mixture-of-Experts FFN of the PyTorch port: top-k token-choice routing
(mirror of ``repro.models.moe``).

* ``moe_dense``    — the all-experts reference: every expert computes every
                     token, combined by the routing weights.
* ``moe_capacity`` — capacity-limited dispatch, the path every model call
                     takes: tokens are split into groups, each group ranks
                     its routes first come first served, token by token,
                     and a route whose rank reaches the capacity is dropped.

The reference builds ``moe_capacity``'s dispatch and combine as one-hot
``(G, Tg, E, C)`` tensors contracted by einsums. Here the same slots come
from a stable sort of the routes by expert (``_ranks``): each kept route's
token row is copied to slot ``(e, g * C + rank)`` of an ``(E, G * C, d)``
buffer, the experts run as batched products over it, and each token adds
its kept routes' gated outputs in ascending expert order, the order in
which the one-hot contraction meets them. Every term is one exact product,
so the two agree to rounding. A slot no route fills stays zero, and an
expert's output on a zero row is exactly zero (silu(0) * h = 0), as in the
reference. Expert parallelism (``moe_ep``) is not ported: it belongs with
the parallel layer. ``_counting_sort_dispatch`` is kept as a plain
function.

Router: softmax over the top-k logits (Mixtral/DeepSeek style), with the
Switch load-balance auxiliary loss and the router z-loss.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.models import common, layers

# elements of an expert leaf drawn (init) or dequantized (int8) at a
# time: a whole leaf of kimi-k2 is 5.6 G elements
_EXPERT_CHUNK = 1 << 28


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                  # per-expert hidden size
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    act: str = "silu"
    router_z_coef: float = 1e-3
    lb_coef: float = 1e-2

    def capacity(self, n_tokens: int) -> int:
        cap = int(self.capacity_factor * n_tokens * self.top_k
                  / self.n_experts)
        return max(cap, self.top_k)


def init_moe(cfg: MoEConfig, lead=(), *, generator: torch.Generator,
             device, dtype=torch.float32) -> dict:
    """``router`` (d, E) fp32, ``w_in``/``w_gate`` (E, d, f) and ``w_out``
    (E, f, d) in ``dtype``, each behind the ``lead`` stack dims, with the
    reference's fan-in init. The experts are drawn a few at a time, so the
    fp32 draw never holds a whole stacked leaf."""
    lead = tuple(lead)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    kw = dict(generator=generator, device=device)

    def experts(shape, fan_in):
        out = torch.empty(lead + (e,) + shape, dtype=dtype, device=device)
        flat = out.view(-1, *shape)
        step = max(1, _EXPERT_CHUNK // math.prod(shape))
        for i in range(0, flat.shape[0], step):
            n = min(step, flat.shape[0] - i)
            flat[i:i + n] = common.fan_in_init((n,) + shape, fan_in=fan_in,
                                               dtype=dtype, **kw)
        return out

    return {"router": common.fan_in_init(lead + (d, e), fan_in=d,
                                         dtype=torch.float32, **kw),
            "w_in": experts((d, f), d),
            "w_gate": experts((d, f), d),
            "w_out": experts((f, d), f)}


# -----------------------------------------------------------------------------
# Routing
# -----------------------------------------------------------------------------

def route(params, cfg: MoEConfig, x2d: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2d (T, d) -> (gates (T, k) fp32, expert ids (T, k) int64, aux loss).

    Ties in the logits go to the lower expert id, as ``jax.lax.top_k``
    breaks them: a stable descending sort keeps equal logits in id order
    (``torch.topk`` promises no order)."""
    logits = x2d.float() @ params["router"].float()
    top_logits, expert_ids = torch.sort(logits, dim=-1, descending=True,
                                        stable=True)
    top_logits = top_logits[:, :cfg.top_k]
    expert_ids = expert_ids[:, :cfg.top_k]
    gates = torch.softmax(top_logits, dim=-1)
    # Switch-style load-balance loss: E * sum_e (frac_tokens_e * mean_prob_e)
    probs = torch.softmax(logits, dim=-1)
    n_routes = x2d.shape[0] * cfg.top_k
    counts = torch.zeros(cfg.n_experts, dtype=torch.float32,
                         device=x2d.device).index_add_(
        0, expert_ids.reshape(-1),
        torch.ones(n_routes, dtype=torch.float32, device=x2d.device))
    frac = counts / n_routes
    lb = cfg.n_experts * torch.sum(frac * probs.mean(dim=0))
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    aux = cfg.lb_coef * lb + cfg.router_z_coef * z
    return gates, expert_ids, aux


def _expert_ffn(w_in, w_gate, w_out, x: torch.Tensor, act: str
                ) -> torch.Tensor:
    """x (E, C, d) through each expert's gated FFN -> (E, C, d). Weights go
    through ``layers.wl``: an int8 leaf is dequantized, as the reference's
    MoE does (its experts never take the fused int8 kernel)."""
    act_fn = layers._act(act)
    h = torch.bmm(x, layers.wl(w_in, x.dtype))
    g = torch.bmm(x, layers.wl(w_gate, x.dtype))
    return torch.bmm(act_fn(g) * h, layers.wl(w_out, x.dtype))


def _experts(params, cfg: MoEConfig, xin: torch.Tensor) -> torch.Tensor:
    """``_expert_ffn`` over every expert of ``xin`` (E, C, d). An int8 leaf
    is dequantized a block of experts at a time, never whole: the values
    are the same, since dequantization is elementwise."""
    w_in = params["w_in"]
    if not (isinstance(w_in, dict) and "q8" in w_in):
        return _expert_ffn(w_in, params["w_gate"], params["w_out"], xin,
                           cfg.act)
    e = xin.shape[0]
    step = max(1, _EXPERT_CHUNK // (cfg.d_model * cfg.d_ff))
    out = torch.empty_like(xin)

    def part(w, lo, hi):
        return {"q8": w["q8"][lo:hi], "s8": w["s8"][lo:hi]}

    for lo in range(0, e, step):
        hi = min(lo + step, e)
        out[lo:hi] = _expert_ffn(part(w_in, lo, hi),
                                 part(params["w_gate"], lo, hi),
                                 part(params["w_out"], lo, hi),
                                 xin[lo:hi], cfg.act)
    return out


def _combine(terms: torch.Tensor, expert_ids: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """(T, k, d) gated route outputs -> (T, d): each token's terms added one
    at a time in ascending expert id, the order the reference's contraction
    over experts meets them, in fp32, rounded to ``dtype`` once."""
    order = torch.argsort(expert_ids, dim=1)
    terms = torch.gather(terms, 1,
                         order[..., None].expand(-1, -1, terms.shape[-1]))
    acc = terms[:, 0].float()
    for j in range(1, terms.shape[1]):
        acc = acc + terms[:, j].float()
    return acc.to(dtype)


# -----------------------------------------------------------------------------
# Dense reference path
# -----------------------------------------------------------------------------

def moe_dense(params, cfg: MoEConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-experts reference. x (B, S, d) -> (y, aux loss). The experts run
    one at a time over every token and are added in expert order, the
    reference's ``te,etd->td`` contraction without its (E, T, d) tensor
    (45 GB at kimi-k2's width for 4096 tokens)."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    gates, expert_ids, aux = route(params, cfg, x2d)
    weights = torch.zeros(b * s, cfg.n_experts, dtype=torch.float32,
                          device=x.device).scatter_(1, expert_ids, gates)
    weights = weights.to(x.dtype).float()
    act_fn = layers._act(cfg.act)
    y = torch.zeros(b * s, d, dtype=torch.float32, device=x.device)
    for e in range(cfg.n_experts):
        h = x2d @ params["w_in"][e].to(x.dtype)
        g = x2d @ params["w_gate"][e].to(x.dtype)
        y_e = (act_fn(g) * h) @ params["w_out"][e].to(x.dtype)
        y = y + weights[:, e:e + 1] * y_e.float()
    return y.to(x.dtype).reshape(b, s, d), aux


# -----------------------------------------------------------------------------
# Capacity-dispatch path
# -----------------------------------------------------------------------------

def _ranks(ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """First-come ranks: ``ids`` (G, N) expert ids in token-major route
    order -> (G, N) the number of earlier routes of the same group to the
    same expert (the reference's ``cumsum(one_hot) - one_hot``)."""
    ids = ids.long()
    g, n = ids.shape
    order = torch.argsort(ids, dim=1, stable=True)
    counts = torch.zeros(g, n_experts, dtype=torch.long,
                         device=ids.device).scatter_add_(
        1, ids, torch.ones_like(ids))
    first = torch.cumsum(counts, dim=1) - counts                  # (G, E)
    sorted_ids = torch.gather(ids, 1, order)
    rank_sorted = (torch.arange(n, device=ids.device)[None]
                   - torch.gather(first, 1, sorted_ids))
    return torch.empty_like(ids).scatter_(1, order, rank_sorted)


def _group_ranks(expert_ids: torch.Tensor, n_experts: int, group_size: int
                 ) -> Tuple[int, int, torch.Tensor]:
    """(groups g, tokens a group tg, (T, k) first-come ranks within each
    group) of (T, k) expert ids, as ``moe_capacity`` groups them."""
    t, k = expert_ids.shape
    g = max(t // group_size, 1)
    tg = t // g
    if g * tg != t:
        raise ValueError(f"{t} tokens do not split into groups of "
                         f"{group_size}")
    return g, tg, _ranks(expert_ids.reshape(g, tg * k),
                         n_experts).reshape(t, k)


def moe_capacity(params, cfg: MoEConfig, x: torch.Tensor,
                 group_size: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-padded token-choice dispatch (moe.py:113). x (B, S, d) ->
    (y, aux loss). The B * S tokens form ``g = max(T // group_size, 1)``
    groups of ``T // g``; a partition that does not cover T raises
    ``ValueError`` (the reference asserts). Within a group, routes are
    ranked first come first served, token by token, and a route whose rank
    reaches ``cfg.capacity(T // g)`` is dropped: it adds nothing, and the
    kept gates are not renormalized."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    x2d = x.reshape(t, d)
    gates, expert_ids, aux = route(params, cfg, x2d)
    g, tg, rank = _group_ranks(expert_ids, e, group_size)
    cap = cfg.capacity(tg)
    keep = rank < cap
    group = torch.arange(t, device=x.device)[:, None] // tg       # (T, 1)
    slot = expert_ids * (g * cap) + group * cap + rank            # (T, k)
    # every dropped route lands in one scratch row past the experts' slots
    dest = torch.where(keep, slot, e * g * cap).reshape(-1)
    buf = x2d.new_zeros(e * g * cap + 1, d)
    buf[dest] = x2d.repeat_interleave(k, dim=0)
    y_e = _experts(params, cfg, buf[:-1].view(e, g * cap, d))
    y_routes = y_e.reshape(e * g * cap, d)[torch.where(keep, slot, 0)]
    # the reference casts the combine weights to x's dtype
    w = torch.where(keep, gates, 0.0).to(x.dtype)
    terms = torch.where(keep[..., None],
                        y_routes.float() * w[..., None].float(), 0.0)
    return _combine(terms, expert_ids, x.dtype).reshape(b, s, d), aux


def dropped_routes(cfg: MoEConfig, expert_ids: torch.Tensor,
                   group_size: int) -> torch.Tensor:
    """(T, k) bool: the routes ``moe_capacity`` drops for these ids, with
    the same groups and capacity."""
    _, tg, rank = _group_ranks(expert_ids, cfg.n_experts, group_size)
    return rank >= cfg.capacity(tg)


# -----------------------------------------------------------------------------
# Counting-sort dispatch (the expert-parallel path's slot assignment)
# -----------------------------------------------------------------------------

def _counting_sort_dispatch(expert_ids: torch.Tensor, n_experts: int,
                            capacity: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assign each (token, k) routing decision a slot in (E, C) buffers.

    Returns (slot_token (E*C,) int64 token index or the sentinel T,
    slot_of_route (T, k) int64 flat slot or -1 if dropped)."""
    t, k = expert_ids.shape
    flat_e = expert_ids.reshape(-1).long()
    rank = _ranks(flat_e[None], n_experts)[0]
    keep = rank < capacity
    slot = torch.where(keep, flat_e * capacity + rank, -1)
    token_of_route = torch.arange(t, device=expert_ids.device
                                  ).repeat_interleave(k)
    # a scratch slot at the end absorbs dropped routes
    slot_token = torch.full((n_experts * capacity + 1,), t, dtype=torch.long,
                            device=expert_ids.device)
    slot_token[torch.where(keep, slot, n_experts * capacity)] = token_of_route
    return slot_token[:-1], slot.reshape(t, k)
