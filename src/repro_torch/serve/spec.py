"""Speculative multi-token decode for the paged serve engine of the port
(mirror of ``repro.serve.spec``): the drafter and the accept step.

A plain decode tick streams the whole weight tree to emit one token per
slot. Speculative decode drafts ``k`` tokens per slot cheaply, scores all
of them in ONE multi-query verify pass (``transformer.paged_verify_step``,
K5 on the card), and commits the accepted prefix plus one correction or
bonus token, so one weight fetch can commit up to ``k + 1`` tokens.
Rejected lanes cost only their cache writes, which sit past the committed
length and are overwritten by the next tick.

Drafters (``DRAFTERS``):

* ``ngram`` — prompt lookup: the continuation of the most recent earlier
  occurrence of the slot's trailing bigram in its own token history.
* ``oracle`` — the target model drafts itself greedily (k plain paged
  decode passes, in the engine): an accept-all harness, not an energy win.

Acceptance at temperature 0 emits exactly the plain greedy stream. At
temperature > 0 the drafter is a point mass, so rejection sampling accepts
draft ``d`` with probability ``p(d)`` and otherwise draws from ``p`` with
``d`` removed; each emitted token's marginal is the target softmax. The
draws are the engine's counter-based ones (``serve/sampling.py``), keyed
on (seed, uid, token index) with one stream each for the acceptance
uniform, the residual draw and the bonus draw, so they depend on the
request and the token index, never on the slot or the batch; JAX's
threefry keys, advanced only while a slot accepts, are not reproduced.

Tree speculation drafts ``m`` branches per slot (``ngram_draft_tree``); the
engine folds them into batch rows of the one verify pass and runs this
accept step on every branch row.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.serve import sampling

DRAFTERS = ("ngram", "oracle")


def ngram_draft(hist: torch.Tensor, pos: torch.Tensor, k: int
                ) -> torch.Tensor:
    """Prompt-lookup drafter: ``k`` tokens per slot from its own history.

    ``hist`` (B, L) int — per-slot token history, valid through ``pos``
    inclusive (``hist[b, pos[b]]`` is the slot's pending token: sampled,
    not yet in the KV cache); ``pos`` (B,) int. Rows whose trailing bigram
    ``(hist[pos-1], hist[pos])`` occurred earlier draft the ``k`` tokens
    that followed its most recent occurrence (clamped at ``pos``: a
    near-end match pads by repeating); rows with no match repeat the
    pending token. Inactive rows give tokens the engine never emits.
    Returns (B, k) in hist's dtype.
    """
    b, length = hist.shape
    pos = pos.long()
    rows = torch.arange(b, device=hist.device)
    pend = hist[rows, pos]
    prev = hist[rows, (pos - 1).clamp(min=0)]
    p_idx = torch.arange(length - 1, device=hist.device)
    # an occurrence at p matches the trailing bigram and ends strictly
    # before it (p + 1 <= pos - 1), so its continuation starts in range
    match = ((hist[:, :-1] == prev[:, None])
             & (hist[:, 1:] == pend[:, None])
             & (p_idx[None] <= (pos - 2)[:, None]))
    best = torch.where(match, p_idx[None], -1).amax(dim=1)       # (B,)
    start = torch.where(best >= 0, best + 2, pos)   # no match: pending
    idx = torch.minimum(
        start[:, None] + torch.arange(k, device=hist.device)[None],
        pos[:, None])
    return hist.gather(1, idx)


def ngram_draft_tree(hist: torch.Tensor, pos: torch.Tensor, k: int, m: int
                     ) -> torch.Tensor:
    """Tree drafter: ``m`` independent ``k``-token branches per slot from
    the ``m`` most recent occurrences of the trailing bigram.

    Branch 0 is exactly ``ngram_draft`` (the most recent match), so branch
    0's stream is the linear stream. Later branches take the next most
    recent matches; a slot with fewer than ``m`` matches pads its tail
    branches by repeating the pending token. Returns (B, M, K) in hist's
    dtype; inactive rows give tokens the engine never emits.
    """
    b, length = hist.shape
    pos = pos.long()
    rows = torch.arange(b, device=hist.device)
    pend = hist[rows, pos]
    prev = hist[rows, (pos - 1).clamp(min=0)]
    p_idx = torch.arange(length - 1, device=hist.device)
    match = ((hist[:, :-1] == prev[:, None])
             & (hist[:, 1:] == pend[:, None])
             & (p_idx[None] <= (pos - 2)[:, None]))
    # the m most recent match positions, descending (-1 pads short lists)
    ranked = torch.where(match, p_idx[None], -1).sort(
        dim=1, descending=True).values[:, :m]
    starts = torch.where(ranked >= 0, ranked + 2, pos[:, None])   # (B, M)
    idx = torch.minimum(
        starts[:, :, None] + torch.arange(k, device=hist.device)[None, None],
        pos[:, None, None])                                       # (B, M, K)
    return hist.gather(1, idx.reshape(b, -1)).reshape(b, -1, k)


def speculative_accept(logits: torch.Tensor, drafts: torch.Tensor,
                       temp: torch.Tensor, *, seed: int, uid: torch.Tensor,
                       gen: torch.Tensor, sampled: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accept or reject ``k`` drafted tokens against the verify logits.

    ``logits`` (B, K+1, V) fp32 — row j is the distribution of the token
    after j drafts (row 0: after the pending token; row K: the bonus
    position); ``drafts`` (B, K); ``temp`` (B,) per-slot temperature (0 =
    greedy); ``uid`` and ``gen`` (B,) key the draws of lane j at token
    index ``gen + j``; ``sampled`` is the host's knowledge that some slot
    has temp > 0 (with none, no draw is made).

    Returns ``(n_acc, fix_tok)``: ``n_acc`` (B,) in [0, K], the length of
    the accepted draft prefix; ``fix_tok`` (B,), the token emitted at the
    first rejected lane (greedy: the argmax; temperature: a draw from the
    residual), or the bonus token when every draft was accepted. The slot
    emits ``drafts[:n_acc] + [fix_tok]``.
    """
    b, k1, vocab = logits.shape
    k = k1 - 1
    greedy = torch.argmax(logits, dim=-1)                        # (B, K+1)
    acc = drafts == greedy[:, :k]
    corr = greedy
    if sampled:
        use_t = temp > 0
        tsafe = torch.where(use_t, temp, torch.ones_like(temp))
        scaled = logits / tsafe[:, None, None]
        p = torch.softmax(scaled[:, :k], dim=-1)                 # (B, K, V)
        idx = gen[:, None] + torch.arange(k1, device=gen.device)[None]
        uids = uid[:, None].expand(b, k1)

        def draws(lanes, n, stream):
            u = sampling._uniform(seed, uids[:, lanes].reshape(-1),
                                  idx[:, lanes].reshape(-1), n, stream)
            return u.reshape(b, -1, n)

        p_d = p.gather(2, drafts[..., None])[..., 0]             # (B, K)
        u_acc = draws(slice(0, k), 1, sampling.STREAM_ACCEPT)[..., 0]
        # point-mass draft: accept w.p. p(d); the residual max(p - q, 0)
        # is p with the draft zeroed (the draw renormalizes)
        res = p.scatter(2, drafts[..., None], 0.0)
        res_tok = sampling.gumbel_argmax(
            torch.log(res.clamp_min(1e-30)),
            draws(slice(0, k), vocab, sampling.STREAM_RESIDUAL))
        bonus = sampling.gumbel_argmax(
            scaled[:, k], draws(slice(k, k1), vocab,
                                sampling.STREAM_BONUS)[:, 0])
        acc = torch.where(use_t[:, None], u_acc < p_d, acc)
        corr = torch.where(use_t[:, None],
                           torch.cat([res_tok, bonus[:, None]], dim=1), corr)
    n_acc = torch.cumprod(acc.long(), dim=1).sum(dim=1)          # (B,)
    fix = corr.gather(1, n_acc[:, None])[:, 0]
    return n_acc, fix
