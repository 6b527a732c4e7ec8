"""Counter-based sampling of the port's serve engines.

JAX's engine draws with threefry keys folded from (seed, uid) and split per
step; the port does not reproduce those bits. Every draw here is instead a
pure function of (engine seed, request uid, token index, stream, vocab id),
so a request's tokens do not depend on the slot it lands in, on the other
requests of the batch, or on how many draws came before. ``stream`` keeps
the draws of one token index apart: 0 is the plain tick's sampler, the
speculative accept step (``serve/spec.py``) takes the others.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF

# the speculative accept step's draws at one token index
STREAM_ACCEPT, STREAM_RESIDUAL, STREAM_BONUS = 1, 2, 3


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash on int64 tensors holding values in [0, 2^32);
    both multipliers are below 2^31, so no product leaves int64's range."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x68E31DA5) & _M32
    return x ^ (x >> 16)


def _uniform(seed: int, uid: torch.Tensor, index: torch.Tensor,
             vocab: int, stream: int = 0) -> torch.Tensor:
    """(B, vocab) uniforms in (0, 1), a pure function of (seed, uid, token
    index, stream, vocab id): counter-based, so a draw does not depend on
    the slot a request lands in or on the other requests of the batch."""
    key = _mix32(torch.full_like(uid, seed & _M32))
    key = _mix32(key ^ (uid & _M32))
    key = _mix32(key ^ (index & _M32))                      # (B,)
    if stream:
        key = _mix32(key ^ ((stream * 0x85EBCA6B) & _M32))
    ids = torch.arange(vocab, dtype=torch.int64, device=uid.device)
    h = _mix32(_mix32(key[:, None] ^ ((ids * 0x9E3779B9) & _M32)[None]))
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def gumbel_argmax(scores: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A draw from softmax(scores) per row, by Gumbel-max on uniforms u."""
    return torch.argmax(scores - torch.log(-torch.log(u)), dim=-1)


def _sample(logits: torch.Tensor, seed: int, uid: torch.Tensor,
            index: torch.Tensor, temp: torch.Tensor, *,
            sampled: bool) -> torch.Tensor:
    """Per-slot sampling: greedy where temp == 0, else Gumbel-max at temp
    with noise keyed on (seed, uid, token index). JAX's threefry bits are
    not reproduced; the distribution is the same. ``sampled`` is the host's
    knowledge that some slot has temp > 0 (no device sync to find out)."""
    greedy = torch.argmax(logits, dim=-1)
    if not sampled:
        return greedy
    u = _uniform(seed, uid, index, logits.shape[-1])
    tsafe = torch.where(temp > 0, temp, torch.ones_like(temp))
    drawn = gumbel_argmax(logits / tsafe[:, None], u)
    return torch.where(temp > 0, drawn, greedy)
