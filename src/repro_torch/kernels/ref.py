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


def paged_gather(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """The slot-major (B, NB * page_size, Hkv, D) view of a pool
    (P, page_size, Hkv, D) through the page table (B, NB), as
    ``repro.models.transformer._paged_gather`` builds it, in the pool's
    storage dtype. It copies the whole table's pages: the kernels read the
    pool in place instead."""
    g = pool[page_table.long()]                     # (B, NB, ps, Hkv, D)
    return g.flatten(1, 2)


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, page_table: torch.Tensor,
                               lengths: torch.Tensor, *, scale: float,
                               window: int = -1) -> torch.Tensor:
    """What ``repro.kernels.decode_attention._paged_kernel`` computes: the
    K/V view gathered through the table, then ``decode_attention_ref``
    (tag-masked ``layers.sdpa``, zeros for dead slots). K/V are read in
    their storage dtype and upcast to fp32, as the kernel reads them.

    q: (B, H, D); pools: (P, page_size, Hkv, D); page_table: (B, NB);
    lengths: (B,). Returns (B, H, D) in q.dtype."""
    return decode_attention_ref(q, paged_gather(k_pool, page_table),
                                paged_gather(v_pool, page_table), lengths,
                                scale=scale, window=window)


def paged_prefill_attention_ref(q: torch.Tensor, k_new: torch.Tensor,
                                v_new: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor, page_table: torch.Tensor,
                                starts: torch.Tensor, lens: torch.Tensor, *,
                                scale: float, window: int = -1
                                ) -> torch.Tensor:
    """What ``repro.kernels.flash_attention._paged_prefill_kernel``
    computes, with the mask of the XLA branch of
    ``repro.models.transformer.paged_extend``: the cached window gathered
    through the table (positions below ``start``, in the pool's storage
    dtype) and the chunk's own full-precision K/V (positions
    ``start + k_rel`` for ``k_rel < len``) as one tagged key set, then a
    causal, windowed, tag-masked ``layers.sdpa`` in fp32. The XLA branch
    splices the chunk into the gathered window instead, which needs the
    table to cover ``start + len``; the tags give the same keys without
    that.

    q: (B, C, H, D); k_new/v_new: (B, C, Hkv, D); pools: (P, page_size,
    Hkv, D); page_table: (B, NB); starts, lens: (B,). Returns (B, C, H, D)
    in q.dtype; rows at or past ``lens`` (every row of a dead row) are
    zeros."""
    c = q.shape[1]
    starts, lens = starts.long(), lens.long()
    k_all = paged_gather(k_pool, page_table)
    v_all = paged_gather(v_pool, page_table)
    j_abs = torch.arange(k_all.shape[1], device=q.device)[None]  # (1, W)
    rel = torch.arange(c, device=q.device)[None]                  # (1, C)
    pos_abs = starts[:, None] + rel                               # (B, C)
    tags = torch.cat([torch.where(j_abs < starts[:, None], j_abs, -1),
                      torch.where(rel < lens[:, None], pos_abs, -1)], dim=1)
    k_att = torch.cat([k_all.float(), k_new.float()], dim=1)
    v_att = torch.cat([v_all.float(), v_new.float()], dim=1)
    mask = layers.attention_mask(pos_abs, tags, causal=True, window=window)
    mask &= (tags >= 0)[:, None, :]
    out = layers.sdpa(q, k_att, v_att, mask, scale)
    live = rel < lens[:, None]
    return torch.where(live[..., None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))
