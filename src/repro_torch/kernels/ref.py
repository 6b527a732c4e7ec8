"""Plain PyTorch versions of the port's kernels (the correctness contracts):
K1-K3 and K5 attention, K4 the int8 weight matmul and K9 its backward, the
training flash attention (K6's forward with lse and K7/K8's backward),
K10, the inference flash attention, and K11, the ternary weight matmul.

The CPU path of ``ops`` runs these, and ``chip_smoke.py`` holds each CUDA
kernel against them on the card. Nothing on the card's main path calls them.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import layers
from repro_torch.quant import int8 as int8_lib

NEG_INF = -1e30


def ternary_matmul_ref(x: torch.Tensor, q: torch.Tensor,
                       scale: torch.Tensor,
                       out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """What ``repro.kernels.ternary_matmul._ternary_matmul_kernel``
    computes (K11): ``(x @ q) * scale[n]`` with q int8 in {-1, 0, 1}, an
    fp32 dot of x and the codes widened to fp32, cast to ``out_dtype`` (x's
    dtype by default). x: (M, K); q: (K, N) int8; scale: (N,) fp32."""
    return ((x.float() @ q.float()) * scale.float()).to(out_dtype or x.dtype)


def int8_matmul_ref(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """What ``repro.kernels.int8_matmul._int8_matmul_kernel`` computes:
    ``(x @ q) * scale[n]`` with fp32 accumulation, cast to ``out_dtype``
    (x's dtype by default). x: (M, K); q: (K, N) int8; scale: (N,) fp32."""
    return ((x.float() @ q.float()) * scale).to(out_dtype or x.dtype)


def int8_matmul_dx_ref(dy: torch.Tensor, q: torch.Tensor,
                       scale: torch.Tensor,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """What ``repro.kernels.int8_matmul._int8_bwd_dx_kernel`` computes (K9):
    ``dx[m, k] = sum_n dy[m, n] * scale[n] * q[k, n]`` in fp32, cast to
    ``out_dtype``. dy: (M, N); q: (K, N) int8; scale: (N,) fp32."""
    return ((dy.float() * scale) @ q.float().T).to(out_dtype)


def _dequant(k, v, k_scale, v_scale):
    """int8 codes x their per-row scales in fp32, as the kernels dequantize
    in registers; fp K/V pass through."""
    if k_scale is None:
        return k, v
    return (int8_lib.dequantize_rowwise(k, k_scale),
            int8_lib.dequantize_rowwise(v, v_scale))


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, *, scale: float,
                         window: int = -1,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """What ``repro.kernels.decode_attention._decode_kernel`` computes, as
    tag-masked fp32 softmax attention (``layers.sdpa``).

    q: (B, H, D); k/v: (B, Sk, Hkv, D); lengths: (B,) valid prefix per slot.
    The query sits at position ``lengths - 1``; keys at ``>= lengths`` or,
    with ``window > 0``, at ``lengths - 1 - pos >= window`` are masked. An
    all-masked row of ``sdpa`` averages V, but a dead slot (length 0) must
    return zeros, so those rows are zeroed. Returns (B, H, D) in q.dtype.
    With ``k_scale``/``v_scale`` (B, Sk, Hkv) k/v are int8 codes,
    dequantized in fp32 first.
    """
    k, v = _dequant(k, v, k_scale, v_scale)
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
    storage dtype (a scale pool (P, page_size, Hkv) gives (B, NB *
    page_size, Hkv)). It copies the whole table's pages: the kernels read
    the pool in place instead."""
    g = pool[page_table.long()]                     # (B, NB, ps, Hkv, D)
    return g.flatten(1, 2)


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, page_table: torch.Tensor,
                               lengths: torch.Tensor, *, scale: float,
                               window: int = -1,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """What ``repro.kernels.decode_attention._paged_kernel`` computes: the
    K/V view gathered through the table, then ``decode_attention_ref``
    (tag-masked ``layers.sdpa``, zeros for dead slots). K/V are read in
    their storage dtype and upcast to fp32, as the kernel reads them; int8
    codes and their scale pools (P, page_size, Hkv) are both gathered.

    q: (B, H, D); pools: (P, page_size, Hkv, D); page_table: (B, NB);
    lengths: (B,). Returns (B, H, D) in q.dtype."""
    ks = vs = None
    if k_scale is not None:
        ks = paged_gather(k_scale, page_table)
        vs = paged_gather(v_scale, page_table)
    return decode_attention_ref(q, paged_gather(k_pool, page_table),
                                paged_gather(v_pool, page_table), lengths,
                                scale=scale, window=window, k_scale=ks,
                                v_scale=vs)


def paged_verify_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, page_table: torch.Tensor,
                               lengths: torch.Tensor, *, scale: float,
                               window: int = -1,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """What ``repro.kernels.decode_attention._paged_verify_kernel``
    computes, with the mask of the XLA branch of
    ``repro.models.transformer._paged_verify_attn``: the K/V view gathered
    through the table in the pool's storage dtype (int8 codes dequantized in
    fp32 with their gathered scales), then a tag-masked ``layers.sdpa`` in
    fp32 where lane t of slot b sits at ``q_pos = lengths[b] - T + t`` and
    attends keys ``k_pos <= q_pos`` below ``lengths[b]`` (and
    ``q_pos - k_pos < window`` when ``window > 0``).

    q: (B, T, H, D); pools: (P, page_size, Hkv, D); page_table: (B, NB);
    lengths: (B,), counting the T lanes. Returns (B, T, H, D) in q.dtype. A
    row with no valid key (every row of a dead slot, a lane with
    ``q_pos < 0``, or one past the table's capacity under a window) is
    zeros, as in the CUDA kernel; ``sdpa`` and the Pallas kernel average V
    there."""
    t = q.shape[1]
    k_all = paged_gather(k_pool, page_table)
    v_all = paged_gather(v_pool, page_table)
    if k_scale is not None:
        k_all, v_all = _dequant(k_all, v_all,
                                paged_gather(k_scale, page_table),
                                paged_gather(v_scale, page_table))
    lengths = lengths.long()
    j_abs = torch.arange(k_all.shape[1], device=q.device)[None]  # (1, W)
    tags = torch.where(j_abs < lengths[:, None], j_abs, -1)       # (B, W)
    q_pos = (lengths - t)[:, None] + torch.arange(t, device=q.device)[None]
    mask = layers.attention_mask(q_pos, tags, causal=True, window=window)
    mask &= (tags >= 0)[:, None, :]                               # (B, T, W)
    out = layers.sdpa(q, k_all, v_all, mask, scale)
    return torch.where(mask.any(-1)[..., None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def paged_prefill_attention_ref(q: torch.Tensor, k_new: torch.Tensor,
                                v_new: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor, page_table: torch.Tensor,
                                starts: torch.Tensor, lens: torch.Tensor, *,
                                scale: float, window: int = -1,
                                k_scale: Optional[torch.Tensor] = None,
                                v_scale: Optional[torch.Tensor] = None
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
    in q.dtype. A padding lane of a live row (``len <= t < C``) attends
    every key of the row below ``start + len`` that its window reaches, as
    the Pallas kernel's does: an MoE block downstream ranks its routes
    with the live ones. Every row of a dead row (``len = 0``), and a lane
    no key reaches, is zeros. With ``k_scale``/``v_scale`` (P, page_size,
    Hkv) the pools hold int8 codes, gathered with their scales and
    dequantized in fp32; the chunk's own K/V stay in q's dtype."""
    c = q.shape[1]
    starts, lens = starts.long(), lens.long()
    k_all = paged_gather(k_pool, page_table)
    v_all = paged_gather(v_pool, page_table)
    if k_scale is not None:
        k_all, v_all = _dequant(k_all, v_all,
                                paged_gather(k_scale, page_table),
                                paged_gather(v_scale, page_table))
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
    # a lane past a live row's length sees the row's keys (causally all
    # below it); the dead row's lanes and a lane no key reaches are zeros
    live = mask.any(dim=-1) & (lens[:, None] > 0)
    return torch.where(live[..., None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


# -----------------------------------------------------------------------------
# Training flash attention (K6, K7, K8)
# -----------------------------------------------------------------------------

def flash_mask(sq: int, sk: int, *, causal: bool, window: int,
               device=None) -> torch.Tensor:
    """(Sq, Sk) valid pairs: query i lines up with key i, ``i - j >= 0``
    when causal, ``i - j < window`` when window > 0 (the reference's
    ``_tile_mask`` by absolute index, flash_attention.py:29)."""
    diff = (torch.arange(sq, device=device)[:, None]
            - torch.arange(sk, device=device)[None])
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= diff >= 0
    if window > 0:
        mask &= diff < window
    return mask


def _grouped(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, Sq, H, D) -> (B, Sq, Hkv, rep, D) in fp32."""
    b, sq, h, d = q.shape
    return q.float().reshape(b, sq, hkv, h // hkv, d)


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, scale: float,
                            causal: bool = True, window: int = -1):
    """What K6 (``_flash_kernel`` with ``save_lse``) computes: the softmax
    of ``scale * q k^T`` over the valid keys times v, in q's dtype, and
    ``lse = m + log(max(l, 1e-30))`` (B, H, Sq) fp32. q (B, Sq, H, D),
    k/v (B, Sk, Hkv, D). p is masked explicitly, so a row with no valid key
    is zeros (the Pallas body averages V there) with lse about -1e30."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    s = torch.einsum("bqhrd,bnhd->bhrqn", _grouped(q, hkv) * scale,
                     k.float())
    mask = flash_mask(sq, sk, causal=causal, window=window, device=q.device)
    m = torch.where(mask, s, NEG_INF).amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhrqn,bnhd->bqhrd", p, v.float()) \
        / l.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(l)).reshape(b, h, sq)
    return out.reshape(b, sq, h, d).to(q.dtype), lse


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor, *,
                            scale: float, causal: bool = True,
                            window: int = -1):
    """What K7 and K8 compute (flash_attention.py:170-185), recomputing p
    from lse: ``delta = rowsum(dO * O)``, ``p = exp(s - lse)`` under the
    explicit mask, ``dS = p * (dO V^T - delta)``, ``dQ = scale * dS K``,
    ``dK = dS^T (scale * Q)`` and ``dV = p^T dO``, each GQA group summed.
    Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    qs = _grouped(q, hkv) * scale
    do = _grouped(dout, hkv)
    kf, vf = k.float(), v.float()
    delta = (do * _grouped(out, hkv)).sum(-1).permute(0, 2, 3, 1)
    s = torch.einsum("bqhrd,bnhd->bhrqn", qs, kf)
    mask = flash_mask(sq, sk, causal=causal, window=window, device=q.device)
    p = torch.where(mask, torch.exp(s - lse.reshape(b, hkv, rep, sq, 1)),
                    0.0)
    dp = torch.einsum("bqhrd,bnhd->bhrqn", do, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhrqn,bnhd->bqhrd", ds, kf) * scale
    dk = torch.einsum("bhrqn,bqhrd->bnhd", ds, qs)
    dv = torch.einsum("bhrqn,bqhrd->bnhd", p, do)
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float, causal: bool = True,
                        window: int = -1,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """What K10 (``_flash_kernel`` without the lse) computes: K6's forward
    (``flash_attention_fwd_ref``) without the lse. With ``k_scale``/
    ``v_scale`` (B, Sk, Hkv) fp32, k/v are int8 codes, each row times its
    scale in fp32 as the kernel reads it. A row with no valid key is
    zeros."""
    k, v = _dequant(k, v, k_scale, v_scale)
    return flash_attention_fwd_ref(q, k, v, scale=scale, causal=causal,
                                   window=window)[0]
