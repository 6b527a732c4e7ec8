"""Public kernel entry points of the port (mirror of ``repro.kernels.ops``).

Dispatch goes by the tensors' device, never by what the machine has: CPU
tensors take the plain PyTorch version (``ref``), CUDA tensors take the
hand-written kernel, which runs or raises. There is no fallback from one to
the other and no switch that turns a kernel off on the card. Unlike the
JAX wrappers, these pad nothing: the kernels mask by length, and padding
would copy the cache or the chunk on every call of every layer.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import paged_decode_attention as _pda
from repro_torch.kernels import paged_prefill_attention as _ppa
from repro_torch.kernels import ref as _ref


def _no_int8_kv(name: str, k_scale, v_scale) -> None:
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(f"{name}: the int8-KV mode is not ported "
                                  f"yet (ROADMAP queue 1, item 4)")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, scale: Optional[float] = None,
                     window: int = -1) -> torch.Tensor:
    """Serve-core decode attention with per-slot lengths (K1).

    q: (B, H, D) — the one new token per slot; k/v: (B, Sk, Hkv, D)
    slot-major KV cache; lengths: (B,) int32 valid prefix per slot (0 = dead
    slot -> zeros).
    """
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return _ref.decode_attention_ref(q, k, v, lengths, scale=scale,
                                         window=window)
    if q.device.type == "cuda":
        return _da.decode_attention(q, k, v, lengths, scale=scale,
                                    window=window)
    raise ValueError(f"decode_attention: no kernel for device {q.device}")


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, *,
                           scale: Optional[float] = None, window: int = -1,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Serve-core decode attention through a paged KV pool (K2).

    q: (B, H, D) — the one new token per slot; k_pool/v_pool:
    (P, page_size, Hkv, D) the shared block pool; page_table: (B, NB) int32
    (entries past a slot's length point at the sink page); lengths: (B,)
    int32 valid logical prefix per slot (0 = dead slot -> zeros).
    """
    _no_int8_kv("paged_decode_attention", k_scale, v_scale)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return _ref.paged_decode_attention_ref(q, k_pool, v_pool, page_table,
                                               lengths, scale=scale,
                                               window=window)
    if q.device.type == "cuda":
        return _pda.paged_decode_attention(q, k_pool, v_pool, page_table,
                                           lengths, scale=scale,
                                           window=window)
    raise ValueError(f"paged_decode_attention: no kernel for device "
                     f"{q.device}")


def paged_prefill_attention(q: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, page_table: torch.Tensor,
                            starts: torch.Tensor, lens: torch.Tensor, *,
                            scale: Optional[float] = None, window: int = -1,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Chunk-prefill attention through a paged KV pool (K3).

    q: (B, C, H, D) chunk queries; k_new/v_new: (B, C, Hkv, D) the chunk's
    K/V in q's dtype (what the in-chunk attention sees — dense-prefill
    numerics); k_pool/v_pool: (P, page_size, Hkv, D) the pool holding the
    cached prefix [0, starts[b]) (read in storage dtype — decode
    numerics); page_table: (B, NB) int32; starts/lens: (B,) int32
    cached-prefix length and valid chunk tokens per row (lens 0 = dead
    row). Rows at or past ``lens`` come back as zeros.
    """
    _no_int8_kv("paged_prefill_attention", k_scale, v_scale)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return _ref.paged_prefill_attention_ref(
            q, k_new, v_new, k_pool, v_pool, page_table, starts, lens,
            scale=scale, window=window)
    if q.device.type == "cuda":
        return _ppa.paged_prefill_attention(
            q, k_new, v_new, k_pool, v_pool, page_table, starts, lens,
            scale=scale, window=window)
    raise ValueError(f"paged_prefill_attention: no kernel for device "
                     f"{q.device}")
