"""ctypes wrapper of the K5 paged verify-attention CUDA kernel
(``csrc/paged_verify_attention.cu``), which replaces the Pallas TPU kernel
``repro.kernels.decode_attention.paged_verify_attention``.

The wrapper checks device, dtypes, shapes, strides and alignment, allocates
the output with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch reports a CUDA error. The pools are read in place
through their strides. ``paged_verify_attention.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (DTYPES, KV_TYPES,
                                                  check_cuda, check_int32,
                                                  check_kv_rows, max_rep)

_HEAD_DIMS = (64, 128, 256)


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point, built and bound on first use (every pointer and
    the stream as ``c_void_p``)."""
    fn = build.load("paged_verify_attention").paged_verify_attention_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, ll, ll, i,
                   ctypes.c_float, i, i, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def paged_verify_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, *, scale: float,
                           window: int = -1, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """q: (B, T, H, D) on a CUDA device; k_pool/v_pool: (P, page_size, Hkv,
    D), the last two dims contiguous, fp32/bf16, or int8 with
    k_scale/v_scale (P, page_size, Hkv) fp32; page_table: (B, NB) int32
    whose entries below each length are pages of the pool; lengths: (B,)
    int32 counting the T lanes. Returns (B, T, H, D) in q's dtype."""
    name = "paged_verify_attention"
    check_cuda(name, q, k_pool, v_pool, page_table, lengths)
    if q.dtype not in DTYPES:
        raise TypeError(f"{name} kernel takes fp32/bf16 q; got {q.dtype}")
    check_int32(name, page_table=page_table, lengths=lengths)
    if q.dim() != 4 or k_pool.dim() != 4 or page_table.dim() != 2:
        raise ValueError(f"shapes: q {tuple(q.shape)}, pool "
                         f"{tuple(k_pool.shape)}, page_table "
                         f"{tuple(page_table.shape)}")
    ks, vs = check_kv_rows(name, k_pool, v_pool, k_scale, v_scale)
    b, t, h, d = q.shape
    _, ps, hkv, _ = k_pool.shape
    nb = page_table.shape[1]
    if (k_pool.shape[3] != d or page_table.shape[0] != b
            or lengths.shape != (b,)):
        raise ValueError(f"shapes: q {tuple(q.shape)}, pool "
                         f"{tuple(k_pool.shape)}, page_table "
                         f"{tuple(page_table.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    if d not in _HEAD_DIMS or h % hkv or h // hkv > max_rep(d):
        raise ValueError(f"{name} kernel: head_dim {d} not in {_HEAD_DIMS}, "
                         f"or GQA group {h}/{hkv} above {max_rep(d)}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    out = torch.empty_like(q)
    if b == 0 or t == 0 or h == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(q.device):
        err = launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, t,
            h, hkv, d, nb, ps, k_pool.stride(0), k_pool.stride(1),
            int(window), float(scale), int(q.dtype == torch.bfloat16),
            KV_TYPES[k_pool.dtype], ks, vs,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    paged_verify_attention.launches += 1
    return out


paged_verify_attention.launches = 0
