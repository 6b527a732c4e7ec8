"""ctypes wrapper of the K3 paged prefill-attention CUDA kernel
(``csrc/paged_prefill_attention.cu``), which replaces the Pallas TPU kernel
``repro.kernels.flash_attention.paged_prefill_attention``.

The wrapper checks device, dtypes, shapes, strides and alignment, allocates
the output with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch reports a CUDA error. It pads nothing: the kernel
walks the chunk in key tiles and masks by length, and reads the pools in
place. ``paged_prefill_attention.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (DTYPES, check_cuda,
                                                  check_int32, check_kv_rows)

_HEAD_DIMS = (64, 128)
# query rows a block holds (kRows in the source): T tokens x rep heads
MAX_REP = 72


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point, built and bound on first use (every pointer and
    the stream as ``c_void_p``)."""
    fn = build.load("paged_prefill_attention").paged_prefill_attention_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p] * 9 + [i] * 7 + [ll, ll, i, ctypes.c_float, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def paged_prefill_attention(q: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, page_table: torch.Tensor,
                            starts: torch.Tensor, lens: torch.Tensor, *,
                            scale: float, window: int = -1) -> torch.Tensor:
    """q: (B, C, H, D) on a CUDA device; k_new/v_new: (B, C, Hkv, D) in
    q's dtype; k_pool/v_pool: (P, page_size, Hkv, D), the last two dims
    contiguous; page_table: (B, NB) int32 whose entries below
    ceil(start / page_size) are pages of the pool; starts, lens: (B,)
    int32. Returns (B, C, H, D) in q's dtype, zero at and past each
    row's length."""
    name = "paged_prefill_attention"
    check_cuda(name, q, k_new, v_new, k_pool, v_pool, page_table, starts,
               lens)
    if q.dtype not in DTYPES or k_new.dtype != q.dtype \
            or v_new.dtype != q.dtype:
        raise TypeError(f"{name} kernel takes fp32/bf16 q with the chunk's "
                        f"K/V in q's dtype; got {q.dtype}, {k_new.dtype}, "
                        f"{v_new.dtype}")
    check_int32(name, page_table=page_table, starts=starts, lens=lens)
    if q.dim() != 4 or k_pool.dim() != 4 or page_table.dim() != 2:
        raise ValueError(f"shapes: q {tuple(q.shape)}, pool "
                         f"{tuple(k_pool.shape)}, page_table "
                         f"{tuple(page_table.shape)}")
    check_kv_rows(name, k_pool, v_pool)
    b, c, h, d = q.shape
    _, ps, hkv, _ = k_pool.shape
    nb = page_table.shape[1]
    if (k_new.shape != (b, c, hkv, d) or v_new.shape != k_new.shape
            or k_pool.shape[3] != d or page_table.shape[0] != b
            or starts.shape != (b,) or lens.shape != (b,)):
        raise ValueError(f"shapes: q {tuple(q.shape)}, k_new "
                         f"{tuple(k_new.shape)}, v_new {tuple(v_new.shape)}, "
                         f"pool {tuple(k_pool.shape)}, page_table "
                         f"{tuple(page_table.shape)}, starts "
                         f"{tuple(starts.shape)}, lens {tuple(lens.shape)}")
    if d not in _HEAD_DIMS or h % hkv or h // hkv > MAX_REP:
        raise ValueError(f"{name} kernel: head_dim {d} not in {_HEAD_DIMS}, "
                         f"or GQA group {h}/{hkv} above {MAX_REP}")
    if not (q.is_contiguous() and k_new.is_contiguous()
            and v_new.is_contiguous()):
        raise ValueError(f"{name} kernel: q, k_new and v_new must be "
                         f"contiguous")
    out = torch.empty_like(q)
    if b == 0 or c == 0 or h == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(q.device):
        err = launch(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
            starts.data_ptr(), lens.data_ptr(), out.data_ptr(), b, c, h, hkv,
            d, nb, ps, k_pool.stride(0), k_pool.stride(1), int(window),
            float(scale), int(q.dtype == torch.bfloat16),
            int(k_pool.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
