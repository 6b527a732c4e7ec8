"""ctypes wrapper of the K3 paged prefill-attention CUDA kernel
(``csrc/paged_prefill_attention.cu``), which replaces the Pallas TPU kernel
``repro.kernels.flash_attention.paged_prefill_attention``.

The source holds two kernels, and ``route`` picks one by dtype and head
dim: bf16 q over a bf16 or int8 pool at D = 112, 128 or 168 runs the
tensor-core kernel (wgmma, any GQA group; 112 and 168 on tiles of 128 and
192 columns, zero past D in shared memory), every mode with fp32 q or an
fp32 pool, and every other head dim of ``HEAD_DIMS``, the SIMT kernel
(fp32 FMAs: TF32 would change the fp32 numerics; GQA group at most
``MAX_REP``). A shape the chosen kernel cannot take raises; neither
kernel stands in for the other.

The wrapper checks device, dtypes, shapes, strides and alignment, allocates
the output with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch reports a CUDA error. It pads nothing: the kernels
walk the chunk in key tiles and mask by length, and read the pools in
place. ``paged_prefill_attention.launches`` counts launches of either,
and ``paged_prefill_attention.launches_by_kernel`` each kernel's, by the
name ``route`` gives it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import (DTYPES, KV_TYPES, check_cuda,
                                        check_int32, check_kv_rows)

# every head dim of the reference's configs: full size 64, 112, 128, 168;
# smoke 8, 16, 24 (the SIMT kernel masks the ragged ones by length)
HEAD_DIMS = (8, 16, 24, 64, 112, 128, 168)
# the SIMT kernel's query rows a block (kRows in the source): T tokens x rep
MAX_REP = 72
# the tensor-core kernel's head dims
TC_HEAD_DIMS = (112, 128, 168)


def tc_max_pages(head_dim: int) -> int:
    """Page-table entries a row the tensor-core kernel takes at
    ``head_dim`` (held in shared memory beside its tiles: tc_max_pages in
    the source): 16384, or 8192 at 168, whose tiles of 192 columns leave
    32 KiB of the block's shared memory for the table."""
    return 8192 if head_dim > 128 else 16384


def route(q_dtype: torch.dtype, kv_dtype: torch.dtype,
          head_dim: int = 128) -> str:
    """The kernel that runs for q of ``q_dtype`` over a pool of
    ``kv_dtype`` at ``head_dim``: "tensor_cores" (bf16 q, bf16 or int8
    pool, D in ``TC_HEAD_DIMS``) or "simt" (every other mode and head
    dim)."""
    if (q_dtype == torch.bfloat16 and kv_dtype in (torch.bfloat16, torch.int8)
            and head_dim in TC_HEAD_DIMS):
        return "tensor_cores"
    return "simt"


def check_heads(name: str, kernel: str, d: int, h: int, hkv: int) -> None:
    """The head dims and GQA groups ``kernel`` takes: the tensor-core
    kernel D in ``TC_HEAD_DIMS`` and any group, the SIMT kernel D in
    ``HEAD_DIMS`` and at most ``MAX_REP`` query heads a KV head. Anything
    else raises: no wrapper falls back to the plain version."""
    if h % hkv:
        raise ValueError(f"{name} kernel: H {h} must be a multiple of Hkv "
                         f"{hkv}")
    if kernel == "tensor_cores" and d not in TC_HEAD_DIMS:
        raise ValueError(f"{name} tensor-core kernel (bf16 q, bf16/int8 "
                         f"pool): head_dim {d} must be in {TC_HEAD_DIMS}")
    if kernel == "simt" and (d not in HEAD_DIMS or h // hkv > MAX_REP):
        raise ValueError(f"{name} kernel: head_dim {d} not in {HEAD_DIMS}, "
                         f"or GQA group {h}/{hkv} above {MAX_REP}")


@functools.lru_cache(maxsize=None)
def _launcher(tensor_cores: bool):
    """The C entry point of either kernel, built and bound on first use
    (every pointer and the stream as ``c_void_p``)."""
    lib = build.load("paged_prefill_attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if tensor_cores:
        fn = lib.paged_prefill_attention_tc_launch
        fn.argtypes = [p] * 9 + [i] * 7 + [ll, ll, i, ctypes.c_float, i, p,
                                           p, p]
    else:
        fn = lib.paged_prefill_attention_launch
        fn.argtypes = [p] * 9 + [i] * 7 + [ll, ll, i, ctypes.c_float, i, i,
                                           p, p, p]
    fn.restype = ctypes.c_int
    return fn


def paged_prefill_attention(q: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, page_table: torch.Tensor,
                            starts: torch.Tensor, lens: torch.Tensor, *,
                            scale: float, window: int = -1, k_scale=None,
                            v_scale=None) -> torch.Tensor:
    """q: (B, C, H, D) on a CUDA device; k_new/v_new: (B, C, Hkv, D) in
    q's dtype; k_pool/v_pool: (P, page_size, Hkv, D), the last two dims
    contiguous, fp32/bf16, or int8 with k_scale/v_scale (P, page_size,
    Hkv) fp32; page_table: (B, NB) int32 whose entries below
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
    ks, vs = check_kv_rows(name, k_pool, v_pool, k_scale, v_scale)
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
    kernel = route(q.dtype, k_pool.dtype, d)
    tensor_cores = kernel == "tensor_cores"
    check_heads(name, kernel, d, h, hkv)
    if tensor_cores and nb > tc_max_pages(d):
        raise ValueError(f"{name} tensor-core kernel: the table at most "
                         f"{tc_max_pages(d)} pages a row at head_dim {d} "
                         f"(got {nb})")
    if not (q.is_contiguous() and k_new.is_contiguous()
            and v_new.is_contiguous()):
        raise ValueError(f"{name} kernel: q, k_new and v_new must be "
                         f"contiguous")
    out = torch.empty_like(q)
    if b == 0 or c == 0 or h == 0:
        return out
    args = (q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
            starts.data_ptr(), lens.data_ptr(), out.data_ptr(), b, c, h, hkv,
            d, nb, ps, k_pool.stride(0), k_pool.stride(1), int(window),
            float(scale))
    if not tensor_cores:
        args += (int(q.dtype == torch.bfloat16),)
    with torch.cuda.device(q.device):
        err = _launcher(tensor_cores)(
            *args, KV_TYPES[k_pool.dtype], ks, vs,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    paged_prefill_attention.launches += 1
    paged_prefill_attention.launches_by_kernel[kernel] += 1
    return out


paged_prefill_attention.launches = 0
paged_prefill_attention.launches_by_kernel = {"tensor_cores": 0, "simt": 0}
