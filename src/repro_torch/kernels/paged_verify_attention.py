"""ctypes wrapper of the K5 paged verify-attention CUDA kernel
(``csrc/paged_verify_attention.cu``), which replaces the Pallas TPU kernel
``repro.kernels.decode_attention.paged_verify_attention``.

K5 is K2's kernel body with T query lanes a slot (``csrc/
paged_decode_split.cuh``): the same ``route`` (bf16 q over a bf16 or int8
pool at D = 128 on the tensor cores, every other mode on fp32 SIMT dots),
the same ``plan`` (so lane t and K2 at its length split the keys at the
same places) and the same per-stream scratch buffers
(``paged_decode_attention``). A block holds ``plan(...).lanes`` lanes; more
lanes take more blocks.

The wrapper checks device, dtypes, shapes, strides and alignment, allocates
the output with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch reports a CUDA error. The pools are read in place
through their strides. ``paged_verify_attention.launches`` counts launches,
and ``paged_verify_attention.launches_by_kernel`` each kernel's.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import KV_TYPES
from repro_torch.kernels.int8_matmul import _sm_count
from repro_torch.kernels.paged_decode_attention import (check_paged, plan,
                                                        route, scratch)


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point, built and bound on first use (every pointer and
    the stream as ``c_void_p``)."""
    fn = build.load("paged_verify_attention").paged_verify_attention_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, ll, ll, i,
                   ctypes.c_float, i, i, p, p, i, i, i, p, p, i, p]
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
    if q.dim() != 4:
        raise ValueError(f"shapes: q {tuple(q.shape)}")
    ks, vs = check_paged(name, q, k_pool, v_pool, page_table, lengths,
                         k_scale, v_scale)
    b, t, h, d = q.shape
    _, ps, hkv, _ = k_pool.shape
    nb = page_table.shape[1]
    kernel = route(q.dtype, k_pool.dtype, d)
    out = torch.empty_like(q)
    if b == 0 or t == 0 or h == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    pl = plan(b, t, h, hkv, d, nb, ps, kernel, _sm_count(q.device.index),
              int(window))
    counters = ws = None
    if pl.n_splits > 1:
        counters, ws = scratch(q.device, stream, pl.units, pl.ws_floats)
    launch = _launcher()
    with torch.cuda.device(q.device):
        err = launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, t,
            h, hkv, d, nb, ps, k_pool.stride(0), k_pool.stride(1),
            int(window), float(scale), int(q.dtype == torch.bfloat16),
            KV_TYPES[k_pool.dtype], ks, vs, pl.lanes, pl.split, pl.n_splits,
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(),
            int(kernel == "tensor_cores"), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    paged_verify_attention.launches += 1
    paged_verify_attention.launches_by_kernel[kernel] += 1
    return out


paged_verify_attention.launches = 0
paged_verify_attention.launches_by_kernel = {"tensor_cores": 0, "simt": 0}
