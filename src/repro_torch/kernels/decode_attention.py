"""ctypes wrapper of the K1 decode-attention CUDA kernel
(``csrc/decode_attention.cu``), which replaces the Pallas TPU kernel
``repro.kernels.decode_attention.decode_attention``, in its fp32, bf16 and
int8-KV (codes plus fp32 row scales) modes.

K1 runs K2's split body (``csrc/paged_decode_split.cuh``) over the
slot-major cache, read in place through its strides, so it takes K2's
rules: ``route`` (``paged_decode_attention.route``) picks the kernel
(bf16 q over a bf16 or int8 cache at D = 128 on the tensor cores, every
other mode on fp32 SIMT dots), ``plan`` is K2's planner at page size 1
(splits of whole 64-key tiles, from the shapes and the window alone), and
the workspace and counters come from K2's per-stream ``scratch``. A launch
error raises; neither kernel stands in for the other.

The wrapper checks device, dtypes, shapes, strides and alignment, allocates
the output with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch reports a CUDA error. ``decode_attention.launches``
counts launches, and ``decode_attention.launches_by_kernel`` each kernel's,
by the name ``route`` gives it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import paged_decode_attention as k2
from repro_torch.kernels.checks import (DTYPES, KV_TYPES, check_cuda,
                                        check_int32, check_kv_rows)
from repro_torch.kernels.int8_matmul import _sm_count


# K1 runs K2's body, so it takes K2's rule for the kernel a mode runs
route = k2.route


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point, built and bound on first use. Every pointer and
    the stream are ``c_void_p``: a bare Python int would be cut to 32 bits."""
    fn = build.load("decode_attention").decode_attention_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ll, ll, i, ctypes.c_float, i,
                   i, p, p, i, i, p, p, i, p]
    fn.restype = ctypes.c_int
    return fn


def plan(b: int, h: int, hkv: int, d: int, sk: int, kernel: str, sms: int,
         window: int = -1) -> k2.Plan:
    """The launch of ``kernel`` for q (b, h, d) over a cache of ``sk`` keys
    a slot under ``window``, from these alone: K2's plan at page size 1,
    whose unit is then the 64-key tile (8 splits of 256 keys at
    starcoder2-7b's main path: 256 blocks)."""
    return k2.plan(b, 1, h, hkv, d, sk, 1, kernel, sms, window)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, scale: float,
                     window: int = -1, k_scale=None,
                     v_scale=None) -> torch.Tensor:
    """q: (B, H, D) on a CUDA device; k/v: (B, Sk, Hkv, D), the last two dims
    contiguous, fp32/bf16, or int8 with k_scale/v_scale (B, Sk, Hkv) fp32;
    lengths: (B,) int32. Returns (B, H, D) in q's dtype."""
    name = "decode_attention"
    check_cuda(name, q, k, v, lengths)
    if q.dtype not in DTYPES:
        raise TypeError(f"{name} kernel takes fp32/bf16 q; got {q.dtype}")
    check_int32(name, lengths=lengths)
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}")
    ks, vs = check_kv_rows(name, k, v, k_scale, v_scale)
    b, h, d = q.shape
    _, sk, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or lengths.shape != (b,):
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"lengths {tuple(lengths.shape)}")
    k2.check_heads(name, d, h, hkv)
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    kernel = route(q.dtype, k.dtype, d)
    out = torch.empty_like(q)
    if b == 0 or h == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    pl = plan(b, h, hkv, d, sk, kernel, _sm_count(q.device.index),
              int(window))
    counters = ws = None
    if pl.n_splits > 1:
        counters, ws = k2.scratch(q.device, stream, pl.units, pl.ws_floats)
    launch = _launcher()
    with torch.cuda.device(q.device):
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, h, hkv, d, sk, k.stride(0), k.stride(1),
            int(window), float(scale), int(q.dtype == torch.bfloat16),
            KV_TYPES[k.dtype], ks, vs, pl.split, pl.n_splits,
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(),
            int(kernel == "tensor_cores"), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    decode_attention.launches += 1
    decode_attention.launches_by_kernel[kernel] += 1
    return out


decode_attention.launches = 0
decode_attention.launches_by_kernel = {"tensor_cores": 0, "simt": 0}
