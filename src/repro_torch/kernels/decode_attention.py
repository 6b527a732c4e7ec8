"""ctypes wrapper of the K1 decode-attention CUDA kernel
(``csrc/decode_attention.cu``), which replaces the Pallas TPU kernel
``repro.kernels.decode_attention.decode_attention``.

The wrapper checks device, dtypes, shapes, strides and alignment, allocates
the output with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch reports a CUDA error. ``decode_attention.launches``
counts launches, so a run can show its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (64, 128, 256)


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point, built and bound on first use. Every pointer and
    the stream are ``c_void_p``: a bare Python int would be cut to 32 bits."""
    fn = build.load("decode_attention").decode_attention_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, i, i, i, i, ll, ll, i, ctypes.c_float, i, i,
                   p]
    fn.restype = ctypes.c_int
    return fn


def max_rep(head_dim: int) -> int:
    """Largest GQA group the kernel takes at this head dim (its register
    and score-pass budgets; see the kernel source)."""
    return min(64, 8 * (1024 // head_dim))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, scale: float,
                     window: int = -1) -> torch.Tensor:
    """q: (B, H, D) on a CUDA device; k/v: (B, Sk, Hkv, D), the last two dims
    contiguous; lengths: (B,) int32. Returns (B, H, D) in q's dtype."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device
            and lengths.device == q.device):
        raise ValueError("decode_attention kernel: all tensors must be on "
                         "the same CUDA device")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise TypeError(f"decode_attention kernel takes fp32/bf16 q and K/V "
                        f"(K and V alike); got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, h, d = q.shape
    _, sk, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or lengths.shape != (b,):
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"lengths {tuple(lengths.shape)}")
    if d not in _HEAD_DIMS or h % hkv or h // hkv > max_rep(d):
        raise ValueError(f"decode_attention kernel: head_dim {d} not in "
                         f"{_HEAD_DIMS}, or GQA group {h}/{hkv} above "
                         f"{max_rep(d)}")
    if not (q.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("q and lengths must be contiguous")
    if k.stride() != v.stride() or k.stride()[2:] != (d, 1):
        raise ValueError(f"k/v must share strides with contiguous (Hkv, D) "
                         f"dims; got {k.stride()} and {v.stride()}")
    item = k.element_size()
    if (k.data_ptr() % 16 or v.data_ptr() % 16
            or (k.stride(0) * item) % 16 or (k.stride(1) * item) % 16):
        raise ValueError("k/v rows must be 16-byte aligned")
    out = torch.empty_like(q)
    if b == 0 or h == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(q.device):
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, h, hkv, d, k.stride(0), k.stride(1),
            int(window), float(scale), int(q.dtype == torch.bfloat16),
            int(k.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
