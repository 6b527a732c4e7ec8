"""ctypes wrapper of the K1 decode-attention CUDA kernel
(``csrc/decode_attention.cu``), which replaces the Pallas TPU kernel
``repro.kernels.decode_attention.decode_attention``, in its fp32, bf16 and
int8-KV (codes plus fp32 row scales) modes.

The wrapper checks device, dtypes, shapes, strides and alignment, allocates
the output with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch reports a CUDA error. ``decode_attention.launches``
counts launches, so a run can show its main path went through the kernel.
The checks shared with the paged kernels (K2, K3) live here too.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)
# K/V storage: the source's KvType codes (int8: codes plus fp32 row scales)
KV_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (64, 128, 256)


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point, built and bound on first use. Every pointer and
    the stream are ``c_void_p``: a bare Python int would be cut to 32 bits."""
    fn = build.load("decode_attention").decode_attention_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ll, ll, i, ctypes.c_float, i,
                   i, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def max_rep(head_dim: int) -> int:
    """Largest GQA group the kernel takes at this head dim (its register
    and score-pass budgets; see the kernel source)."""
    return min(64, 8 * (1024 // head_dim))


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor on the first one's CUDA device: the kernels never fall
    back to another device."""
    dev = tensors[0].device
    if not (tensors[0].is_cuda and all(t.device == dev for t in tensors)):
        raise ValueError(f"{name} kernel: all tensors must be on the same "
                         f"CUDA device")


def check_int32(name: str, **tensors: torch.Tensor) -> None:
    for arg, t in tensors.items():
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name} kernel: {arg} must be contiguous int32, "
                            f"got {t.dtype}")


def check_kv_rows(name: str, k: torch.Tensor, v: torch.Tensor,
                  k_scale=None, v_scale=None) -> tuple:
    """K and V (..., Hkv, D) alike: one dtype, shared strides, contiguous
    (Hkv, D) rows, and every row on a 16-byte boundary (the kernels' vector
    loads). int8 K/V come with fp32 scales (..., Hkv) whose strides are
    K/V's over D, so a row's scale sits at its element offset / D. Returns
    the (k_scale, v_scale) pointers to pass (None for fp K/V)."""
    if k.dtype not in KV_TYPES or v.dtype != k.dtype or v.shape != k.shape:
        raise TypeError(f"{name} kernel takes fp32/bf16/int8 K/V alike; got "
                        f"{k.dtype} {tuple(k.shape)}, {v.dtype} "
                        f"{tuple(v.shape)}")
    if (k_scale is not None) != (k.dtype == torch.int8) \
            or (k_scale is None) != (v_scale is None):
        raise TypeError(f"{name} kernel: int8 K/V take k_scale and v_scale, "
                        f"fp K/V neither")
    d = k.shape[-1]
    if k.stride() != v.stride() or k.stride()[-2:] != (d, 1):
        raise ValueError(f"{name} kernel: k/v must share strides with "
                         f"contiguous (Hkv, D) dims; got {k.stride()} and "
                         f"{v.stride()}")
    item = k.element_size()
    if (k.data_ptr() % 16 or v.data_ptr() % 16
            or any((s * item) % 16 for s in k.stride()[:-2])):
        raise ValueError(f"{name} kernel: k/v rows must be 16-byte aligned")
    if k_scale is None:
        return None, None
    want = tuple(s // d for s in k.stride()[:-1])
    for sc in (k_scale, v_scale):
        if (any(s % d for s in k.stride()[:-1])
                or sc.dtype != torch.float32 or sc.shape != k.shape[:-1]
                or sc.stride() != want or sc.device != k.device):
            raise ValueError(f"{name} kernel: KV scales must be fp32 "
                             f"{tuple(k.shape[:-1])} with strides {want} "
                             f"on {k.device}; got {sc.dtype} "
                             f"{tuple(sc.shape)} {sc.stride()}")
    return k_scale.data_ptr(), v_scale.data_ptr()


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, scale: float,
                     window: int = -1, k_scale=None,
                     v_scale=None) -> torch.Tensor:
    """q: (B, H, D) on a CUDA device; k/v: (B, Sk, Hkv, D), the last two dims
    contiguous, fp32/bf16, or int8 with k_scale/v_scale (B, Sk, Hkv) fp32;
    lengths: (B,) int32. Returns (B, H, D) in q's dtype."""
    check_cuda("decode_attention", q, k, v, lengths)
    if q.dtype not in DTYPES:
        raise TypeError(f"decode_attention kernel takes fp32/bf16 q; got "
                        f"{q.dtype}")
    check_int32("decode_attention", lengths=lengths)
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}")
    ks, vs = check_kv_rows("decode_attention", k, v, k_scale, v_scale)
    b, h, d = q.shape
    _, sk, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or lengths.shape != (b,):
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"lengths {tuple(lengths.shape)}")
    if d not in _HEAD_DIMS or h % hkv or h // hkv > max_rep(d):
        raise ValueError(f"decode_attention kernel: head_dim {d} not in "
                         f"{_HEAD_DIMS}, or GQA group {h}/{hkv} above "
                         f"{max_rep(d)}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    out = torch.empty_like(q)
    if b == 0 or h == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(q.device):
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, h, hkv, d, sk, k.stride(0), k.stride(1),
            int(window), float(scale), int(q.dtype == torch.bfloat16),
            KV_TYPES[k.dtype], ks, vs,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
