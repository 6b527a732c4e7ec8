"""The argument checks that the kernel wrappers share: device, dtypes,
int32 index tensors, and the K/V row layout (with int8 scales) that the
attention kernels read in place. Each raises on what its kernels do not
take; none falls back to another device."""

from __future__ import annotations

import math

import torch

DTYPES = (torch.float32, torch.bfloat16)
# K/V storage: the CUDA sources' KvType codes (int8: codes plus fp32 row
# scales)
KV_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


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
    (Hkv, D) rows, and every row on a 16-byte boundary, or an 8-byte one
    where D bytes are no multiple of 16 (the kernels' vector loads). int8 K/V come with fp32 scales (..., Hkv) whose strides are
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
    # the kernels' vector loads: 16 bytes, or 8 where a row of int8 codes
    # is no multiple of 16 (D = 8, 24, 168)
    align = math.gcd(16, d * item)
    if (k.data_ptr() % align or v.data_ptr() % align
            or any((s * item) % align for s in k.stride()[:-2])):
        raise ValueError(f"{name} kernel: k/v rows must be {align}-byte "
                         f"aligned")
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
