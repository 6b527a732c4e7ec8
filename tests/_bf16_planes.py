"""The bf16 tensor-core numerics of the flash kernels, in torch, for their
CPU emulations (``test_torch_flash_bf16_tc.py``: K7 and K8;
``test_torch_flash_fwd_bf16_tc.py``: K6 and K10 with bf16 q).

A product of two bf16 operands runs as bf16 ``wgmma`` k16 steps, each
step's products exact in fp32 and summed in fp32 (``dots16``). A product
with an fp32 operand (P, dS) against a bf16 one takes the fp32 values in
three exact bf16 planes split on the bit pattern, as
``hopper::bf16x3_split`` does (``bf16x3``, ``planes3``); ``planes1``
rounds them to one bf16 plane instead, as bf16 SDPA does.
"""

import torch

K_STEP = 16                         # bf16 wgmma's depth


def bf16x3(x):
    """fp32 x as three bf16 values on its bit pattern, as
    ``hopper::bf16x3_split`` (finite x): hi keeps x's top 16 bits, r = x -
    hi is exact, mid keeps r's top 16 bits, lo = r - mid (exact, at most 8
    significant bits)."""
    def top(y):
        return (y.contiguous().view(torch.int32) & -0x10000).view(
            torch.float32)
    hi = top(x)
    r = x - hi
    mid = top(r)
    return hi, mid, r - mid


def planes3(x, b):
    """x @ b with fp32 x in three bf16 planes against bf16-exact b: the
    small terms first, each product of bf16 values (exact in fp32)."""
    hi, mid, lo = bf16x3(x)
    return lo @ b + mid @ b + hi @ b


def planes1(x, b):
    """x @ b with x rounded to one bf16 plane (to nearest): what rounding
    P and dS to bf16, as bf16 SDPA does, gives."""
    return x.to(torch.bfloat16).float() @ b


def dots16(a, b):
    """a @ b^T over the last dim in 16-deep steps (bf16 ``wgmma`` k16),
    each step's exact products summed in fp32, the steps in order."""
    s = torch.zeros(a.shape[:-1] + (b.shape[-2],))
    for c in range(0, a.shape[-1], K_STEP):
        s = s + a[..., c:c + K_STEP] @ b[..., c:c + K_STEP].transpose(-1, -2)
    return s
