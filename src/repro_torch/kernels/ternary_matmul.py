"""ctypes wrapper of the K11 ternary weight matmul CUDA kernel
(``csrc/ternary_matmul.cu``), which replaces the Pallas TPU kernel
``repro.kernels.ternary_matmul.ternary_matmul``.

The wrapper checks device, dtypes, shapes and contiguity, allocates the
output (and, where K is split, the fp32 workspace of the splits' partial
sums) with ``torch.empty``, launches on PyTorch's current stream and raises
if the launch reports a CUDA error. It pads nothing: the kernels mask
ragged M, N and K edges. ``ternary_matmul.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import check_cuda

DTYPES = (torch.float32, torch.bfloat16)
# the source's regimes: M <= 8 streams the codes (256-column tiles), larger
# M runs 64 x 64 tiles over 16-deep K steps
GEMV_MAX_M = 8
_GEMV_BN = 256
_TILE = 64
_STEP = 16
_MAX_GEMV_SPLITS = 64
_MAX_TILE_SPLITS = 32


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point, built and bound on first use (every pointer and
    the stream as ``c_void_p``)."""
    fn = build.load("ternary_matmul").ternary_matmul_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 5 + [i] * 5 + [p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_rows(m: int, k: int, n: int, sms: int) -> int:
    """Rows of K per split. M <= 8: about four blocks per SM over the
    column tiles, at most 64 splits of at least 64 rows. Larger M: about
    two blocks per SM over the output tiles, at most 32 splits of at least
    256 rows, each a whole number of 16-row steps."""
    if m <= GEMV_MAX_M:
        tiles = -(-n // _GEMV_BN)
        splits = max(1, min(4 * sms // tiles, _MAX_GEMV_SPLITS, -(-k // 64)))
        return -(-k // splits)
    tiles = -(-n // _TILE) * -(-m // _TILE)
    splits = max(1, min(-(-2 * sms // tiles), _MAX_TILE_SPLITS,
                        -(-k // 256)))
    return -(-(-(-k // splits)) // _STEP) * _STEP


def ternary_matmul(x: torch.Tensor, q: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """x: (M, K) fp32 or bf16 on a CUDA device, contiguous; q: (K, N) int8
    codes in {-1, 0, 1}, contiguous; scale: (N,) fp32. Returns (M, N) in
    x's dtype: ``(x @ q) * scale`` with fp32 accumulation."""
    name = "ternary_matmul"
    check_cuda(name, x, q, scale)
    if x.dtype not in DTYPES or q.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes fp32/bf16 x, int8 q and fp32 "
                        f"scale; got {x.dtype}, {q.dtype}, {scale.dtype}")
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[0] \
            or scale.shape != (q.shape[1],):
        raise ValueError(f"shapes: x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"scale {tuple(scale.shape)}")
    if not (x.is_contiguous() and q.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError(f"{name} kernel: x, q and scale must be contiguous")
    m, k = x.shape
    n = q.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    rows = split_rows(m, k, n, _sm_count(x.device.index))
    splits = -(-k // rows)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=x.device) \
        if splits > 1 else None
    with torch.cuda.device(x.device):
        err = _launcher()(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), m, n, k, rows,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    ternary_matmul.launches += 1
    return out


ternary_matmul.launches = 0
