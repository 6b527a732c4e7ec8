"""ctypes wrapper of the K11 ternary weight matmul CUDA kernels
(``csrc/ternary_matmul.cu``), which replace the Pallas TPU kernel
``repro.kernels.ternary_matmul.ternary_matmul``.

The wrapper checks device, dtypes, shapes and contiguity, allocates the
output (and, where K is split, the fp32 workspace of the splits' partial
sums) with ``torch.empty``, launches on PyTorch's current stream and raises
if the launch reports a CUDA error. It pads nothing: the kernels mask
ragged M, N and K edges. Every call is one launch: split K meets in an
in-order last-block combine through ``coded_gemm.counter_buffer``.

Which kernel runs (``route``): M <= 8 "gemv", the code-streaming kernel
(fp32 FMAs; ``split_rows`` plans its K splits); larger M "tensor_cores",
the coded GEMM shared with K9 (bf16 wgmma: bf16 x as one plane, fp32 x as
three exact bf16 planes; ``coded_gemm.plan`` splits its K).
``ternary_matmul.launches`` counts launches and
``ternary_matmul.launches_by_kernel`` those of each route.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, coded_gemm
from repro_torch.kernels.checks import check_cuda

DTYPES = (torch.float32, torch.bfloat16)
# the streaming kernel's regime and shape: M <= 8 rows, 256-column tiles
GEMV_MAX_M = 8
_GEMV_BN = 256
_MAX_GEMV_SPLITS = 64


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point, built and bound on first use (every pointer and
    the stream as ``c_void_p``)."""
    fn = build.load("ternary_matmul").ternary_matmul_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 6 + [i] * 6 + [p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def route(m: int) -> str:
    """The kernel a call with M rows of x launches."""
    return "gemv" if m <= GEMV_MAX_M else "tensor_cores"


def split_rows(k: int, n: int, sms: int) -> int:
    """Rows of K per split of the streaming kernel (M <= 8): about four
    blocks per SM over the 256-column tiles, at most 64 splits and no more
    than K has 64-row parts; but splits of 256 rows at least wherever those
    still give 1.5 blocks an SM (each split's partial costs the last block
    a read: on an H100, AlexNet's fc1 at 16 splits took 11.0 us against
    12.4 at 33, while fc0 and fc2 were fastest at 33 and 64)."""
    tiles = -(-n // _GEMV_BN)
    splits = max(1, min(4 * sms // tiles, _MAX_GEMV_SPLITS, -(-k // 64)))
    long = -(-k // 256)
    if 2 * tiles * long >= 3 * sms:
        splits = min(splits, long)
    return -(-k // splits)


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
    kind = route(m)
    sms = _sm_count(x.device.index)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rows = 0
    if kind == "gemv":
        rows = split_rows(k, n, sms)
        splits = -(-k // rows)
        tiles = -(-n // _GEMV_BN)
        ws_floats = splits * m * n if splits > 1 else 0
    else:
        splits = coded_gemm.plan(m, n, k, sms)
        tiles = coded_gemm.tiles(m, n)
        ws_floats = coded_gemm.ws_floats(m, n, splits)
    ws = counters = None
    if ws_floats:
        ws = torch.empty(ws_floats, dtype=torch.float32, device=x.device)
        counters = coded_gemm.counter_buffer(x.device, stream, tiles)
    with torch.cuda.device(x.device):
        err = _launcher()(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(), m, n, k, rows,
            splits, int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    ternary_matmul.launches += 1
    ternary_matmul.launches_by_kernel[kind] += 1
    return out


ternary_matmul.launches = 0
ternary_matmul.launches_by_kernel = {"gemv": 0, "tensor_cores": 0}
