"""ctypes wrappers of the K4 int8 weight matmul CUDA kernel and of K9, its
backward with respect to x (``csrc/int8_matmul.cu``), which replace the
Pallas TPU kernels ``repro.kernels.int8_matmul.int8_matmul`` and
``int8_matmul_dx``.

Each wrapper checks device, dtypes, shapes, contiguity and alignment,
allocates the output (and, for split tiles, their fp32 workspace)
with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch reports a CUDA error. It pads nothing: the kernels
mask ragged edges. ``int8_matmul.launches`` and ``int8_matmul_dx.launches``
count launches, and ``launches_by_kernel`` on each the launches of each
kernel: K4's by the name ``regime`` gives it, K9's "tensor_cores" (its one
kernel, the coded GEMM of ``coded_gemm``).

Which kernel runs (``regime``): bf16 x with M <= 8 the decode kernel
(tensor cores, mma.sync, the weight streamed to registers; ``decode_plan``
gives its bands), bf16 x with M > 8 the wgmma kernel with a TMA
ring (tensor cores; N % 16 == 0, else the wrapper raises), fp32 x the SIMT
kernel (fp32 FMAs, any M). ``wgmma_plan`` picks the wgmma kernel's rows of
x a block and its K splits.

K9 runs the coded GEMM for any shape: the codes widened exactly to bf16,
the fp32 cotangent (times the scale) split into three bf16 planes, three
products on bf16 wgmma; ``coded_gemm.plan`` splits its contraction where
the dx tiles alone would leave SMs idle.

The tiles that the tensor-core kernels split across blocks meet through
one counter per output tile (``coded_gemm.counter_buffer``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build, coded_gemm
from repro_torch.kernels.checks import check_cuda

DTYPES = (torch.float32, torch.bfloat16)
# the decode kernel's shape (kMaxM, kDecBN, kDecRound, kDecOut,
# kDecBlocksPerSm): M <= 8 rows of x, 128 output columns a tile, 128 k rows
# a round (a 16-row step for each of a block's 8 warps), 8 x 128 fp32 a
# partial, and the blocks an SM that its launch bounds keep resident
GEMV_MAX_M = 8
DECODE_BN = 128
DECODE_ROUND = 128
DECODE_PARTIAL = GEMV_MAX_M * DECODE_BN
DECODE_BLOCKS_PER_SM = 2
# the planner's floor: rounds a band (below it a tile's many partials cost
# more than its blocks save)
DECODE_MIN_ROUNDS = 4
# the wgmma kernel's limits (kTcBN, kTcBK, kTcMaxSplits): 128 output
# columns and 64 k rows a tile, at most 64 K splits; and the planner's
# rules: a K split at least 8 k tiles long, and a 192-row tile costing
# 1.12x a 256-row one's time a row (both tuned on an H100: see wgmma_plan)
TC_BN = 128
TC_BK = 64
TC_MAX_SPLITS = 64
TC_MIN_SPLIT_TILES = 8
TC_ROW_COST = {192: 1.12, 256: 1.0}


@functools.lru_cache(maxsize=None)
def _launcher(name: str = "int8_matmul_launch"):
    """The C entry point ``name``, built and bound on first use (every
    pointer and the stream as ``c_void_p``)."""
    fn = getattr(build.load("int8_matmul"), name)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ({"int8_matmul_launch": [p] * 6 + [i] * 8,
                    "int8_matmul_dx_launch": [p] * 6 + [i] * 5}[name] + [p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class DecodePlan(NamedTuple):
    """The decode kernel's launch for a (k, n) weight: ``tiles`` 128-column
    tiles of ``rounds`` 128-row rounds each (the last may be short), each
    tile's rounds in ``bands`` equal bands, one block a (tile, band):
    ``blocks`` = tiles x bands, block b on tile b % tiles and band b //
    tiles (``decode_band``), its partial (with more than one band) in
    workspace slot b of ``ws_floats`` floats."""
    tiles: int
    rounds: int
    bands: int
    blocks: int
    ws_floats: int


def decode_plan(k: int, n: int, sms: int) -> DecodePlan:
    """The most bands that divide a tile's rounds evenly with every block
    resident at once (``DECODE_BLOCKS_PER_SM`` an SM), at least one: every
    block streams the same bytes, and the blocks of a band walk down the
    same k rows of adjacent tiles together."""
    tiles, rounds = -(-n // DECODE_BN), -(-k // DECODE_ROUND)
    room = DECODE_BLOCKS_PER_SM * sms // tiles
    bands = max([d for d in range(1, rounds + 1) if rounds % d == 0
                 and d <= room and rounds // d >= DECODE_MIN_ROUNDS] or [1])
    blocks = tiles * bands
    return DecodePlan(tiles, rounds, bands, blocks,
                      blocks * DECODE_PARTIAL if bands > 1 else 0)


def decode_band(plan: DecodePlan, b: int) -> Tuple[int, int, int]:
    """(tile, first round, end round) of block b, as the kernel takes them
    (round r of a tile: k rows from 128 r)."""
    band = b // plan.tiles
    return (b % plan.tiles, band * plan.rounds // plan.bands,
            (band + 1) * plan.rounds // plan.bands)


def regime(m: int, x_dtype: torch.dtype) -> str:
    """Which kernel ``int8_matmul`` launches for M rows of ``x_dtype``:
    "decode" (bf16, M <= 8), "wgmma" (bf16, M > 8) or "simt" (fp32)."""
    if x_dtype == torch.float32:
        return "simt"
    return "decode" if m <= GEMV_MAX_M else "wgmma"


def wgmma_plan(m: int, n: int, k: int, sms: int) -> Tuple[int, int]:
    """(rows of x a block, K splits) of the wgmma kernel for an (m, k) x
    and a (k, n) weight on ``sms`` SMs (one block an SM at a time). A block
    takes 128 output columns and 64, 128 or 192 rows of x, the fewest that
    hold M (wgmma's N: rows past M are zero work that still costs); past
    192 rows, 192 or 256, whichever takes the fewer rounds of blocks times
    rows a block (a 192-row tile at 1.12x the cost a row: M = 2048 at N =
    4608 is 396 tiles of 192, three full rounds, against 288 of 256 in
    three rounds, the last short). When the tiles number fewer than the
    SMs, K is split so that the grid covers them, each split at least 8
    k tiles (512 rows) long and at most 64 splits: the last block of a tile
    adds every split's partial tile, so short splits cost more in that sum
    than they save. Raises on shapes the kernel's TMA
    descriptors cannot take: N % 16 != 0 (the weight's rows must lie 16
    bytes apart) or K % 16 != 0."""
    if n % 16 or k % 16:
        raise ValueError(f"int8_matmul kernel (bf16 x, M > {GEMV_MAX_M}) "
                         f"needs N % 16 == 0 and K % 16 == 0 for its TMA "
                         f"descriptors; got N = {n}, K = {k}")
    if m <= GEMV_MAX_M:
        raise ValueError(f"the wgmma kernel takes M > {GEMV_MAX_M}; got {m}")
    n_tiles = -(-n // TC_BN)
    if m <= 192:
        tile_m = 64 if m <= 64 else 128 if m <= 128 else 192
    else:
        def cost(rows):
            return (-(-n_tiles * -(-m // rows) // sms) * rows
                    * TC_ROW_COST[rows])
        tile_m = min((256, 192), key=cost)
    tiles = n_tiles * -(-m // tile_m)
    k_tiles = -(-k // TC_BK)
    if tiles >= sms:
        return tile_m, 1
    return tile_m, max(1, min(-(-sms // tiles), k_tiles // TC_MIN_SPLIT_TILES,
                              TC_MAX_SPLITS))


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: (M, K) fp32 or bf16 on a CUDA device, contiguous; q: (K, N) int8
    contiguous; scale: (N,) fp32. K % 16 == 0, x and q 16-byte aligned; for
    bf16 x with M > 8 also N % 16 == 0. Returns (M, N) in ``out_dtype``:
    x's dtype (the default) or fp32. ``(x @ q) * scale`` with fp32
    accumulation."""
    name = "int8_matmul"
    check_cuda(name, x, q, scale)
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"{name} kernel writes x's dtype or fp32; got "
                        f"{out_dtype} for {x.dtype} x")
    if x.dtype not in DTYPES or q.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes fp32/bf16 x, int8 q and fp32 "
                        f"scale; got {x.dtype}, {q.dtype}, {scale.dtype}")
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[0] \
            or scale.shape != (q.shape[1],):
        raise ValueError(f"shapes: x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"scale {tuple(scale.shape)}")
    m, k = x.shape
    n = q.shape[1]
    if k % 16:
        raise ValueError(f"{name} kernel needs K % 16 == 0; got K = {k}")
    if not (x.is_contiguous() and q.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError(f"{name} kernel: x, q and scale must be contiguous")
    if x.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError(f"{name} kernel: x and q must be 16-byte aligned")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    kind = regime(m, x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    blocks = tile_m = 0
    splits, tiles, ws_floats = 1, 0, 0
    if kind == "decode":
        pl = decode_plan(k, n, _sm_count(x.device.index))
        blocks, tiles, ws_floats = pl.blocks, pl.tiles, pl.ws_floats
    elif kind == "wgmma":
        tile_m, splits = wgmma_plan(m, n, k, _sm_count(x.device.index))
        tiles = -(-n // TC_BN) * -(-m // tile_m)
        ws_floats = splits * m * n if splits > 1 else 0
    ws = counters = None
    if ws_floats:
        ws = torch.empty(ws_floats, dtype=torch.float32, device=x.device)
        counters = coded_gemm.counter_buffer(x.device, stream, tiles)
    launch = _launcher()
    with torch.cuda.device(x.device):
        err = launch(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(), m, n, k, blocks,
            splits, tile_m, int(kind != "simt"),
            int(out_dtype == torch.float32), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    int8_matmul.launches += 1
    int8_matmul.launches_by_kernel[kind] += 1
    return out


int8_matmul.launches = 0
int8_matmul.launches_by_kernel = {"decode": 0, "wgmma": 0, "simt": 0}


def int8_matmul_dx(dy: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """K9. dy: (M, N) fp32 on a CUDA device; q: (K, N) int8; scale: (N,)
    fp32; all contiguous. Returns dx (M, K) in ``out_dtype`` (fp32 or
    bf16, x's dtype): ``(dy * scale) @ q^T`` with fp32 accumulation."""
    name = "int8_matmul_dx"
    check_cuda(name, dy, q, scale)
    if dy.dtype != torch.float32 or q.dtype != torch.int8 \
            or scale.dtype != torch.float32 or out_dtype not in DTYPES:
        raise TypeError(f"{name} kernel takes fp32 dy, int8 q and fp32 "
                        f"scale and writes fp32 or bf16; got {dy.dtype}, "
                        f"{q.dtype}, {scale.dtype} -> {out_dtype}")
    if dy.dim() != 2 or q.dim() != 2 or dy.shape[1] != q.shape[1] \
            or scale.shape != (q.shape[1],):
        raise ValueError(f"shapes: dy {tuple(dy.shape)}, q {tuple(q.shape)}, "
                         f"scale {tuple(scale.shape)}")
    if not (dy.is_contiguous() and q.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError(f"{name} kernel: dy, q and scale must be "
                         f"contiguous")
    m, n = dy.shape
    k = q.shape[0]
    dx = torch.empty((m, k), dtype=out_dtype, device=dy.device)
    if m == 0 or k == 0:
        return dx
    if n == 0:
        return dx.zero_()
    stream = torch.cuda.current_stream(dy.device).cuda_stream
    # dx's K columns are the coded GEMM's outputs, N its contraction
    splits = coded_gemm.plan(m, k, n, _sm_count(dy.device.index))
    ws = counters = None
    if splits > 1:
        ws = torch.empty(coded_gemm.ws_floats(m, k, splits),
                         dtype=torch.float32, device=dy.device)
        counters = coded_gemm.counter_buffer(dy.device, stream,
                                             coded_gemm.tiles(m, k))
    with torch.cuda.device(dy.device):
        err = _launcher("int8_matmul_dx_launch")(
            dy.data_ptr(), q.data_ptr(), scale.data_ptr(), dx.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(), m, n, k,
            splits, int(out_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    int8_matmul_dx.launches += 1
    int8_matmul_dx.launches_by_kernel["tensor_cores"] += 1
    return dx


int8_matmul_dx.launches = 0
int8_matmul_dx.launches_by_kernel = {"tensor_cores": 0}
