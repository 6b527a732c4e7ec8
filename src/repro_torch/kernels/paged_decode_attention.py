"""ctypes wrapper of the K2 paged decode-attention CUDA kernel
(``csrc/paged_decode_attention.cu``), which replaces the Pallas TPU kernel
``repro.kernels.decode_attention.paged_decode_attention``, and what K2
shares with K5 (``paged_verify_attention``) and K1 (``decode_attention``):
the route, the split planner, the head checks and the split's scratch
buffers.

K1, K2 and K5 are one kernel body (``csrc/paged_decode_split.cuh``; K2 is
K5 at one query lane, K1 is K2 over a slot-major cache) with two kernels,
and ``route`` picks one by dtype and head dim: bf16 q over a bf16 or int8
cache at D = 128 runs on the tensor cores (wgmma), every other mode and
head dim (``HEAD_DIMS``) on fp32 SIMT dots. Neither stands in for
the other, a head dim outside ``HEAD_DIMS`` raises, and a launch error
raises.

Both split each slot's key range across blocks: ``plan`` gives the split
length and count from the shapes and the window alone (never from the
lengths, which would cost a device sync a layer and a grid that changes
from tick to tick). A split's partial goes to an fp32 workspace, and the last block of
a (slot, KV head, lane group) to arrive merges the splits in order, in
the same launch, through an atomic counter that it resets: one launch a
call. The counters and the workspace live in one pair of buffers per
(device, stream), so launches on one stream, which run in turn, share
them, and launches that may run beside them never do.

The wrapper checks device, dtypes, shapes, strides and alignment, allocates
the output with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch reports a CUDA error. The pools are read in place
through their strides (a layer's view of a stacked pool is fine).
``paged_decode_attention.launches`` counts launches, and
``paged_decode_attention.launches_by_kernel`` each kernel's, by the name
``route`` gives it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import (DTYPES, KV_TYPES, check_cuda,
                                        check_int32, check_kv_rows)
from repro_torch.kernels.int8_matmul import _sm_count

# every head dim of the reference's configs (full size 64, 112, 128, 168;
# smoke 8, 16, 24) and 256; the SIMT kernel masks a D that is no multiple
# of its vector width or thread groups by length, and pads nothing
HEAD_DIMS = (8, 16, 24, 64, 112, 128, 168, 256)
# the kernels' key tile (kTileK, kSpKeys), the tensor-core kernel's head
# dim and rows a block (kSpD, kSpRows: wgmma's M), the most splits the
# combine takes (kMaxSplits)
TILE_KEYS = 64
TC_HEAD_DIM = 128
TC_ROWS = 64
MAX_SPLITS = 64
# the planner's aim: this many blocks of (split, slot, KV head) an SM
SPLIT_BLOCKS_PER_SM = 2

_scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def max_rep(head_dim: int) -> int:
    """Largest GQA group the SIMT kernel takes at this head dim (its
    register and score-pass budgets: ``max_rows`` in
    ``csrc/decode_attention.cuh``): 64 rows for the score pass, and 8 rows
    a thread of the P @ V pass's 1024 // d whole groups of d / 4 threads
    (48 at D 168, 64 at D 112 and below)."""
    return min(64, 8 * (1024 // head_dim))


def check_heads(name: str, d: int, h: int, hkv: int) -> None:
    """The head dims and GQA groups of K1, K2 and K5: D in ``HEAD_DIMS``
    and at most ``max_rep(d)`` query heads a KV head. Any other head dim
    raises: no wrapper falls back to the plain version."""
    if d not in HEAD_DIMS or h % hkv or h // hkv > max_rep(d):
        raise ValueError(f"{name} kernel: head_dim {d} not in {HEAD_DIMS}, "
                         f"or GQA group {h}/{hkv} above {max_rep(d)}")


def route(q_dtype: torch.dtype, kv_dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that K1, K2 and K5 run for q of ``q_dtype`` over a cache of
    ``kv_dtype`` at ``head_dim``: "tensor_cores" (bf16 q, a bf16 or int8
    pool, D = 128) or "simt" (every other mode: fp32 q keeps its fp32
    numerics, and an fp32 pool is no bf16 operand)."""
    if (q_dtype == torch.bfloat16 and kv_dtype in (torch.bfloat16, torch.int8)
            and head_dim == TC_HEAD_DIM):
        return "tensor_cores"
    return "simt"


def split_plan(capacity: int, page_size: int, pairs: int, sms: int,
               window: int = -1) -> Tuple[int, int]:
    """(keys a split, splits of the capacity) for a table of ``capacity``
    keys a slot (n_blocks * page_size) over ``pairs`` (slot, KV head) pairs
    on ``sms`` SMs, from these shapes and the window alone. The keys one
    row can see (the window when it is shorter than the capacity) go into
    enough splits for about ``SPLIT_BLOCKS_PER_SM`` blocks an SM, at most
    ``MAX_SPLITS / 2``; a split is a whole number of 64-key tiles and of
    pages, so every split's tiles and pages start on its own boundary.
    K5's lanes do not enter: K2 and K5 split a capacity at the same keys,
    which keeps K5's lane t equal to K2 at its length. At starcoder2-7b's
    main path (2048 keys, no window, 8 slots x 4 KV heads, 132 SMs): 8
    splits of 256 keys, 256 blocks."""
    span = min(capacity, window) if window > 0 else capacity
    unit = math.lcm(TILE_KEYS, page_size)
    want = max(1, min(MAX_SPLITS // 2, -(-SPLIT_BLOCKS_PER_SM * sms
                                         // max(pairs, 1))))
    split = max(unit, -(-(-(-span // want)) // unit) * unit)
    return split, max(1, -(-capacity // split))


class Plan(NamedTuple):
    """One launch's shape: ``lanes`` query lanes a block in ``groups``
    lane groups a slot; splits of ``split`` keys, ``n_splits`` of them a
    block's rows can touch (the grid's first dimension); ``units`` (slot,
    KV head, lane group) counters and ``ws_floats`` fp32 partials (none
    with one split)."""
    lanes: int
    groups: int
    split: int
    n_splits: int
    units: int
    ws_floats: int


def plan(b: int, t: int, h: int, hkv: int, d: int, n_blocks: int,
         page_size: int, kernel: str, sms: int, window: int = -1) -> Plan:
    """The launch of ``kernel`` for q (b, t, h, d) over a table of
    ``n_blocks`` pages of ``page_size`` (K2: t = 1) under ``window``, from
    these alone. A block holds as many of the T lanes as fit its rows (64
    on the tensor cores, ``max_rep(d)`` on SIMT) at h / hkv rows a lane;
    the split comes from ``split_plan``, and a block's rows can touch the
    splits of the capacity or, under a window, of the window plus T - 1
    keys wherever it starts (at most ``MAX_SPLITS``, the combine's bound:
    a longer split past that)."""
    rep = h // hkv
    rows = TC_ROWS if kernel == "tensor_cores" else max_rep(d)
    lanes = max(1, min(t, rows // rep))
    groups = -(-t // lanes)
    capacity = n_blocks * page_size
    split, n_splits = split_plan(capacity, page_size, b * hkv, sms, window)
    if window > 0:
        span = min(capacity, window) + t - 1
        unit = math.lcm(TILE_KEYS, page_size)
        split = max(split, -(-(-(-span // (MAX_SPLITS - 1))) // unit) * unit)
        n_splits = max(1, min(-(-capacity // split), -(-span // split) + 1))
    units = b * hkv * groups
    ws_floats = units * n_splits * lanes * rep * (d + 4) if n_splits > 1 else 0
    return Plan(lanes, groups, split, n_splits, units, ws_floats)


def scratch(device: torch.device, stream: int, units: int,
            floats: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(counters, workspace) of at least ``units`` int32 counters, zero,
    and ``floats`` fp32 partials, for launches on ``stream``; grown as
    needed, so a steady tick allocates nothing."""
    key = (device.index, stream)
    counters, ws = _scratch.get(key, (None, None))
    if counters is None or counters.numel() < units:
        counters = torch.zeros(max(units, 256), dtype=torch.int32,
                               device=device)
    if ws is None or ws.numel() < floats:
        ws = torch.empty(floats, dtype=torch.float32, device=device)
    _scratch[key] = (counters, ws)
    return counters, ws


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point, built and bound on first use (every pointer and
    the stream as ``c_void_p``)."""
    fn = build.load("paged_decode_attention").paged_decode_attention_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, ll, ll, i,
                   ctypes.c_float, i, i, p, p, i, i, p, p, i, p]
    fn.restype = ctypes.c_int
    return fn


def check_paged(name: str, q: torch.Tensor, k_pool: torch.Tensor,
                v_pool: torch.Tensor, page_table: torch.Tensor,
                lengths: torch.Tensor, k_scale, v_scale) -> tuple:
    """K2's and K5's checks of q (B, [T,] H, D) and the paged inputs.
    Returns the scale pointers (None for fp pools)."""
    check_cuda(name, q, k_pool, v_pool, page_table, lengths)
    if q.dtype not in DTYPES:
        raise TypeError(f"{name} kernel takes fp32/bf16 q; got {q.dtype}")
    check_int32(name, page_table=page_table, lengths=lengths)
    shapes = (f"shapes: q {tuple(q.shape)}, pool {tuple(k_pool.shape)}, "
              f"page_table {tuple(page_table.shape)}, lengths "
              f"{tuple(lengths.shape)}")
    if k_pool.dim() != 4 or page_table.dim() != 2:
        raise ValueError(shapes)
    ks, vs = check_kv_rows(name, k_pool, v_pool, k_scale, v_scale)
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    hkv = k_pool.shape[2]
    if (k_pool.shape[3] != d or page_table.shape[0] != b
            or lengths.shape != (b,)):
        raise ValueError(shapes)
    check_heads(name, d, h, hkv)
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    return ks, vs


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, *, scale: float,
                           window: int = -1, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """q: (B, H, D) on a CUDA device; k_pool/v_pool: (P, page_size, Hkv,
    D), the last two dims contiguous, fp32/bf16, or int8 with
    k_scale/v_scale (P, page_size, Hkv) fp32; page_table: (B, NB) int32 whose
    entries below each length are pages of the pool; lengths: (B,) int32.
    Returns (B, H, D) in q's dtype."""
    name = "paged_decode_attention"
    if q.dim() != 3:
        raise ValueError(f"shapes: q {tuple(q.shape)}")
    ks, vs = check_paged(name, q, k_pool, v_pool, page_table, lengths,
                         k_scale, v_scale)
    b, h, d = q.shape
    _, ps, hkv, _ = k_pool.shape
    nb = page_table.shape[1]
    kernel = route(q.dtype, k_pool.dtype, d)
    out = torch.empty_like(q)
    if b == 0 or h == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    pl = plan(b, 1, h, hkv, d, nb, ps, kernel, _sm_count(q.device.index),
              int(window))
    counters = ws = None
    if pl.n_splits > 1:
        counters, ws = scratch(q.device, stream, pl.units, pl.ws_floats)
    launch = _launcher()
    with torch.cuda.device(q.device):
        err = launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, h,
            hkv, d, nb, ps, k_pool.stride(0), k_pool.stride(1), int(window),
            float(scale), int(q.dtype == torch.bfloat16),
            KV_TYPES[k_pool.dtype], ks, vs, pl.split, pl.n_splits,
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(),
            int(kernel == "tensor_cores"), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    paged_decode_attention.launches += 1
    paged_decode_attention.launches_by_kernel[kernel] += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.launches_by_kernel = {"tensor_cores": 0, "simt": 0}
