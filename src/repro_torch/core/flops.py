"""Analytic FLOPs / HBM-traffic accounting by walking the aten ops a call
runs (the counterpart of ``repro.core.flops``, which walks a jaxpr).

``cost_of_fn(fn, *args, n_devices=)`` runs ``fn`` under a
``TorchDispatchMode`` that sees every aten op, on whatever tensors it is
given: meta tensors (the dry-run's shapes, nothing allocated or computed)
or real ones. Eager torch has no scan: a layer loop is counted as it
runs, every layer, so nothing needs a trip count. The port keeps every
layer's activations for the backward (it has no ``remat``), so a training
step's FLOPs lack the recompute the reference counts under
``remat="full"``.

What is billed, as in the reference:

* dots (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``, ``dot``: what
  ``matmul``, ``einsum`` and ``linear`` decompose to) at 2 M N K FLOPs,
  under ``by_prim["dot_general"]``, with their operands and output as
  traffic;
* convolutions at 2 FLOPs per output element and kernel tap
  (``conv_general_dilated``), their backward at the same count for each
  gradient it makes;
* the ops that force a round trip through memory (the reference's
  ``_MATERIALIZING`` classes: gathers and scatters, sorts and top-k,
  reductions, cumulative sums) at one FLOP per input element and their
  operands and outputs as traffic;
* elementwise ops as fused into their consumers: nothing.

The port's kernels run outside aten (through ctypes), so each entry of
``kernels.ops`` reports its own FLOPs and bytes under its name through
``kernel(name, cost)`` while a counter is active, and the aten ops of its
plain version or of its meta branch are not counted beside them. Those
counts are the ``*_work`` functions below, which ``chip_smoke.py``'s
bounds read too; a bill sums a kernel's FLOPs, 2 per multiply-add,
whatever rate each group runs at. Without an active counter ``kernel``
costs one list check. Collective bytes are not counted here.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_aten = torch.ops.aten

_DOTS = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm, _aten.mv,
         _aten.addmv, _aten.dot}

# (aten op, the reference primitive it stands for): ops billed as memory
# materialization points (read inputs, write outputs)
_MATERIALIZING = {
    _aten.embedding: "gather", _aten.index: "gather",
    _aten.index_select: "gather", _aten.gather: "gather",
    _aten.embedding_dense_backward: "scatter-add",
    _aten.scatter: "scatter", _aten.scatter_: "scatter",
    _aten.scatter_add: "scatter-add", _aten.scatter_add_: "scatter-add",
    _aten.index_add: "scatter-add", _aten.index_add_: "scatter-add",
    _aten.index_put: "scatter", _aten.index_put_: "scatter",
    _aten._index_put_impl_: "scatter",
    _aten.sort: "sort", _aten.topk: "top_k",
    _aten.sum: "reduce_sum", _aten.mean: "reduce_sum",
    _aten.amax: "reduce_max", _aten.max: "reduce_max",
    _aten.amin: "reduce_min", _aten.min: "reduce_min",
    _aten.prod: "reduce_prod", _aten.all: "reduce_and",
    _aten.any: "reduce_or", _aten.argmax: "argmax", _aten.argmin: "argmin",
    _aten.cumsum: "cumsum", _aten.logsumexp: "cumlogsumexp",
    _aten._softmax: "reduce_max", _aten._log_softmax: "reduce_max",
}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    traffic_bytes: float = 0.0
    by_prim: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, prim: str, flops: float, traffic: float,
            mult: float = 1.0) -> None:
        self.flops += flops * mult
        self.traffic_bytes += traffic * mult
        if flops:
            self.by_prim[prim] = self.by_prim.get(prim, 0.0) + flops * mult

    def scaled(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.traffic_bytes * k,
                    {p: v * k for p, v in self.by_prim.items()})


def _tensors(xs) -> List[torch.Tensor]:
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out += _tensors(x)
    return out


def _nbytes(ts) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts))


def _dot_flops(func, args) -> float:
    if func in (_aten.addmm, _aten.baddbmm, _aten.addmv):
        args = args[1:]
    a, b = args[0], args[1]
    if func is _aten.dot:
        return 2.0 * a.numel()
    if func in (_aten.mv, _aten.addmv):
        return 2.0 * a.numel()
    # (.., M, K) @ (.., K, N)
    return 2.0 * a.numel() * b.shape[-1]


def _conv_flops(weight: torch.Tensor, out: torch.Tensor,
                transposed: bool) -> float:
    # per output element: every tap of the kernel over its input channels
    taps = weight.numel() / weight.shape[1 if transposed else 0]
    return 2.0 * out.numel() * taps


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.suspended = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.suspended:
            return out
        packet = func.overloadpacket
        ins = _tensors(args) + _tensors((kwargs or {}).values())
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        if packet in _DOTS:
            self.cost.add("dot_general", _dot_flops(packet, args),
                          _nbytes(ins) + _nbytes(outs))
        elif packet is _aten.convolution:
            self.cost.add("conv_general_dilated",
                          _conv_flops(args[1], outs[0], bool(args[6])),
                          _nbytes(ins) + _nbytes(outs))
        elif packet is _aten.convolution_backward:
            grad_out, weight = args[0], args[2]
            n_grads = sum(bool(m) for m in args[-1][:2])
            self.cost.add("conv_general_dilated",
                          n_grads * _conv_flops(weight, grad_out,
                                                bool(args[7])),
                          _nbytes(ins) + _nbytes(outs))
        elif packet in _MATERIALIZING and ins:
            self.cost.add(_MATERIALIZING[packet], float(ins[0].numel()),
                          _nbytes(ins) + _nbytes(outs))
        return out


_ACTIVE: List[_Counter] = []
_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def _kernel_scope(name: str, cost: Callable[[], Tuple[float, float]]):
    top = _ACTIVE[-1]
    flops, nbytes = cost()
    top.cost.add(name, flops, nbytes)
    top.suspended += 1
    try:
        yield
    finally:
        top.suspended -= 1


def kernel(name: str, cost: Callable[[], Tuple[float, float]]):
    """Context of one kernel call: while a counter is active, bills
    ``cost()`` = (FLOPs, bytes) under ``name`` and counts no aten op
    inside; otherwise a null context (``cost`` is not called)."""
    if not _ACTIVE:
        return _NULL
    return _kernel_scope(name, cost)


def counting() -> bool:
    return bool(_ACTIVE)


@contextlib.contextmanager
def count():
    """Count the cost of everything run inside; yields the ``Cost``."""
    counter = _Counter()
    _ACTIVE.append(counter)
    try:
        with counter:
            yield counter.cost
    finally:
        _ACTIVE.pop()


def cost_of_fn(fn, *args, n_devices: int = 1) -> Dict[str, float]:
    """Run ``fn(*args)`` (meta tensors: shapes only) and return its global
    and per-device analytic cost, with the reference's keys."""
    with count() as c:
        fn(*args)
    return {
        "flops_global": c.flops,
        "traffic_bytes_global": c.traffic_bytes,
        "flops_per_device": c.flops / n_devices,
        "traffic_per_device": c.traffic_bytes / n_devices,
        "by_prim": dict(sorted(c.by_prim.items(), key=lambda kv: -kv[1])[:8]),
    }


# -- the kernels' work -------------------------------------------------------
#
# One copy of each hand-written kernel's work on given inputs, read by
# ``kernels.ops`` (billed to an active counter) and by ``chip_smoke.py``
# (its bounds: the work over the card's rates). Each returns its FLOPs,
# 2 per multiply-add, in the groups a bound runs at different rates, and
# last the bytes the call must move: each input read once, each output
# written once. Where the work depends on the data (lengths, starts),
# it counts what the values need; meta values count as the most the
# shapes allow.

# A flash kernel's FLOPs per valid (query, key) pair and head, over D:
# (the products of two input-typed operands: s = q k^T, dP = dO v^T; the
# products of an fp32 softmax P or dS with an input-typed operand: P V,
# dS K, P^T dO, dS^T Q), and the q-sized, k-sized and (B, H, Sq) fp32
# row-sized tensors it moves. K10 and K6 compute s and P V (K6 also
# writes its lse rows); K7 recomputes s and dP and does dS K; K8
# recomputes s and dP and does P^T dO and dS^T Q
FLASH_WORK = {
    "flash_attention": ((2, 2), (2, 2, 0)),
    "flash_attention_fwd": ((2, 2), (2, 2, 1)),
    "flash_attention_bwd_dq": ((4, 2), (3, 2, 2)),
    "flash_attention_bwd_dkv": ((4, 4), (2, 4, 2)),
}


def attention_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """Valid (query, key) pairs of one (batch, head): query i sees keys
    j <= i (causal) with i - j < window (window > 0)."""
    if not causal:
        return sq * sk
    if sq == sk:
        if window <= 0 or window >= sq:
            return sq * (sq + 1) // 2
        return window * (window + 1) // 2 + (sq - window) * window
    return sum(max(0, min(i, sk - 1) - (max(0, i - window + 1)
                                        if window > 0 else 0) + 1)
               for i in range(sq))


def _lengths(lengths: torch.Tensor, capacity: int) -> List[int]:
    """Each row's length, or ``capacity`` for meta lengths."""
    return ([capacity] * lengths.numel() if lengths.is_meta
            else [int(n) for n in lengths.tolist()])


def kv_row_bytes(kv: torch.Tensor) -> int:
    """Bytes of one K/V row (all heads); int8 codes carry a 4-byte scale
    per head."""
    hkv, d = kv.shape[-2:]
    return hkv * (d * kv.element_size() + (4 if kv.dtype == torch.int8
                                           else 0))


def nbytes(*ts) -> float:
    return _nbytes([t for t in ts if t is not None])


def decode_work(q, k, lengths, window: int, capacity: int,
                page_size: int = 0) -> Tuple[float, float]:
    """(FLOPs, bytes) of a decode call (K1; K2 with ``page_size``): 4 H D
    FLOPs per live key and head, a row's live keys its last ``window``;
    the live K/V rows (with their scales for int8), q, the output and
    the lengths (K2 also the table entries of the live rows' pages)."""
    b, h, d = q.shape
    lens = _lengths(lengths, capacity)
    los = [max(0, n - window) if window > 0 else 0 for n in lens]
    live = sum(max(0, n - lo) for n, lo in zip(lens, los))
    total = 2 * live * kv_row_bytes(k) + 2 * nbytes(q) + 4 * b
    if page_size:
        total += 4 * sum(-(-n // page_size) - lo // page_size
                         for n, lo in zip(lens, los) if n > 0)
    return 4.0 * live * h * d, float(total)


def verify_work(q, k_pool, lengths, window: int, capacity: int,
                page_size: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of a K5 call: 4 H D FLOPs per valid (lane, key) pair
    and head (lane l of a row of length n sits at n - T + l); the K/V rows
    some lane of a row attends (with their scales for int8), q, the
    output, the lengths and those rows' table entries."""
    b, t, h, d = q.shape
    rows = pairs = pages = 0
    for n in _lengths(lengths, capacity):
        if n <= 0:
            continue
        spans = []
        for lane in range(t):
            q_pos = n - t + lane
            lo = max(0, q_pos + 1 - window) if window > 0 else 0
            spans.append((lo, min(q_pos + 1, capacity)))
            pairs += max(0, spans[-1][1] - lo)
        lo, hi = spans[0][0], spans[-1][1]
        if hi > lo:
            rows += hi - lo
            pages += -(-hi // page_size) - lo // page_size
    total = (2 * rows * kv_row_bytes(k_pool) + 2 * nbytes(q) + 4 * b
             + 4 * pages)
    return 4.0 * pairs * h * d, float(total)


def prefill_work(q, k_pool, starts, lens, window: int,
                 page_size: int) -> Tuple[float, float, float]:
    """(FLOPs on cached keys, FLOPs on the chunk's own keys, bytes) of a
    K3 call: 4 H D FLOPs per valid (query, key) pair; q of every lane of a
    live row, the live chunk tokens' k and v, the cached keys the row's
    lanes attend (per row, [start - window + 1, start) or [0, start)), the
    output and the table entries. A padding lane (t >= len) of a live row
    attends the row's keys below start + len that its window reaches.
    Meta rows count as fresh full chunks (start 0, every lane live)."""
    b, c, h, d = q.shape
    hkv = k_pool.shape[2]
    if starts.is_meta:
        rows = [(0, c)] * b
    else:
        rows = list(zip(starts.tolist(), lens.tolist()))
    cached = cached_pairs = chunk_pairs = live_rows = live = 0
    for start, ln in rows:
        if ln <= 0:
            continue
        live_rows += 1
        live += ln
        lo = max(0, start - window + 1) if window > 0 else 0
        cached += start - lo
        for t in range(c):
            if window > 0:      # keys with q_abs - k_abs < window
                cached_pairs += min(start, max(0, window - 1 - t))
                chunk_pairs += max(0, min(t + 1, ln)
                                   - max(0, t - window + 1))
            else:
                cached_pairs += start
                chunk_pairs += min(t + 1, ln)
    es = q.element_size()
    total = (live_rows * c * h * d * es + live * 2 * hkv * d * es
             + 2 * cached * kv_row_bytes(k_pool) + nbytes(q)
             + 4 * sum(-(-s // page_size) for s, _ in rows) + 8 * b)
    return (4.0 * h * d * cached_pairs, 4.0 * h * d * chunk_pairs,
            float(total))


def flash_work(name: str, q, k, causal: bool, window: int,
               extra=()) -> Tuple[float, float, float]:
    """(FLOPs of input-typed products, FLOPs of products with fp32 P or
    dS, bytes) of the flash kernel ``name`` (``FLASH_WORK``) on q (B, Sq,
    H, D) and k (B, Sk, Hkv, D); ``extra`` tensors (int8 K/V's scales)
    are read once more."""
    (exact, on_p), (q_reads, k_reads, row_reads) = FLASH_WORK[name]
    b, sq, h, d = q.shape
    pairs = b * h * attention_pairs(sq, k.shape[1], causal, window)
    total = (q_reads * nbytes(q) + k_reads * nbytes(k)
             + row_reads * 4 * b * h * sq + nbytes(*extra))
    return float(exact * d * pairs), float(on_p * d * pairs), float(total)


def matmul_work(x2, codes, out_cols: int,
                out_itemsize: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of x2 (M, ·) against weight codes (K, N) with (N,)
    fp32 scales into (M, ``out_cols``): K4 and K11 (x (M, K), out N) and
    K9 (dy (M, N), out K). 2 M K N FLOPs; x2, the codes, the scales and
    the output."""
    m = x2.shape[0]
    return (2.0 * m * codes.numel(),
            nbytes(x2, codes) + 4.0 * codes.shape[1]
            + m * out_cols * out_itemsize)


__all__ = ["Cost", "cost_of_fn", "count", "kernel", "counting",
           "FLASH_WORK", "attention_pairs", "kv_row_bytes", "nbytes",
           "decode_work", "verify_work", "prefill_work", "flash_work",
           "matmul_work"]
