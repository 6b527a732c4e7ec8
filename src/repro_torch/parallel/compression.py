"""Int8 error-feedback gradient compression for the DP all-reduce (mirror
of ``repro.parallel.compression``).

Compressing gradients 4x (fp32 -> int8 plus one fp32 scale per chunk)
cuts the bytes of the data-parallel all-reduce. Error feedback keeps the
compression unbiased over time: the residual e_t = g_t - dq(q(g_t +
e_{t-1})) is carried in the optimizer state.

``ring_allreduce_int8`` is the reference's ring reduce-scatter then
all-gather with int8 payloads and per-hop requantization, in the same
chunk schedule, on a ``torch.distributed`` process group. Each hop sends
to the next rank and receives from the previous one through
``compat.exchange`` (``batch_isend_irecv``), so the ring cannot deadlock.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel import compat

PyTree = Any


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-20) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _ring_hop(send_q: torch.Tensor, send_s: torch.Tensor, group,
              nxt: int, prv: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One hop of the ring: this rank's (codes, scale) go to the next rank,
    the previous rank's come back (the reference's ``ppermute``)."""
    return (compat.exchange(send_q, nxt, prv, group),
            compat.exchange(send_s, nxt, prv, group))


def ring_allreduce_int8(x: torch.Tensor,
                        group: Optional[dist.ProcessGroup] = None
                        ) -> torch.Tensor:
    """Mean-all-reduce of ``x`` over ``group`` with int8 payloads. Wire
    bytes: ~2 * size * (n-1)/n * 1 B against 4 B in fp32."""
    n = compat.axis_size(group)
    if n == 1:
        return x
    idx = compat.axis_index(group)
    nxt, prv = compat.ring_peers(group)
    flat = x.reshape(-1).float()
    flat = torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % n))
    chunks = flat.reshape(n, -1)

    # ring reduce-scatter: at hop i this rank adds its own chunk
    # (idx - i - 1) mod n to the partial sum it receives; after n-1 hops it
    # owns the full sum of chunk (idx + 1) mod n
    send_q, send_s = _quantize(chunks[idx % n])
    for i in range(n - 1):
        recv_q, recv_s = _ring_hop(send_q, send_s, group, nxt, prv)
        summed = _dequantize(recv_q, recv_s) + chunks[(idx - i - 1) % n]
        send_q, send_s = _quantize(summed)
    own_id = (idx + 1) % n

    # ring all-gather of the reduced int8 chunks
    out = torch.zeros_like(chunks)
    out[own_id] = _dequantize(send_q, send_s)
    for i in range(n - 1):
        send_q, send_s = _ring_hop(send_q, send_s, group, nxt, prv)
        out[(own_id - i - 1) % n] = _dequantize(send_q, send_s)
    mean = out.reshape(-1)[:x.numel()] / n
    return mean.reshape(x.shape).to(x.dtype)


# -- error feedback ------------------------------------------------------------

def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def init_ef_state(grads_like: PyTree) -> PyTree:
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads_like)


def compress_grads_with_ef(grads: PyTree, ef: PyTree
                           ) -> Tuple[PyTree, PyTree]:
    """Quantize (grads + ef) to int8 per leaf; return (dq(grads), new ef):
    the single-device form of the error-feedback transform."""
    def one(g, e):
        target = g.float() + e
        q, s = _quantize(target)
        dq = _dequantize(q, s)
        return dq.to(g.dtype), target - dq

    pairs = _map(one, grads, ef)
    return (_map(lambda p, _: p[0], pairs, grads),
            _map(lambda p, _: p[1], pairs, grads))
