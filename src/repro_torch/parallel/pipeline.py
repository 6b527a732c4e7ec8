"""GPipe-style pipeline parallelism over a ``pipe`` mesh axis (mirror of
``repro.parallel.pipeline``).

Stages hold equal slices of a homogeneous layer stack; microbatches stream
through a ring of point-to-point shifts. The schedule is the classic (M +
P - 1)-tick rotation: rank 0 injects microbatch t at tick t, rank P-1
emits microbatch t - (P-1); bubble fraction = (P-1)/(M+P-1).

Differentiable end to end, as the reference's is (JAX transposes its
``ppermute``): torch's point-to-point calls have no autograd, so the ring
shift is a ``torch.autograd.Function`` whose forward sends to the next
rank and receives from the previous one and whose backward does the
reverse, and the final sum over the ring is ``compat.psum``, whose
backward passes the replicated output's cotangent through, as the
reference's ``psum`` does under its replicated output. The injection and
emission masks are ``torch.where`` selections, as in the reference, so
every rank's graph holds every tick's shift and the backward's shifts
pair up rank for rank.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.parallel import compat

PyTree = Any


class _RingShift(torch.autograd.Function):
    """Forward: x to the next rank, the previous rank's x back. Backward:
    the gradient to the previous rank, the next rank's back."""

    @staticmethod
    def forward(ctx, x, group, nxt, prv):
        ctx.ring = (group, nxt, prv)
        return compat.exchange(x, nxt, prv, group)

    @staticmethod
    def backward(ctx, dy):
        group, nxt, prv = ctx.ring
        return compat.exchange(dy, prv, nxt, group), None, None, None


def ring_shift(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None
               ) -> torch.Tensor:
    """The reference's ``ppermute`` over the ring i -> i + 1."""
    return _RingShift.apply(x, group, *compat.ring_peers(group))


def pipeline_apply(stage_fn: Callable[[PyTree, torch.Tensor], torch.Tensor],
                   local_params: PyTree, microbatches: torch.Tensor,
                   group: Optional[dist.ProcessGroup] = None
                   ) -> torch.Tensor:
    """Stream microbatches through the pipeline's stages, one per rank of
    ``group``.

    local_params: this rank's stage parameters. microbatches: (M, mb, ...)
    identical on every rank. Returns (M, mb, ...) final-stage outputs,
    identical on every rank."""
    p = compat.axis_index(group)
    n_stage = compat.axis_size(group)
    m = microbatches.shape[0]
    state = torch.zeros_like(microbatches[0])
    outputs = list(torch.zeros_like(microbatches).unbind(0))
    first, last = torch.tensor(p == 0), torch.tensor(p == n_stage - 1)
    for t in range(m + n_stage - 1):
        inject = microbatches[min(max(t, 0), m - 1)]
        x_in = torch.where(first, inject, state)
        active = torch.tensor(0 <= t - p < m)
        y = torch.where(active, stage_fn(local_params, x_in), state)
        out_idx = min(max(t - (n_stage - 1), 0), m - 1)
        emit = torch.tensor(p == n_stage - 1 and 0 <= t - (n_stage - 1) < m)
        outputs[out_idx] = torch.where(emit, y, outputs[out_idx])
        state = ring_shift(y, group)
    # outputs are only populated on the last stage; share them ring-wide
    return compat.psum(torch.where(last, torch.stack(outputs), 0.0), group)


def make_pipelined_fn(stage_fn: Callable, mesh, n_micro: int,
                      axis_name: str = "pipe",
                      group: Optional[dist.ProcessGroup] = None
                      ) -> Callable:
    """Wrap ``stage_fn(params_slice, x) -> x`` into a pipelined map.

    ``stacked_params`` leaves have a leading stage dim of
    ``mesh.shape[axis_name]``; each rank runs the slice at its index on
    the axis. x is (batch, ...), the same on every rank, split into
    ``n_micro`` microbatches. ``group`` is the axis's process group (the
    default group when None)."""
    n_stage = mesh.shape[axis_name]

    def run(stacked_params, x):
        if compat.axis_size(group) != n_stage:
            raise ValueError(f"make_pipelined_fn: {n_stage} stages on a "
                             f"group of {compat.axis_size(group)} ranks")
        me = compat.axis_index(group)
        local = _pick(stacked_params, me)
        b = x.shape[0]
        micro = x.reshape(n_micro, b // n_micro, *x.shape[1:])
        y = pipeline_apply(stage_fn, local, micro, group)
        return y.reshape(b, *y.shape[2:])

    return run


def _pick(tree, i: int):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
