"""Mesh description and mesh-axis queries on ``torch.distributed`` (the
counterpart of ``repro.parallel.compat``).

``make_mesh(shape, axes)`` returns a ``Mesh``: a description of a device
mesh with ``.shape`` (an ordered dict of axis name to size, as the
reference's meshes have) and ``.axis_names``. Building it touches no
device and no process group, so the sharding rules and the dry-run run
on any machine; ``Mesh.device_mesh()`` builds the
``torch.distributed.device_mesh.DeviceMesh`` once a process group of the
mesh's size is up. ``axis_size`` and ``axis_index`` read a mesh axis's
process group, the counterparts of ``lax.axis_size`` and
``lax.axis_index`` inside ``shard_map``; ``psum`` is the differentiable
sum over a mesh axis of a value every rank then holds.

The reference's ``shard_map``, ``pvary`` and ``cost_analysis_dict`` have
no counterpart: torch runs one program per rank, each on its own shard,
so there is nothing to map, no varying-ness to mark and no compiled
program to query (``core.flops`` counts the cost instead).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def device_mesh(self, device_type: str = "cuda"):
        """The ``DeviceMesh`` over ranks 0 .. size-1 of the default process
        group, which must be up with this mesh's size."""
        from torch.distributed.device_mesh import init_device_mesh
        if not dist.is_initialized():
            raise RuntimeError("device_mesh: no process group is up")
        if dist.get_world_size() != self.size:
            raise ValueError(f"device_mesh: a mesh of {self.size} devices "
                             f"needs a process group of that size, not "
                             f"{dist.get_world_size()}")
        return init_device_mesh(device_type, self.sizes,
                                mesh_dim_names=self.axis_names)


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    return Mesh(axes, shape)


def axis_size(group: Optional[dist.ProcessGroup] = None) -> int:
    """Ranks on a mesh axis, given the axis's process group (``None``: the
    default group)."""
    return dist.get_world_size(group)


def axis_index(group: Optional[dist.ProcessGroup] = None) -> int:
    """This rank's position on a mesh axis, given its process group."""
    return dist.get_rank(group)


def ring_peers(group: Optional[dist.ProcessGroup] = None) -> Tuple[int, int]:
    """(next, previous) on the ring i -> i + 1 over ``group``, as global
    ranks (what point-to-point calls take)."""
    n, p = axis_size(group), axis_index(group)

    def glob(r):
        return r if group is None else dist.get_global_rank(group, r)

    return glob((p + 1) % n), glob((p - 1) % n)


def exchange(x: torch.Tensor, to: int, frm: int,
             group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Sends ``x`` to rank ``to`` and returns what rank ``frm`` sends, as
    one ``batch_isend_irecv``: a ring of these cannot deadlock on blocking
    sends."""
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), to, group),
           dist.P2POp(dist.irecv, out, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Psum(torch.autograd.Function):
    """Forward: the sum over the group. Backward: the cotangent itself.
    The sum is replicated and every rank computes the same loss from it,
    so each rank's cotangent already is the one loss's, and d(sum)/dx_r is
    the identity: the reference's ``psum`` under a replicated output
    (``out_specs=P()``). ``torch.distributed.nn.functional.all_reduce``
    would sum the ranks' cotangents in its backward, which is the
    gradient of the sum of the ranks' losses: the group's size times
    this one."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def psum(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None
         ) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``group``, for a
    result every rank then holds (see ``_Psum``)."""
    return _Psum.apply(x, group)
