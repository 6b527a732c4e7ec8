"""Activation-sharding context: model code stays mesh-agnostic (mirror of
``repro.parallel.ctx``).

``constrain(x, *logical_axes)`` returns ``x`` itself unless a mesh and
rules context is active. Under a context whose mesh has a ``DeviceMesh``
(``activation_sharding(mesh, rules, device_mesh=...)``), a DTensor ``x``
is redistributed to the placements that the same logical -> mesh rules
give parameters (the reference's ``with_sharding_constraint``); a fully
replicated spec leaves ``x`` alone, as in the reference, and so does a
plain tensor or a context without a ``DeviceMesh``. The port's model code
does not call ``constrain`` yet: no sharded model step runs on one card.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

from repro_torch.parallel import sharding as sh

_state = threading.local()


def _current():
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def activation_sharding(mesh, rules=None, device_mesh=None):
    prev = _current()
    _state.ctx = (mesh, rules or sh.DEFAULT_RULES, device_mesh)
    try:
        yield
    finally:
        _state.ctx = prev


def constrain(x, *axes: Optional[str]):
    """Constrain ``x``'s sharding by logical axis names (no-op without a
    context)."""
    ctx = _current()
    if ctx is None:
        return x
    mesh, rules, device_mesh = ctx
    if len(axes) != x.dim():
        return x
    spec = sh.spec_for(x.shape, axes, mesh, rules)
    if all(e is None for e in spec):
        return x          # a fully replicated constraint would only pessimize
    from torch.distributed.tensor import DTensor
    if device_mesh is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(device_mesh, sh.placements_for(spec, mesh))
