"""Production mesh descriptions (a function: importing this module touches
no device and no process group)."""

from __future__ import annotations

from repro_torch.parallel import compat


def make_production_mesh(*, multi_pod: bool = False) -> compat.Mesh:
    """16 x 16 = 256 devices per pod; multi-pod adds a leading 2-pod axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat.make_mesh(shape, axes)


def make_mesh(shape, axes) -> compat.Mesh:
    """Arbitrary mesh helper (tests, one card: ``make_mesh((1, 1),
    ("data", "model"))``)."""
    return compat.make_mesh(shape, axes)
