"""Logical-axis -> mesh sharding rules with divisibility fallbacks (mirror
of ``repro.parallel.sharding``).

Params, caches and activations carry logical axis names (the axes trees
beside each init: ``models.transformer.lm_axes`` and its kin). This
module maps them onto a mesh (``parallel.compat.Mesh``, or anything with
a ``.shape`` dict of axis sizes):

* default rules: batch -> the DP axes ("pod", "data"), the TP dims
  ("heads", "ffn", "vocab", "experts", "ssm_inner") -> "model", everything
  else replicated;
* **divisibility fallback**: a dim is sharded only if its size divides by
  the mesh axes' size (starcoder2's 36 heads and whisper's 20 replicate on
  a 16-way model axis; the FFN still shards);
* **conflict resolution**: a mesh axis appears at most once per spec,
  left to right (MoE ``w_in`` (experts, embed, ffn) shards experts, not
  ffn, on "model");
* rule overrides per shape cell (``LONG_CONTEXT_RULES``: batch 1 shards
  "seq" over the DP axes instead).

A spec is a tuple with one entry per tensor dim, trailing ``None``
entries trimmed: ``None`` (replicated), a mesh axis name, or a tuple of
them (one dim over two axes, major first). It compares equal to the
reference's ``PartitionSpec`` of the same entries. ``placements_for``
turns it into the DTensor placements of a ``DeviceMesh`` (one ``Shard``
or ``Replicate`` per mesh dim), ``local_shape`` into the shard one device
holds.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]

# default logical->mesh rules (per-leaf resolution is left to right over
# the dims)
DEFAULT_RULES: Dict[Optional[str], MeshAxes] = {
    "batch": ("pod", "data"),
    "seq": None,
    # context/sequence-parallel axis: constrained only by archs that opt in
    "seq_tp": "model",
    "vocab": "model",
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    # head_dim shards on "model" only when heads/kv_heads could not
    # (left-to-right conflict resolution): MQA and low-kv archs get sharded
    # KV caches instead of replicated ones
    "head_dim": "model",
    "ffn": "model",
    "experts": "model",
    "stack": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "ssm_group": None,
    "conv": None,
    "spatial": None,
    "channels": None,
    None: None,
}

# long-context (batch-unshardable) override: sequence-parallel over DP axes
LONG_CONTEXT_RULES = dict(DEFAULT_RULES, batch=None, seq=("pod", "data"),
                          seq_tp=None)


def _flat(axes: MeshAxes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _axis_size(mesh, axes: MeshAxes) -> int:
    return math.prod(mesh.shape.get(a, 1) for a in _flat(axes))


def _present(mesh, axes: MeshAxes) -> MeshAxes:
    """Drop mesh axes this mesh lacks (e.g. 'pod' on one pod)."""
    kept = tuple(a for a in _flat(axes) if a in mesh.shape)
    if not kept:
        return None
    if isinstance(axes, str) or len(kept) == 1:
        return kept[0]
    return kept


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]], mesh,
             rules: Optional[Mapping[Optional[str], MeshAxes]] = None
             ) -> Spec:
    """The spec of one leaf given its logical axes."""
    rules = rules or DEFAULT_RULES
    used: set = set()
    entries = []
    for dim, ax in zip(shape, axes):
        mesh_ax = _present(mesh, rules.get(ax))
        flat = _flat(mesh_ax)
        if (mesh_ax is None or any(a in used for a in flat)
                or dim % _axis_size(mesh, mesh_ax) != 0):
            # replicated, a conflict (left-to-right priority) or the
            # divisibility fallback
            entries.append(None)
            continue
        used.update(flat)
        entries.append(mesh_ax)
    while entries and entries[-1] is None:
        entries.pop()                      # canonical trailing-None trim
    return tuple(entries)


def _is_dataclass_node(x) -> bool:
    return hasattr(x, "__dataclass_fields__")


def _tree_map2(fn, shapes_tree, axes_tree):
    """Map over (leaves, axes) where the axes leaves are tuples; the
    dataclass nodes of a cache tree (``KVCache``, ``SSDState``) mirror
    into dicts of their fields in the axes tree."""
    if isinstance(shapes_tree, dict):
        return {k: _tree_map2(fn, v, axes_tree[k])
                for k, v in shapes_tree.items()}
    if _is_dataclass_node(shapes_tree):
        vals = {f: _tree_map2(fn, getattr(shapes_tree, f), axes_tree[f])
                for f in shapes_tree.__dataclass_fields__}
        return type(shapes_tree)(**vals)
    return fn(shapes_tree, axes_tree)


def specs_for_tree(params_shapes: Any, axes_tree: Any, mesh,
                   rules: Optional[Mapping[Optional[str], MeshAxes]] = None
                   ) -> Any:
    """A spec tree matching ``params_shapes`` (tensors, meta tensors, or
    anything with a ``.shape``)."""
    return _tree_map2(lambda leaf, ax: _leaf_spec(leaf, ax, mesh, rules),
                      params_shapes, axes_tree)


def _leaf_spec(leaf, ax, mesh, rules) -> Spec:
    if ax is None or not isinstance(ax, tuple):
        return ()
    return spec_for(tuple(leaf.shape), ax, mesh, rules)


def placements_for(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim in the
    mesh's axis order: ``Shard(d)`` where tensor dim d spans that mesh
    axis, else ``Replicate()``. A dim over two axes (("pod", "data")) is
    ``Shard(d)`` on both, the major axis first, as a DTensor nests them."""
    from torch.distributed.tensor import Replicate, Shard
    on = {a: d for d, entry in enumerate(spec) for a in _flat(entry)}
    return tuple(Shard(on[a]) if a in on else Replicate()
                 for a in mesh.shape)


def shardings_for_tree(params_shapes: Any, axes_tree: Any, mesh,
                       rules: Optional[Mapping[Optional[str], MeshAxes]]
                       = None) -> Any:
    """The placements of every leaf (``placements_for`` of its spec)."""
    return _tree_map2(
        lambda leaf, ax: placements_for(_leaf_spec(leaf, ax, mesh, rules),
                                        mesh),
        params_shapes, axes_tree)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shard of a ``shape`` tensor one device holds under ``spec``
    (``spec_for`` shards only dims that divide)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-int(n) // _axis_size(mesh, e))
                 for n, e in zip(shape, spec))


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def dp_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))


def batch_spec(mesh, batch_size: int, *, seq_len: int,
               long_context: bool = False) -> Spec:
    """Spec of (batch, seq) token arrays."""
    rules = LONG_CONTEXT_RULES if long_context else DEFAULT_RULES
    return spec_for((batch_size, seq_len), ("batch", "seq"), mesh, rules)


def _spec_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _spec_leaves(v)]
    if _is_dataclass_node(tree):
        return [s for f in tree.__dataclass_fields__
                for s in _spec_leaves(getattr(tree, f))]
    return [tree]


def summarize(specs_tree: Any) -> Dict[str, int]:
    """Histogram of spec strings."""
    out: Dict[str, int] = {}
    for leaf in _spec_leaves(specs_tree):
        key = f"P{leaf!r}"
        out[key] = out.get(key, 0) + 1
    return out
