"""Atomic, async checkpointing of tensor trees (mirror of
``repro.checkpoint.manager``, numpy/npz backend, the same on-disk format).

Fault-tolerance contract (tested in tests/test_torch_trainer.py):

* **Atomicity**: a checkpoint directory appears only via os.rename of a
  fully written tmp dir, so a crash mid-save never corrupts the latest
  checkpoint.
* **Async**: saves run on a writer thread off the training loop; ``wait()``
  joins before the next save or process exit. ``save`` copies every leaf
  to host memory before it returns: the port's optimizer updates params
  and state in place, so the writer must not read the live tensors (a CPU
  tensor's ``.numpy()`` shares its storage).
* **Keep-k GC**: old steps are garbage-collected after a successful save,
  and stale tmp dirs of crashed saves are cleaned.
* **Integrity**: the manifest carries ``tree_checksum`` over the arrays
  and ``extra``; restore refuses a flipped bit.
* **Iterator state**: the data-pipeline step rides in the manifest, so a
  restart replays the exact token stream.

Layout:  <dir>/ckpt_00000042/{manifest.json, arrays.npz}, leaves named by
their dict keys joined with ``/`` in sorted key order (``jax.tree_util``'s
order), so the JAX manager and this one read each other's fp32 files.
bf16 leaves are stored as their raw 16-bit words (numpy has no bf16 type)
with ``bfloat16`` as the manifest dtype, and hashed as the reference hashes
an ``ml_dtypes`` bf16 array: the dtype name, then the raw bytes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

PyTree = Any
BF16 = "bfloat16"


@dataclasses.dataclass
class CheckpointConfig:
    directory: str
    keep_last: int = 3
    async_save: bool = True


def tree_checksum(named: List[Tuple[str, np.ndarray]],
                  extra: Dict[str, Any],
                  dtypes: Optional[Dict[str, str]] = None) -> str:
    """Content checksum over a checkpoint's arrays (name, dtype, shape,
    raw bytes, in manifest order) and its ``extra`` dict (canonical JSON),
    as ``repro.checkpoint.manager.tree_checksum`` computes it. ``dtypes``
    names a leaf's dtype where its numpy dtype does not (bf16 words held
    as uint16)."""
    dtypes = dtypes or {}
    h = hashlib.sha256()
    for name, arr in named:
        a = np.ascontiguousarray(np.asarray(arr))
        h.update(name.encode("utf-8"))
        h.update(dtypes.get(name, str(a.dtype)).encode("utf-8"))
        h.update(repr(tuple(a.shape)).encode("utf-8"))
        h.update(a.tobytes())
    h.update(json.dumps(extra, sort_keys=True).encode("utf-8"))
    return h.hexdigest()


def _named_leaves(tree: PyTree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) in ``jax.tree_util``'s order: dict keys sorted, names
    joined with ``/``."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out.extend(_named_leaves(tree[key], f"{prefix}{key}/"))
        return out
    return [(prefix[:-1], tree)]


def _treedef(tree: PyTree) -> str:
    """The tree's structure in ``jax.tree_util``'s notation (informational:
    restore reads the names, not this)."""
    def walk(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        return "*"
    return f"PyTreeDef({walk(tree)})"


def _host_copy(leaf) -> Tuple[np.ndarray, str]:
    """A host copy of one leaf that no later in-place update can reach,
    and its manifest dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            words = t.view(torch.int16).to("cpu", copy=True).numpy()
            return words.view(np.uint16), BF16
        a = t.to("cpu", copy=True).numpy()
    else:
        a = np.array(leaf, copy=True)
    return a, str(a.dtype)


def _to_tensor(arr: np.ndarray, dtype_name: str, want: torch.dtype,
               device) -> torch.Tensor:
    """A stored array as a tensor of the target's dtype on ``device``; bf16
    words are viewed back as bf16 first."""
    arr = np.asarray(arr, order="C")        # keeps a 0-dim leaf 0-dim
    if dtype_name == BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=want)


class CheckpointManager:
    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        os.makedirs(cfg.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- paths -----------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.cfg.directory, f"ckpt_{step:08d}")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.cfg.directory):
            if name.startswith("ckpt_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except (IndexError, ValueError):
                    continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save --------------------------------------------------------------------

    def save(self, step: int, tree: PyTree,
             extra: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot then (maybe async) persist. Every leaf is copied to host
        memory here, so the caller may update its tensors in place as soon
        as this returns."""
        self.wait()
        named, dtypes = [], {}
        for name, leaf in _named_leaves(tree):
            arr, dtype_name = _host_copy(leaf)
            named.append((name, arr))
            dtypes[name] = dtype_name
        manifest = {
            "step": int(step),
            "treedef": _treedef(tree),
            "names": [n for n, _ in named],
            "shapes": {n: list(a.shape) for n, a in named},
            "dtypes": dtypes,
            "extra": extra or {},
        }
        manifest["checksum"] = tree_checksum(named, manifest["extra"], dtypes)

        def _write():
            try:
                final = self._step_dir(step)
                tmp = tempfile.mkdtemp(prefix=f"ckpt_{step:08d}.tmp.",
                                       dir=self.cfg.directory)
                np.savez(os.path.join(tmp, "arrays.npz"),
                         **{n: a for n, a in named})
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        if self.cfg.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()
            self._raise_if_failed()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint save failed: {err!r}") from err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.cfg.keep_last] if self.cfg.keep_last > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        # clean stale tmp dirs from crashed saves
        for name in os.listdir(self.cfg.directory):
            if ".tmp." in name:
                shutil.rmtree(os.path.join(self.cfg.directory, name),
                              ignore_errors=True)

    def peek_extra(self, step: Optional[int] = None) -> Dict[str, Any]:
        """Read a checkpoint's manifest ``extra`` without loading arrays, for
        restore paths that must rebuild their runtime to match the snapshot
        before calling :meth:`restore` with a target tree."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints in {self.cfg.directory}")
        with open(os.path.join(self._step_dir(step),
                               "manifest.json")) as f:
            return json.load(f).get("extra", {})

    # -- restore -------------------------------------------------------------------

    def restore(self, step: Optional[int] = None, *, target: PyTree = None,
                device=None) -> Tuple[int, PyTree, Dict[str, Any]]:
        """Load a checkpoint into ``target``'s structure: a tree of tensors
        (or of anything with a torch ``shape`` and ``dtype``). Each leaf
        comes back as a tensor of the target leaf's dtype on ``device``
        (default: the target leaf's own device, else the CPU). The
        reference's ``shardings`` (reshard-on-load onto a mesh) has no
        counterpart on one card."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.cfg.directory}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as arrays:
            by_name = {n: arrays[n] for n in manifest["names"]}
        dtypes = manifest.get("dtypes", {})
        # bf16 words (and another writer's 2-byte bf16 records) by their
        # manifest name; every other leaf by its numpy dtype
        bf16 = {n: BF16 for n in by_name if dtypes.get(n) == BF16
                and by_name[n].dtype.itemsize == 2}
        for n in bf16:
            by_name[n] = by_name[n].view(np.uint16)

        # integrity gate: refuse a tampered/bit-rotted checkpoint before
        # any of it reaches the caller (checkpoints without a digest skip it)
        want_sum = manifest.get("checksum")
        if want_sum is not None:
            got_sum = tree_checksum(
                [(n, by_name[n]) for n in manifest["names"]],
                manifest.get("extra", {}), bf16)
            if got_sum != want_sum:
                raise RuntimeError(
                    f"checkpoint {d} failed integrity check: manifest "
                    f"checksum {want_sum[:16]}..., recomputed "
                    f"{got_sum[:16]}... — refusing to restore corrupt "
                    f"state")

        if target is None:
            raise ValueError("restore requires a target structure")

        def build(t, prefix):
            if isinstance(t, dict):
                return {k: build(t[k], f"{prefix}{k}/") for k in t}
            name = prefix[:-1]
            if name not in by_name:
                raise KeyError(f"checkpoint missing leaf {name}")
            arr = by_name[name]
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"shape mismatch for {name}: "
                                 f"{arr.shape} vs {tuple(t.shape)}")
            dev = device if device is not None else getattr(t, "device",
                                                            "cpu")
            return _to_tensor(arr, bf16.get(name, ""), t.dtype, dev)

        tree = build(target, "")
        return int(manifest["step"]), tree, manifest.get("extra", {})
