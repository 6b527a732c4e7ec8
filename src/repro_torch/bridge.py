"""Bridge from the JAX package's parameters and configs to the port's.

Tests build a model with ``repro.models.transformer.init_lm``, turn its tree
into numpy with ``jax.tree.map(np.asarray, params)``, and load it here, so
the two frameworks run the very same weights. This module itself imports
neither JAX nor ``repro``: it reads numpy arrays and plain dicts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.models.transformer import BlockSpec, LMConfig, QuantPolicy

# LMConfig fields of the JAX package that only steer TPU compilation,
# sharding, training or the Pallas switches; they do not change what the
# model computes. (``mrope_sections`` only matters under pos_emb="mrope",
# which ``LMConfig`` refuses.)
_TPU_ONLY_FIELDS = frozenset({
    "remat", "moe_group_size", "z_loss", "sp_attention", "sp_residual",
    "kv_cache_dtype", "decode_kernel", "flash_train", "mrope_sections"})


def _to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    # np.array copies: arrays from jax are read-only, torch tensors are not
    if a.dtype.name == "bfloat16":          # ml_dtypes; exact through fp32
        return torch.from_numpy(np.array(a, np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree: Dict[str, Any], cfg: LMConfig,
                      device="cuda") -> Dict[str, Any]:
    """The JAX parameter tree (nested dicts of numpy arrays, ``pat{i}``
    stacked over ``repeats`` as ``init_lm`` makes it) as the port's
    parameters: the same keys and layouts, as tensors on ``device``."""
    dev = device_lib.resolve(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return _to_tensor(t, dev)

    out = walk(tree)
    rows = out["embed"]["w"].shape[0]
    if rows != cfg.padded_vocab:
        raise ValueError(f"embedding has {rows} rows; {cfg.name} needs "
                         f"padded_vocab {cfg.padded_vocab}")
    for i in range(len(cfg.pattern)):
        lead = out[f"pat{i}"]["norm_attn"]["scale"].shape[0]
        if lead != cfg.repeats:
            raise ValueError(f"pat{i} is stacked {lead} deep; {cfg.name} "
                             f"repeats {cfg.repeats}")
    return out


def config_from_dict(d: Dict[str, Any]) -> LMConfig:
    """The port's ``LMConfig`` from ``dataclasses.asdict`` of a JAX one.
    TPU-only knobs are dropped; features the port lacks raise
    ``NotImplementedError`` (here or in ``LMConfig``)."""
    if d.get("moe_cfg") is not None or d.get("ssd_cfg") is not None:
        raise NotImplementedError("MoE and SSD configs are not ported yet")
    if d.get("vision_tokens", 0):
        raise NotImplementedError("the vision frontend is not ported yet")
    fields = {f.name for f in dataclasses.fields(LMConfig)}
    unknown = set(d) - fields - _TPU_ONLY_FIELDS - {"moe_cfg", "ssd_cfg",
                                                    "vision_tokens"}
    if unknown:
        raise ValueError(f"unknown LMConfig fields {sorted(unknown)}")
    kw = {k: v for k, v in d.items() if k in fields}
    kw["pattern"] = tuple(BlockSpec(**s) for s in d["pattern"])
    kw["tail"] = tuple(BlockSpec(**s) for s in d.get("tail", ()))
    if "quant" in d:
        kw["quant"] = QuantPolicy(**d["quant"])
    return LMConfig(**kw)
