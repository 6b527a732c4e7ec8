"""Bridge from the JAX package's parameters and configs to the port's.

Tests build a model with ``repro.models.transformer.init_lm`` (or
``repro.models.encdec.init_encdec``, ``repro.models.cnn.init_cnn``), turn its tree into numpy with
``jax.tree.map(np.asarray, params)``, and load it here, so the two
frameworks run the very same weights. This module itself imports
neither JAX nor ``repro``: it reads numpy arrays and plain dicts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.models import cnn, encdec
from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssd import SSDConfig
from repro_torch.models.transformer import BlockSpec, LMConfig, QuantPolicy
from repro_torch.quant.ternary import TernaryWeight

# LMConfig fields of the JAX package that only steer TPU compilation,
# sharding, rematerialization or the Pallas switches; they do not change
# what the model or its loss computes. (``moe_group_size`` does, once
# routes drop, and is carried.)
_TPU_ONLY_FIELDS = frozenset({
    "remat", "sp_attention", "sp_residual",
    "kv_cache_dtype", "decode_kernel", "flash_train"})


def _to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    # np.array copies: arrays from jax are read-only, torch tensors are not
    if a.dtype.name == "bfloat16":          # ml_dtypes; exact through fp32
        return torch.from_numpy(np.array(a, np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree: Dict[str, Any], cfg: LMConfig,
                      device="cuda") -> Dict[str, Any]:
    """The JAX parameter tree (nested dicts of numpy arrays, ``pat{i}``
    stacked over ``repeats`` as ``init_lm`` makes it, ``tail{i}`` single)
    as the port's parameters: the same keys and layouts, as tensors on
    ``device``. Every leaf is carried: gemma3's six stacked pattern groups
    and its two-block tail, the QKV biases (``bq``, ``bk``, ``bv``), an
    untied ``unembed``, the ``moe`` groups (``router`` (R, d, E),
    ``w_in``/``w_gate`` (R, E, d, f), ``w_out`` (R, E, f, d)), the ``ssd``
    groups and zamba2's one ``shared_attn`` group alike. The depth check
    reads each stacked group's norm (``norm_attn``, or ``norm_ssd`` in an
    SSD group); a shared site has no group of its own."""
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
    for i, spec in enumerate(cfg.pattern):
        if spec.shared_attn:
            continue
        norm = "norm_ssd" if spec.kind == "ssd" else "norm_attn"
        lead = out[f"pat{i}"][norm]["scale"].shape[0]
        if lead != cfg.repeats:
            raise ValueError(f"pat{i} is stacked {lead} deep; {cfg.name} "
                             f"repeats {cfg.repeats}")
        moe = out[f"pat{i}"].get("moe")
        if moe is not None:
            m = cfg.moe_cfg
            w_in = moe["w_in"]
            got = tuple((w_in["q8"] if isinstance(w_in, dict) else w_in).shape)
            want = (cfg.repeats, m.n_experts, m.d_model, m.d_ff)
            if got != want:
                raise ValueError(f"pat{i} experts are {got}; {cfg.name} "
                                 f"needs {want}")
    return out


def cnn_params_from_numpy(tree: Dict[str, Any], cfg: cnn.CNNConfig,
                          device="cuda") -> Dict[str, Any]:
    """The JAX CNN tree (``conv{i}/{w,b}``, ``fc{i}/{w,b}``: nested dicts of
    numpy arrays, HWIO kernels and ``(in, out)`` FC weights) as the port's
    parameters on ``device``, array for array. Raises unless every leaf
    has the shape ``cfg`` gives it."""
    dev = device_lib.resolve(device)
    want = cnn.param_shapes(cfg)
    got = {g: {k: tuple(v.shape) for k, v in leaves.items()}
           for g, leaves in tree.items()}
    if got != want:
        raise ValueError(f"{cfg.name}: parameter shapes {got} != {want}")
    return {g: {k: _to_tensor(v, dev) for k, v in leaves.items()}
            for g, leaves in tree.items()}


def ternary_from_numpy(q: np.ndarray, scale: np.ndarray,
                       device="cuda") -> TernaryWeight:
    """A JAX ``TernaryWeight``'s ``(q, scale)`` arrays as the port's."""
    dev = device_lib.resolve(device)
    if q.dtype != np.int8 or scale.shape != q.shape[-1:]:
        raise ValueError(f"ternary weight: q {q.dtype} {q.shape}, scale "
                         f"{scale.shape}")
    return TernaryWeight(q=_to_tensor(q, dev),
                         scale=_to_tensor(scale, dev).float())


def config_from_dict(d: Dict[str, Any]) -> LMConfig:
    """The port's ``LMConfig`` from ``dataclasses.asdict`` of a JAX one.
    TPU-only knobs are dropped; ``mrope_sections``, ``vision_tokens``,
    ``moe_cfg`` and ``ssd_cfg`` (as the port's ``MoEConfig`` and
    ``SSDConfig``) and ``moe_group_size`` are carried."""
    fields = {f.name for f in dataclasses.fields(LMConfig)}
    unknown = set(d) - fields - _TPU_ONLY_FIELDS
    if unknown:
        raise ValueError(f"unknown LMConfig fields {sorted(unknown)}")
    kw = {k: v for k, v in d.items() if k in fields}
    kw["pattern"] = tuple(BlockSpec(**s) for s in d["pattern"])
    kw["tail"] = tuple(BlockSpec(**s) for s in d.get("tail", ()))
    if "quant" in d:
        kw["quant"] = QuantPolicy(**d["quant"])
    if d.get("moe_cfg") is not None:
        kw["moe_cfg"] = MoEConfig(**d["moe_cfg"])
    if d.get("ssd_cfg") is not None:
        kw["ssd_cfg"] = SSDConfig(**d["ssd_cfg"])
    return LMConfig(**kw)


def _shapes(tree) -> Dict[str, Any]:
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


def encdec_params_from_numpy(tree: Dict[str, Any], cfg: encdec.EncDecConfig,
                             device="cuda") -> Dict[str, Any]:
    """The JAX encoder-decoder tree (``embed``, ``pos_dec``, ``enc`` and
    ``dec`` stacked over their layers, ``norm_enc``, ``norm_dec``: nested
    dicts of numpy arrays) as the port's parameters on ``device``, array
    by array. Raises unless every leaf has the shape ``cfg`` gives it
    (``init_encdec`` on the meta device), the two depths included."""
    want = _shapes(encdec.init_encdec(cfg, device="meta"))
    got = _shapes(tree)
    if got != want:
        raise ValueError(f"{cfg.name}: parameter shapes {got} != {want}")
    dev = device_lib.resolve(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return _to_tensor(t, dev)

    return walk(tree)


def encdec_config_from_dict(d: Dict[str, Any]) -> encdec.EncDecConfig:
    """The port's ``EncDecConfig`` from ``dataclasses.asdict`` of a JAX one,
    every field carried (``sp_attention`` too)."""
    fields = {f.name for f in dataclasses.fields(encdec.EncDecConfig)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"unknown EncDecConfig fields {sorted(unknown)}")
    return encdec.EncDecConfig(**d)
