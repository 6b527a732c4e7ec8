"""ArchSpec registry of the PyTorch port (mirror of ``repro.configs.base``).

The registry holds every arch of the JAX package's registry. The
input-shape grid of the original (``SHAPES``) drives the TPU dry-run
cells and is not ported.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, List


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                       # dense|moe|ssm|hybrid|audio|vlm|cnn
    kind: str                         # "lm" | "encdec" | "cnn"
    make_config: Callable             # () -> LMConfig / EncDecConfig / CNNConfig
    make_smoke: Callable              # () -> reduced config, same family
    params_nominal: float             # headline param count (B) from the pool
    long_context_ok: bool = False
    source: str = ""
    notes: str = ""
    active_fraction: float = 1.0


# every arch of repro.configs, in the reference's order: the dense and
# MoE families, the encoder-decoder, the SSD and hybrid family, the CNNs
_ARCH_MODULES = ["gemma3_27b", "starcoder2_7b", "granite_34b",
                 "qwen1_5_110b", "moonshot_v1_16b_a3b", "kimi_k2_1t_a32b",
                 "whisper_large_v3", "zamba2_7b", "qwen2_vl_72b",
                 "mamba2_1_3b", "alexnet", "vgg16"]

REGISTRY: Dict[str, ArchSpec] = {}


def _load() -> None:
    if REGISTRY:
        return
    for mod_name in _ARCH_MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
        spec: ArchSpec = mod.SPEC
        REGISTRY[spec.arch_id] = spec


def arch_ids() -> List[str]:
    """Every registered arch, in the reference's order."""
    _load()
    return list(REGISTRY)


def get(arch_id: str) -> ArchSpec:
    _load()
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; the port has "
                       f"{sorted(REGISTRY)}")
    return REGISTRY[arch_id]
