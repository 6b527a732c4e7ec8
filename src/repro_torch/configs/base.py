"""ArchSpec registry of the PyTorch port (mirror of ``repro.configs.base``).

The registry holds only the archs the port runs so far; the JAX package's
registry lists every assigned arch. The input-shape grid of the original
(``SHAPES``) drives the TPU dry-run cells and is not ported.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                       # dense|moe|ssm|hybrid|audio|vlm|cnn
    kind: str                         # "lm" | "encdec" | "cnn"
    make_config: Callable             # () -> LMConfig
    make_smoke: Callable              # () -> reduced config, same family
    params_nominal: float             # headline param count (B) from the pool
    long_context_ok: bool = False
    source: str = ""
    notes: str = ""
    active_fraction: float = 1.0


# archs ported so far; the rest of repro.configs follows the port's queue
_ARCH_MODULES = ["starcoder2_7b"]

REGISTRY: Dict[str, ArchSpec] = {}


def _load() -> None:
    if REGISTRY:
        return
    for mod_name in _ARCH_MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
        spec: ArchSpec = mod.SPEC
        REGISTRY[spec.arch_id] = spec


def get(arch_id: str) -> ArchSpec:
    _load()
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; the port has "
                       f"{sorted(REGISTRY)}")
    return REGISTRY[arch_id]
