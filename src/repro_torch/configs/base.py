"""ArchSpec registry of the PyTorch port (mirror of ``repro.configs.base``).

The registry holds every arch of the JAX package's registry, and
``SHAPES`` the original's input-shape grid, which the cells of
``launch.cells`` and the dry-run of ``launch.dryrun`` build on:

  train_4k     seq 4096  x global_batch 256   (training step)
  prefill_32k  seq 32768 x global_batch 32    (inference prefill)
  decode_32k   seq 32768 x global_batch 128   (decode: 1 token, 32k KV)
  long_500k    seq 524288 x global_batch 1    (long-context decode; only
               for the sub-quadratic archs, ``long_context_ok``)
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


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

    @property
    def shapes(self) -> Tuple[str, ...]:
        base = ("train_4k", "prefill_32k", "decode_32k")
        return base + (("long_500k",) if self.long_context_ok else ())


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


def all_arch_ids(lm_only: bool = False) -> Tuple[str, ...]:
    """Sorted arch ids; ``lm_only`` keeps the LM and encoder-decoder archs
    (those with mesh cells)."""
    _load()
    return tuple(sorted(a for a, s in REGISTRY.items()
                        if not lm_only or s.kind in ("lm", "encdec")))


def get(arch_id: str) -> ArchSpec:
    _load()
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; the port has "
                       f"{sorted(REGISTRY)}")
    return REGISTRY[arch_id]
