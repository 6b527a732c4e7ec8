"""Architecture registry of the PyTorch port: ``get(arch_id)`` -> ArchSpec."""

from repro_torch.configs.base import ArchSpec, REGISTRY, get  # noqa: F401
