"""Distribution layer of the PyTorch port (mirror of ``repro.parallel``):
mesh descriptions, sharding rules, the activation-sharding context, int8
gradient compression and GPipe, on ``torch.distributed``."""

from repro_torch.parallel import sharding  # noqa: F401
