"""Optimizer and learning-rate schedules of the PyTorch port (mirror of
``repro.optim``)."""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, apply_updates, clip_by_global_norm, global_norm,
    init_opt_state,
)
from repro_torch.optim import schedules  # noqa: F401
