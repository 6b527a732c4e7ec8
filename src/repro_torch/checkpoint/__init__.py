"""Fault-tolerant checkpointing of the PyTorch port (mirror of
``repro.checkpoint``)."""

from repro_torch.checkpoint.manager import (CheckpointConfig,  # noqa: F401
                                            CheckpointManager, tree_checksum)
