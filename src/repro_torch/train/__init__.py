"""Training runtime of the PyTorch port (mirror of ``repro.train``): the
host-loop step builder and the fused TrainEngine. The checkpointing
``Trainer`` and its fault-tolerance hooks are not ported yet."""

from repro_torch.train.loop import TrainConfig, make_train_step  # noqa: F401
from repro_torch.train.engine import (TRAIN_ACCOUNTING_EXEMPT,  # noqa: F401
                                      TrainEngine, TrainEngineConfig,
                                      TrainStepMetrics)
