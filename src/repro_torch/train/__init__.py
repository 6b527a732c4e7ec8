"""Training runtime of the PyTorch port (mirror of ``repro.train``): the
host-loop step (``make_train_step``), the checkpointing ``Trainer`` with its
fault-tolerance hooks (``train.ft``), and the fused TrainEngine."""

from repro_torch.train.loop import (TrainConfig, Trainer,  # noqa: F401
                                    make_train_step)
from repro_torch.train.engine import (TRAIN_ACCOUNTING_EXEMPT,  # noqa: F401
                                      TrainEngine, TrainEngineConfig,
                                      TrainStepMetrics)
