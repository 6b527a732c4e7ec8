"""Serving stack of the PyTorch port (mirror of ``repro.serve``, dense
path): the fused engine, its host-loop oracle and the scheduler."""

from repro_torch.serve.engine import (ACCOUNTING_EXEMPT, DeviceState,  # noqa: F401
                                      Request, ServeConfig, ServeEngine,
                                      StepMetrics)
from repro_torch.serve.reference import ReferenceEngine  # noqa: F401
from repro_torch.serve.scheduler import Scheduler, SchedulerConfig  # noqa: F401
