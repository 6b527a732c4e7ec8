"""Serving stack of the PyTorch port (mirror of ``repro.serve``, dense and
paged paths): the fused engine, its host-loop oracle, the scheduler and the
page pool."""

from repro_torch.serve.engine import (ACCOUNTING_EXEMPT, DeviceState,  # noqa: F401
                                      Request, ServeConfig, ServeEngine,
                                      StepMetrics)
from repro_torch.serve.pages import (PagePool, block_tokens,  # noqa: F401
                                     fragmentation)
from repro_torch.serve.reference import ReferenceEngine  # noqa: F401
from repro_torch.serve.scheduler import Scheduler, SchedulerConfig  # noqa: F401
