"""Serving stack of the PyTorch port (mirror of ``repro.serve``, dense and
paged paths, fp and int8, speculative decode, copy-on-write forks and tree
speculation on the paged path, the chaos tier: fault injection, quarantine
and the degradation ladder; the durability tier: the write-ahead journal,
snapshots and restore): the fused engine, its host-loop oracle, the
quality oracles, the scheduler, the page pool, the fault plans and guards,
and the speculative drafters and accept step."""

from repro_torch.serve.engine import (ACCOUNTING_EXEMPT, DeviceState,  # noqa: F401
                                      Request, ServeConfig, ServeEngine,
                                      StepMetrics)
from repro_torch.serve.faults import (FAULT_KINDS,  # noqa: F401
                                      TRANSIENT_FAULT_KINDS, FaultEvent,
                                      FaultInjector, FaultPlan,
                                      GuardrailConfig, ProcessKilled)
from repro_torch.serve.snapshot import (Journal,  # noqa: F401
                                        check_fingerprint,
                                        config_fingerprint,
                                        host_state_dict,
                                        install_host_state,
                                        reconcile_ownership)
from repro_torch.serve.pages import (PagePool, block_tokens,  # noqa: F401
                                     fragmentation)
from repro_torch.serve.quality import (generation_agreement,  # noqa: F401
                                       run_workload, token_agreement)
from repro_torch.serve.reference import ReferenceEngine  # noqa: F401
from repro_torch.serve.scheduler import Scheduler, SchedulerConfig  # noqa: F401
from repro_torch.serve.spec import (DRAFTERS, ngram_draft,  # noqa: F401
                                    ngram_draft_tree, speculative_accept)
