"""Device-resident training engine of the PyTorch port (mirror of
``repro.train.engine``).

One **train tick** runs ``steps_per_tick`` optimizer steps: forward,
backward (through K6-K8 on the card when attention takes the flash route)
and the AdamW update, each step's ``[loss, grad_norm, lr]`` stacked on the
device. Params and optimizer state are updated in place and never leave
the device (the counterpart of the JAX tick donating them); nothing inside
a tick reads a value back to the host. The host stages the next tick's
batch block while the device runs (pinned memory, asynchronous copy), and
reads back ONE ``(k, 3)`` metrics block per tick, counted in
``host_readbacks``.

The JAX tick is one jitted ``lax.scan``; here the k steps are a Python loop
of eager launches (a captured CUDA graph is later speed work). The
reference's ``use_flash_vjp`` switch has no counterpart: the flash route
is chosen by the model's own eligibility (``transformer.forward`` with
``positions=None``), the kernels on the card and their plain versions on
the CPU, and no switch turns a kernel off on the card.

Every tick produces a :class:`TrainStepMetrics` billed to the
``CarbonAccountant``'s training ledger, forward and backward in separate
phase accounts (``models/costing.py`` is the shared cost model).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import accounting, energy
from repro_torch.models.common import flatten
from repro_torch.optim import AdamWConfig, apply_updates, init_opt_state
from repro_torch.train.loop import value_and_grad

PyTree = Any
LossFn = Callable[[PyTree, Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, Dict]]


@dataclasses.dataclass
class TrainEngineConfig:
    """The reference's ``donate`` and ``use_flash_vjp`` have no counterpart:
    params and state are always updated in place, and the attention route
    follows the model's own eligibility (the flash kernels on the card for
    ``positions=None``), with no switch that turns a kernel off."""
    # optimizer steps per tick: the metrics readback and the host's
    # bookkeeping amortize over this many steps
    steps_per_tick: int = 8


@dataclasses.dataclass
class TrainStepMetrics:
    """What one train tick did — the unit ``core/accounting.py`` bills.

    The modeled phase terms come from the engine's TrainStepCost (one
    step's cost scaled by ``steps``); forward and backward stay separate so
    the accountant can report per-phase energy.
    """
    steps: int                  # optimizer steps in this tick
    tokens: int                 # label tokens consumed
    samples: int                # sequences consumed
    wall_s: float               # host wall time of the tick (incl. staging)
    loss: float                 # last step's loss
    loss_mean: float            # mean loss over the tick
    grad_norm: float            # last step's global grad norm
    fwd_flops: float = 0.0
    bwd_flops: float = 0.0
    fwd_bytes: float = 0.0
    bwd_bytes: float = 0.0
    opt_bytes: float = 0.0

    @property
    def flops(self) -> float:
        return self.fwd_flops + self.bwd_flops

    @property
    def bytes_moved(self) -> float:
        return self.fwd_bytes + self.bwd_bytes + self.opt_bytes


# TrainStepMetrics fields that are deliberately NOT energy channels:
# training-quality telemetry with no joule interpretation. Everything else
# is billed in CarbonAccountant.observe_train.
TRAIN_ACCOUNTING_EXEMPT = frozenset({"loss", "loss_mean", "grad_norm"})


class TrainEngine:
    def __init__(self, *, loss_fn: LossFn, params: PyTree,
                 opt_cfg: AdamWConfig,
                 engine_cfg: Optional[TrainEngineConfig] = None,
                 pipeline=None,
                 accountant: Optional[accounting.CarbonAccountant] = None,
                 cost: Optional[energy.TrainStepCost] = None):
        self.loss_fn = loss_fn
        self.params = params
        self.opt_cfg = opt_cfg
        self.cfg = engine_cfg or TrainEngineConfig()
        self.pipeline = pipeline
        self.accountant = accountant
        self.cost = cost
        leaves, _ = flatten(params)
        for p in leaves:
            p.requires_grad_(True)
        self.device = leaves[0].device
        self.opt_state = init_opt_state(params, opt_cfg)
        self.step_num = 0
        self.last_metrics: Optional[TrainStepMetrics] = None
        self.metrics_log: List[TrainStepMetrics] = []
        # each tick's (k, 3) [loss, grad_norm, lr] block, as read back
        self.step_log: List[np.ndarray] = []
        # one host readback per tick (tests and chip_smoke.py assert it)
        self.host_readbacks = 0

    @classmethod
    def for_lm(cls, params: PyTree, cfg, *, opt_cfg: AdamWConfig,
               pipeline, engine_cfg: Optional[TrainEngineConfig] = None,
               accountant: Optional[accounting.CarbonAccountant] = None
               ) -> "TrainEngine":
        """LM-aware constructor: builds the loss closure and derives the
        per-step cost model from the live param and opt-state trees."""
        from repro_torch.models import costing
        from repro_torch.models import transformer as tf_lib

        def loss_fn(p, batch):
            return tf_lib.loss_fn(p, cfg, batch)

        eng = cls(loss_fn=loss_fn, params=params, opt_cfg=opt_cfg,
                  engine_cfg=engine_cfg, pipeline=pipeline,
                  accountant=accountant)
        if pipeline is not None:
            eng.cost = costing.lm_train_step_cost(
                params, cfg, batch=pipeline.cfg.local_batch,
                seq_len=pipeline.cfg.seq_len, opt_state=eng.opt_state)
        return eng

    # -- device path ------------------------------------------------------------

    def _tick(self, block: Dict[str, torch.Tensor], k: int) -> torch.Tensor:
        """k optimizer steps on the device; returns the (k, 3) block of
        each step's [loss, grad_norm, lr], still on the device."""
        rows = []
        for i in range(k):
            batch = {key: v[i] for key, v in block.items()}
            loss, _, grads = value_and_grad(self.loss_fn, self.params, batch)
            _, _, om = apply_updates(self.params, grads, self.opt_state,
                                     self.opt_cfg)
            del grads
            rows.append(torch.stack([loss, om["grad_norm"], om["lr"]]))
        return torch.stack(rows)

    # -- host loop ----------------------------------------------------------------

    def _stage(self, start: int, k: int
               ) -> Tuple[Dict[str, torch.Tensor], int, int]:
        """Stack pipeline batches [start, start+k) into one (k, ...) block
        on the device; the copy to a card is asynchronous from pinned
        memory."""
        batches = [self.pipeline.batch_at(start + i) for i in range(k)]
        block = {}
        for key in batches[0]:
            host = torch.from_numpy(np.stack([b[key] for b in batches]))
            if self.device.type == "cuda":
                block[key] = host.pin_memory().to(self.device,
                                                  non_blocking=True)
            else:
                block[key] = host
        tok = batches[0].get("labels", batches[0].get("tokens"))
        return block, k * int(tok.size), k * int(tok.shape[0])

    def run(self, num_steps: int) -> Dict[str, float]:
        """Run ``num_steps`` optimizer steps in ticks of ``steps_per_tick``.

        Staging is double-buffered: tick i+1's batch block is synthesized
        and staged while the device still runs tick i (the launches return
        before the device finishes); the metrics readback is the only sync
        point of a tick, after the staging.
        """
        assert self.pipeline is not None, "run() needs a pipeline"
        if num_steps <= 0:
            return {}
        plan: List[int] = []
        left = num_steps
        while left > 0:
            k = min(self.cfg.steps_per_tick, left)
            plan.append(k)
            left -= k
        last: Dict[str, float] = {}
        t_prev = time.monotonic()
        staged = self._stage(self.step_num, plan[0])
        for i, k in enumerate(plan):
            block, tokens, samples = staged
            ms = self._tick(block, k)
            if i + 1 < len(plan):   # overlap: stage while the device runs
                staged = self._stage(self.step_num + k, plan[i + 1])
            ms_host = ms.cpu().numpy()      # the ONE per-tick readback
            self.host_readbacks += 1
            now = time.monotonic()
            wall = now - t_prev
            t_prev = now
            self.step_num += k
            self.pipeline.restore({"step": self.step_num})
            c = (self.cost.scaled(k) if self.cost is not None
                 else energy.TrainStepCost(0.0, 0.0, 0.0, 0.0))
            m = TrainStepMetrics(
                steps=k, tokens=tokens, samples=samples, wall_s=wall,
                loss=float(ms_host[-1, 0]),
                loss_mean=float(np.mean(ms_host[:, 0])),
                grad_norm=float(ms_host[-1, 1]),
                fwd_flops=c.fwd_flops, bwd_flops=c.bwd_flops,
                fwd_bytes=c.fwd_bytes, bwd_bytes=c.bwd_bytes,
                opt_bytes=c.opt_bytes)
            self.last_metrics = m
            self.metrics_log.append(m)
            self.step_log.append(ms_host)
            if self.accountant is not None:
                self.accountant.observe_train(m)
            last = {"loss": m.loss, "grad_norm": m.grad_norm,
                    "lr": float(ms_host[-1, 2]),
                    "step": float(self.step_num)}
        return last

    # -- aggregate metrics ----------------------------------------------------

    def summary(self) -> Dict[str, float]:
        steps = sum(m.steps for m in self.metrics_log)
        wall = sum(m.wall_s for m in self.metrics_log)
        return {"ticks": len(self.metrics_log),
                "steps": steps,
                "tokens": sum(m.tokens for m in self.metrics_log),
                "wall_s": wall,
                "steps_per_s": steps / wall if wall > 0 else 0.0,
                "s_per_step": wall / steps if steps else 0.0}
