"""Training loop (mirror of ``repro.train.loop``): the step
(``make_train_step``, with gradient accumulation) and the ``Trainer``, the
host-loop correctness oracle of the fused ``TrainEngine``.

The Trainer wires together every fault-tolerance feature:
  * CheckpointManager (atomic/async/keep-k) with auto-resume-latest,
  * data-pipeline state in the checkpoint manifest (exact stream replay),
  * heartbeat + straggler detection hooks (``train.ft``),
  * SIGTERM-preemption -> synchronous final checkpoint,
  * CarbonAccountant observation per step.

Each step waits for the device to finish it (the reference's
``jax.block_until_ready`` on the loss): one sync per step, no host copy;
metrics become floats only on log steps. That per-step sync is the
Trainer's design, and what the fused engine's tick removes. There is no
``jit``: the step runs eagerly, updating params and state in place.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.core import accounting
from repro_torch.models.common import flatten
from repro_torch.optim import AdamWConfig, apply_updates, init_opt_state
from repro_torch.train import ft as ft_lib

PyTree = Any
LossFn = Callable[[PyTree, Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, Dict]]


@dataclasses.dataclass
class TrainConfig:
    num_steps: int = 100
    grad_accum: int = 1
    log_every: int = 10
    checkpoint_every: int = 100
    seed: int = 0


def value_and_grad(loss_fn: LossFn, params: PyTree,
                   batch: Dict[str, torch.Tensor]):
    """(loss, aux, grads): the loss and its aux dict with the gradient of
    the loss with respect to every leaf of ``params`` (which must require
    grad), in the params' tree layout."""
    leaves, rebuild = flatten(params)
    with torch.enable_grad():
        loss, aux = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), aux, rebuild(list(grads))


def make_train_step(loss_fn: LossFn, opt_cfg: AdamWConfig,
                    grad_accum: int = 1) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), with
    params and opt_state updated in place.

    With grad_accum > 1 the batch's leading dim must be grad_accum * mb;
    the microbatches' fp32 gradients are summed and averaged, as the
    reference's scan does.
    """

    def step(params, opt_state, batch):
        if grad_accum == 1:
            loss, aux, grads = value_and_grad(loss_fn, params, batch)
        else:
            micro = {k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                                  *v.shape[1:]) for k, v in batch.items()}
            acc, loss_sum = None, 0.0
            for i in range(grad_accum):
                loss_i, _aux, g = value_and_grad(
                    loss_fn, params, {k: v[i] for k, v in micro.items()})
                g_leaves, rebuild = flatten(g)
                g32 = [x.float() for x in g_leaves]
                acc = g32 if acc is None else [a + x for a, x in
                                               zip(acc, g32)]
                loss_sum = loss_sum + loss_i
            grads = rebuild([a / grad_accum for a in acc])
            loss = loss_sum / grad_accum
            aux = {}
        params, opt_state, opt_metrics = apply_updates(params, grads,
                                                       opt_state, opt_cfg)
        metrics = {"loss": loss, **opt_metrics}
        if isinstance(aux, dict):
            metrics.update({k: v.detach() for k, v in aux.items()
                            if torch.is_tensor(v) and v.dim() == 0})
        return params, opt_state, metrics

    return step


def _requires_grad(params: PyTree) -> torch.device:
    """Every leaf requires grad (``value_and_grad`` differentiates them);
    returns their device."""
    leaves, _ = flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    return leaves[0].device


class Trainer:
    """The reference's ``jit_kwargs`` and ``TrainConfig.donate`` have no
    counterpart: the step runs eagerly and updates params and optimizer
    state in place. ``_step_fn`` is the step callable, an attribute a
    caller may wrap (as the reference's tests wrap ``_jit_step``)."""

    def __init__(self, *, loss_fn: LossFn, params: PyTree,
                 opt_cfg: AdamWConfig, train_cfg: TrainConfig,
                 pipeline, ckpt_cfg: Optional[CheckpointConfig] = None,
                 accountant: Optional[accounting.CarbonAccountant] = None,
                 heartbeat: Optional[ft_lib.HeartbeatWriter] = None):
        self.loss_fn = loss_fn
        self.params = params
        self.device = _requires_grad(params)
        self.opt_cfg = opt_cfg
        self.cfg = train_cfg
        self.pipeline = pipeline
        self.opt_state = init_opt_state(params, opt_cfg)
        self.accountant = accountant
        self.heartbeat = heartbeat
        self.ckpt = CheckpointManager(ckpt_cfg) if ckpt_cfg else None
        self.step_num = 0
        self.metrics_log: list = []
        self._preempted = False
        self._step_fn = make_train_step(loss_fn, opt_cfg, train_cfg.grad_accum)

    # -- FT ---------------------------------------------------------------------

    def install_preemption_handler(self) -> None:
        def _handler(signum, frame):
            self._preempted = True
        try:
            signal.signal(signal.SIGTERM, _handler)
        except ValueError:
            pass  # not on main thread (tests) — caller sets _preempted directly

    def maybe_restore(self) -> bool:
        """Restore params, optimizer state, step and the pipeline's state
        from the latest checkpoint, onto the params' device; False when
        there is none."""
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return False
        tree = {"params": self.params, "opt": self.opt_state}
        step, restored, extra = self.ckpt.restore(target=tree,
                                                  device=self.device)
        self.params, self.opt_state = restored["params"], restored["opt"]
        _requires_grad(self.params)
        self.step_num = step
        if "data_state" in extra:
            self.pipeline.restore(extra["data_state"])
        return True

    def save(self, wait: bool = False) -> None:
        if self.ckpt is None:
            return
        self.ckpt.save(self.step_num,
                       {"params": self.params, "opt": self.opt_state},
                       extra={"data_state": self.pipeline.state})
        if wait:
            self.ckpt.wait()

    # -- loop ---------------------------------------------------------------------

    def _sync(self) -> None:
        """Wait until the device has run everything queued so far (the
        step's loss included); a no-op on the CPU."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def run(self, num_steps: Optional[int] = None) -> Dict[str, float]:
        n = num_steps or self.cfg.num_steps
        target = self.step_num + n
        last_metrics: Dict[str, float] = {}
        while self.step_num < target and not self._preempted:
            batch_np = self.pipeline.batch_at(self.step_num)
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in batch_np.items()}
            t0 = time.monotonic()
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch)
            self._sync()
            dt = time.monotonic() - t0
            self.step_num += 1
            self.pipeline.restore({"step": self.step_num})
            if self.accountant is not None:
                n_tokens = float(np.prod(batch_np["tokens"].shape)) \
                    if "tokens" in batch_np else 0.0
                self.accountant.observe_step(dt, n_tokens)
            if self.heartbeat is not None:
                self.heartbeat.beat(self.step_num, dt)
            if self.step_num % self.cfg.log_every == 0 or self.step_num == target:
                last_metrics = {k: float(v) for k, v in metrics.items()}
                last_metrics["step_time_s"] = dt
                self.metrics_log.append({"step": self.step_num, **last_metrics})
            if self.ckpt and self.step_num % self.cfg.checkpoint_every == 0:
                self.save()
        if self._preempted:
            self.save(wait=True)   # preemption: synchronous final checkpoint
        if self.ckpt:
            self.ckpt.wait()
        return last_metrics
