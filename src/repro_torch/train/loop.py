"""Host-loop training step (mirror of ``repro.train.loop``'s
``TrainConfig`` and ``make_train_step``): the correctness oracle of the
fused ``TrainEngine``. The checkpointing ``Trainer`` with its
fault-tolerance hooks is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models.common import flatten
from repro_torch.optim import AdamWConfig, apply_updates

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
