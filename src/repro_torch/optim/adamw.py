"""AdamW with mixed precision and quantized optimizer-state options
(mirror of ``repro.optim.adamw``).

State layouts (``state_dtype``):
  * "fp32": fp32 m/v (+ an fp32 master copy when params are low-precision
    and ``use_master``);
  * "bf16": m/v stored in bf16, the update math in fp32;
  * "int8": m/v stored as int8 codes with one fp32 absmax scale per tensor
    (8-bit-Adam style).

The state mirrors the parameter tree (``{"m", "v", "step"}`` plus
``"master"``). Unlike the functional original, ``apply_updates`` writes the
new params, moments, master and step into the existing tensors under
``torch.no_grad()`` (the counterpart of the JAX tick donating them), and
the step, the learning rate and the clip factor stay on the device: a step
reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple, Union

import torch

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "fp32"        # "fp32" | "bf16" | "int8"
    use_master: bool = True          # keep an fp32 master for low-prec params

    def lr_at(self, step: torch.Tensor) -> torch.Tensor:
        """The learning rate at ``step`` as a 0-dim fp32 tensor on the
        step's device."""
        if callable(self.lr):
            return torch.as_tensor(self.lr(step), dtype=torch.float32,
                                   device=step.device)
        return torch.full((), self.lr, dtype=torch.float32,
                          device=step.device)


def _is_q(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "s"}


def _leaves(tree: PyTree) -> List:
    """Leaves in dict order; an int8 moment ``{"q", "s"}`` is one leaf."""
    if isinstance(tree, dict) and not _is_q(tree):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _map(fn, tree: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


# -- quantized moment storage --------------------------------------------------

def _q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-20) / 127.0
    return (torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8),
            scale)


def _store(x: torch.Tensor, mode: str):
    if mode == "fp32":
        return x.float()
    if mode == "bf16":
        return x.to(torch.bfloat16)
    q, s = _q8(x)
    return {"q": q, "s": s}


def _load(x, mode: str) -> torch.Tensor:
    """The moment in fp32: an fp32 moment is returned itself (updated in
    place), the others as a new fp32 tensor."""
    if mode == "int8":
        return x["q"].float() * x["s"]
    return x.float()


def _store_into(dst, x: torch.Tensor, mode: str) -> None:
    if mode == "int8":
        q, s = _q8(x)
        dst["q"].copy_(q)
        dst["s"].copy_(s)
    elif dst is not x:
        dst.copy_(x)


# -- state ---------------------------------------------------------------------

def init_opt_state(params: PyTree, cfg: AdamWConfig) -> Dict[str, PyTree]:
    def zeros(p):
        return _store(torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), cfg.state_dtype)

    leaves = _leaves(params)
    state: Dict[str, PyTree] = {
        "m": _map(zeros, params), "v": _map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=leaves[0].device)}
    if cfg.use_master and any(p.dtype != torch.float32 for p in leaves):
        state["master"] = _map(lambda p: p.detach().float().clone(), params)
    return state


def global_norm(tree: PyTree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in _leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _clip_factor(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads: PyTree, max_norm: float
                        ) -> Tuple[PyTree, torch.Tensor]:
    norm = global_norm(grads)
    factor = _clip_factor(norm, max_norm)
    return _map(lambda g: g.float() * factor, grads), norm


@torch.no_grad()
def apply_updates(params: PyTree, grads: PyTree, state: Dict[str, PyTree],
                  cfg: AdamWConfig) -> Tuple[PyTree, Dict[str, PyTree],
                                             Dict[str, torch.Tensor]]:
    """One AdamW step, written into ``params`` and ``state`` in place.
    Returns (params, state, {"grad_norm", "lr"}), the metrics as device
    scalars. The clip factor is applied leaf by leaf as each is updated, so
    no clipped copy of the whole gradient tree is made."""
    state["step"].add_(1)
    step = state["step"]
    lr = cfg.lr_at(step)
    gnorm = global_norm(grads)
    factor = _clip_factor(gnorm, cfg.grad_clip) if cfg.grad_clip > 0 \
        else None
    stepf = step.float()
    b1c = 1.0 - cfg.b1 ** stepf
    b2c = 1.0 - cfg.b2 ** stepf
    mode = cfg.state_dtype
    flat_p = _leaves(params)
    flat_master = _leaves(state.get("master", params))
    for p, master, g, m, v in zip(flat_p, flat_master, _leaves(grads),
                                  _leaves(state["m"]), _leaves(state["v"])):
        g32 = g.float() * factor if factor is not None else g.float()
        m32, v32 = _load(m, mode), _load(v, mode)
        m32.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
        v32.mul_(cfg.b2).addcmul_(g32, g32, value=1 - cfg.b2)
        _store_into(m, m32, mode)
        _store_into(v, v32, mode)
        # base - lr * (mhat / (sqrt(vhat) + eps) + wd * base)
        upd = (m32 / b1c).div_((v32 / b2c).sqrt_().add_(cfg.eps))
        del g32, m32, v32
        base = master if master.dtype == torch.float32 else master.float()
        upd.add_(base, alpha=cfg.weight_decay).mul_(lr)
        base.sub_(upd)
        if base is not p:
            p.copy_(base)
    return params, state, {"grad_norm": gnorm, "lr": lr}


def opt_state_axes(params_axes: PyTree, cfg: AdamWConfig) -> Dict[str, PyTree]:
    """Logical axes of ``init_opt_state``'s tree (adamw.py:150): the
    moments mirror the params (an int8 moment's scale is a scalar), the
    step is a scalar, and ``master`` mirrors the params whether or not the
    state has one, as in the reference."""
    def ax_state(ax):
        return {"q": ax, "s": ()} if cfg.state_dtype == "int8" else ax

    return {"m": _map(ax_state, params_axes), "v": _map(ax_state, params_axes),
            "step": (), "master": params_axes}
