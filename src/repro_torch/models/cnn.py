"""The paper's own CNN benchmarks, AlexNet and VGG-16 (port of
``repro.models.cnn``).

These are the workloads behind Table 3 / Fig. 2: ternary-quantized
inference (the PIM execution model) and FP32 training. The parameters keep
the reference's layout, so ``bridge.cnn_params_from_numpy`` maps one onto
the other array by array: NHWC images, HWIO conv kernels (``conv{i}/w``),
``(in, out)`` FC weights (``fc{i}/w``), and ``fc0``'s rows in the (H, W, C)
order of the reference's flatten. The convolutions, ReLU and max-pooling
are plain torch (XLA's work in the reference); they run NCHW inside
``forward``, which permutes back to NHWC before the flatten. FC layers go
through ``matmul_fn`` when one is given: the ternary route passes
``kernels.ops.ternary_matmul`` (K11) for ``TernaryWeight`` leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import device as device_lib
from repro_torch.models import common


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    features: int
    kernel: int
    stride: int = 1
    padding: str = "SAME"
    pool: int = 0          # maxpool window (0 = none)
    pool_stride: int = 0


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    convs: Tuple[ConvSpec, ...]
    fcs: Tuple[int, ...]
    num_classes: int = 1000
    image_size: int = 224
    in_channels: int = 3
    dropout: float = 0.5   # inference path ignores; train uses a generator


ALEXNET = CNNConfig(
    name="alexnet",
    convs=(
        ConvSpec(64, 11, 4, "SAME", pool=3, pool_stride=2),
        ConvSpec(192, 5, 1, "SAME", pool=3, pool_stride=2),
        ConvSpec(384, 3), ConvSpec(256, 3),
        ConvSpec(256, 3, pool=3, pool_stride=2),
    ),
    fcs=(4096, 4096),
)

VGG16 = CNNConfig(
    name="vgg16",
    convs=(
        ConvSpec(64, 3), ConvSpec(64, 3, pool=2, pool_stride=2),
        ConvSpec(128, 3), ConvSpec(128, 3, pool=2, pool_stride=2),
        ConvSpec(256, 3), ConvSpec(256, 3), ConvSpec(256, 3, pool=2, pool_stride=2),
        ConvSpec(512, 3), ConvSpec(512, 3), ConvSpec(512, 3, pool=2, pool_stride=2),
        ConvSpec(512, 3), ConvSpec(512, 3), ConvSpec(512, 3, pool=2, pool_stride=2),
    ),
    fcs=(4096, 4096),
)


def _fc_dims(cfg: CNNConfig) -> Tuple[int, ...]:
    """(flatten size, *fcs, num_classes), running the shapes forward."""
    hw = cfg.image_size
    for cs in cfg.convs:
        hw = -(-hw // cs.stride)
        if cs.pool:
            hw = max((hw - cs.pool) // cs.pool_stride + 1, 1)
    flat = hw * hw * cfg.convs[-1].features
    return (flat,) + tuple(cfg.fcs) + (cfg.num_classes,)


def param_shapes(cfg: CNNConfig) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """The shape of every leaf, in ``init_cnn``'s order."""
    shapes: Dict[str, Dict[str, Tuple[int, ...]]] = {}
    c_in = cfg.in_channels
    for i, cs in enumerate(cfg.convs):
        shapes[f"conv{i}"] = {"w": (cs.kernel, cs.kernel, c_in, cs.features),
                              "b": (cs.features,)}
        c_in = cs.features
    dims = _fc_dims(cfg)
    for i in range(len(dims) - 1):
        shapes[f"fc{i}"] = {"w": (dims[i], dims[i + 1]), "b": (dims[i + 1],)}
    return shapes


def init_cnn(cfg: CNNConfig, *, seed: int = 0, device="cuda",
             dtype=torch.float32) -> Dict[str, Dict[str, torch.Tensor]]:
    """Random weights from ``seed`` in the reference's layout: fan-in
    truncated normals (a conv's fan-in is kh * kw * c_in), zero biases. The
    draws are torch's, not ``jax.random``'s."""
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, leaf in param_shapes(cfg).items():
        w = leaf["w"]
        fan_in = w[0] * w[1] * w[2] if len(w) == 4 else w[0]
        params[name] = {
            "w": common.fan_in_init(w, fan_in, generator=gen, device=dev,
                                    dtype=dtype),
            "b": torch.zeros(leaf["b"], dtype=dtype, device=dev)}
    return params


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial axis as (low, high): the output is
    ceil(size / stride) and the odd pixel of the total goes high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _conv_block(p, cs: ConvSpec, x: torch.Tensor) -> torch.Tensor:
    """x: (B, C, H, W) -> (B, features, H', W'); p["w"] is HWIO."""
    if cs.padding != "SAME":
        raise NotImplementedError(f"padding {cs.padding!r}: every config "
                                  f"of the reference pads SAME")
    w = p["w"].to(x.dtype).permute(3, 2, 0, 1)          # OIHW
    ph = same_pads(x.shape[2], cs.kernel, cs.stride)
    pw = same_pads(x.shape[3], cs.kernel, cs.stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        # symmetric (every 3 x 3 stride-1 conv): no padded copy
        y = F.conv2d(x, w, stride=cs.stride, padding=(ph[0], pw[0]))
    else:
        y = F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w,
                     stride=cs.stride)
    y = F.relu(y + p["b"].to(y.dtype)[:, None, None])
    if cs.pool:
        y = F.max_pool2d(y, cs.pool, cs.pool_stride)
    return y


def forward(params, cfg: CNNConfig, images: torch.Tensor, *,
            train: bool = False, generator: Optional[torch.Generator] = None,
            matmul_fn: Optional[Callable] = None) -> torch.Tensor:
    """images: (B, H, W, C) -> logits (B, num_classes).

    ``matmul_fn(x, w) -> y`` overrides the FC matmuls (the quantized
    kernel path). Dropout applies only with ``train`` and a ``generator``:
    each unit is kept with probability 1 - dropout and scaled by
    1 / (1 - dropout).
    """
    mm = matmul_fn or (lambda a, w: a @ w.to(a.dtype))
    x = images.permute(0, 3, 1, 2)
    for i, cs in enumerate(cfg.convs):
        x = _conv_block(params[f"conv{i}"], cs, x)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # (H, W, C) order
    n_fc = len(cfg.fcs) + 1
    for i in range(n_fc):
        p = params[f"fc{i}"]
        x = mm(x, p["w"]) + p["b"].to(x.dtype)
        if i < n_fc - 1:
            x = F.relu(x)
            if train and generator is not None and cfg.dropout > 0:
                keep = torch.rand(x.shape, generator=generator,
                                  device=x.device) < 1 - cfg.dropout
                x = torch.where(keep, x / (1 - cfg.dropout),
                                torch.zeros_like(x))
    return x


def loss_fn(params, cfg: CNNConfig, batch: Dict[str, torch.Tensor],
            generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits = forward(params, cfg, batch["images"], train=True,
                     generator=generator)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[:, None])[:, 0]
    ce = torch.mean(logz - ll)
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return ce, {"ce": ce, "acc": acc}


def flops_per_image(cfg: CNNConfig) -> float:
    """Analytic MACs*2 per image (for GFLOPS-style throughput accounting)."""
    fl = 0.0
    hw = cfg.image_size
    c_in = cfg.in_channels
    for cs in cfg.convs:
        hw_out = -(-hw // cs.stride)
        fl += 2.0 * hw_out * hw_out * cs.kernel * cs.kernel * c_in * cs.features
        hw = hw_out
        if cs.pool:
            hw = max((hw - cs.pool) // cs.pool_stride + 1, 1)
        c_in = cs.features
    dims = _fc_dims(cfg)
    for i in range(len(dims) - 1):
        fl += 2.0 * dims[i] * dims[i + 1]
    return fl
