"""AlexNet — the paper's own Table-3/Fig-2 benchmark (mirror of
``repro.configs.alexnet``). Ternary PIM inference + FP32 training
workloads."""

import dataclasses

from repro_torch.configs.base import ArchSpec
from repro_torch.models import cnn


def make_config() -> cnn.CNNConfig:
    return cnn.ALEXNET


def make_smoke() -> cnn.CNNConfig:
    return dataclasses.replace(
        cnn.ALEXNET, name="alexnet-smoke", image_size=32,
        convs=cnn.ALEXNET.convs[:2], fcs=(64,), num_classes=10)


SPEC = ArchSpec(
    arch_id="alexnet", family="cnn", kind="cnn",
    make_config=make_config, make_smoke=make_smoke,
    params_nominal=61e6, long_context_ok=False,
    source="paper Table 3 / ELP^2IM [20] / FPIRM [19]",
    notes="paper-faithful workload: ternary inference (84.8 FPS DDR3-PIM / "
          "490 FPS RM-PIM) and FP32 training",
)
