"""VGG-16 — the paper's second Table-3 benchmark (mirror of
``repro.configs.vgg16``)."""

import dataclasses

from repro_torch.configs.base import ArchSpec
from repro_torch.models import cnn


def make_config() -> cnn.CNNConfig:
    return cnn.VGG16


def make_smoke() -> cnn.CNNConfig:
    return dataclasses.replace(
        cnn.VGG16, name="vgg16-smoke", image_size=32,
        convs=cnn.VGG16.convs[:4], fcs=(64,), num_classes=10)


SPEC = ArchSpec(
    arch_id="vgg16", family="cnn", kind="cnn",
    make_config=make_config, make_smoke=make_smoke,
    params_nominal=138e6, long_context_ok=False,
    source="paper Table 3 / EF-Train [1] / FPIRM [19]",
    notes="paper-faithful FP32 training workload (GPU 848 GFLOPS / RM 81.95 "
          "/ FPGA 46.99)",
)
