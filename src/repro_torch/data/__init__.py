"""Data pipeline of the PyTorch port: a copy of ``repro.data.pipeline``
(numpy only), kept equal to it by ``tests/test_torch_copies.py``."""

from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig, TokenPipeline, make_pipeline,
)
