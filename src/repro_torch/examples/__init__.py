"""Runnable examples of the PyTorch port (mirrors of the repository's
``examples/``): ``python -m repro_torch.examples.<name> --device cpu``."""
