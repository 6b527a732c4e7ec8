"""Quantizers of the PyTorch port (mirror of ``repro.quant``)."""
