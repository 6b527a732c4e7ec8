"""Sustainability engine of the PyTorch port: copies of ``repro.core``'s
hw, grid, lca, sustain, energy, roofline and accounting modules (the port
imports nothing of ``repro``), with ``hw.H100_SXM`` added."""
