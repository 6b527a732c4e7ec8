"""Entry points of the PyTorch port (mirror of ``repro.launch``): the serve
and train launchers, the cells and the dry-run over a mesh."""
