"""Entry points of the PyTorch port (mirror of ``repro.launch``)."""
