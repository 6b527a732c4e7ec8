"""Model code of the PyTorch port (mirror of ``repro.models``)."""
