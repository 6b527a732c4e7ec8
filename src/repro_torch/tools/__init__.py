"""Developer tools of the PyTorch port."""
