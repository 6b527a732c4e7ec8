"""Kernels of the PyTorch port: hand-written CUDA for Hopper (``csrc/``),
their ctypes wrappers, plain PyTorch versions (``ref``) and the public
dispatch (``ops``), which picks by the tensors' device."""
