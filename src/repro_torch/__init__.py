"""PyTorch/CUDA port of the serving stack, for one NVIDIA H100 (Hopper).

Mirrors ``repro``'s module paths (``configs``, ``models``, ``kernels``,
``serve``, ``core``, ``launch``) and imports nothing of it: the JAX package
is the reference this port is tested against. Entry points run on the card
unless the caller passes ``device="cpu"`` (see :mod:`repro_torch.device`).
"""
