"""Device selection for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``. Asking for
the card on a machine without one raises: the port never falls back to the
CPU on its own, so a number measured on the CPU cannot pass for a card's.
"""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; the port runs on "
                         f"'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        # name the card, so the device compares equal to a tensor's
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
