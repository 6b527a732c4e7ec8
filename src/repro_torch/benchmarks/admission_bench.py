"""Admission-path kernel timings of the PyTorch port on the card, for a
before/after comparison of two checkouts: K4 (``int8_matmul``, bf16 x) at
chip_smoke.py's speculative-tick (M = 40) and extend-call (M = 2048)
shapes, and K3 (``paged_prefill_attention``) in every mode and window at
chip_smoke.py's prefill shapes.

    PYTHONPATH=src python src/repro_torch/benchmarks/admission_bench.py
    PYTHONPATH=<older checkout>/src \\
        python src/repro_torch/benchmarks/admission_bench.py

The measurement is chip_smoke.py's own, loaded from the checkout this file
lies in: its ``phase_device`` (the card's name and power limit, TF32 off),
its K4 rows (``_k4_row``: the kernel against its plain version, its time
with every call on a cold weight copy, the plain version's, cuBLAS on the
dequantized weight, the bound) and its K3 check (``phase_prefill_kernel``).
Those call only the kernels' public wrappers, so the second command times
an older checkout's kernels on the same inputs. Prints JSON lines. Needs a
card.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

# chip_smoke.py's K4 rows this bench times (M of its (M, K, N) shapes)
K4_ROWS = (40, 2048)


def _chip_smoke():
    """chip_smoke.py of the checkout this file lies in, as a module."""
    path = Path(__file__).resolve().parents[3] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("admission_bench: needs a CUDA device")
    cs = _chip_smoke()
    cs.phase_device()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 4)
    for m, k, n, x_name, out_name in cs.K4_SHAPES:
        if m in K4_ROWS and x_name == out_name == "bfloat16":
            cs.emit(cs._k4_row(gen, m, k, n, x_name, out_name))
    cs.phase_prefill_kernel()


if __name__ == "__main__":
    main()
