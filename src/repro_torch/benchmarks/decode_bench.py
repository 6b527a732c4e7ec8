"""Decode-path kernel timings of the PyTorch port on the card, for a
before/after comparison of two checkouts: K1 (``decode_attention``), K2
(``paged_decode_attention``) and K5 (``paged_verify_attention``, T = 5
lanes) in every mode and window at chip_smoke.py's shapes, and K4's decode
kernel (``int8_matmul``, bf16 x, M = 8) at a decode tick's four
projections, each by device time, with K1's and K4's ptxas lines.

    PYTHONPATH=src python src/repro_torch/benchmarks/decode_bench.py
    PYTHONPATH=<older checkout>/src \\
        python src/repro_torch/benchmarks/decode_bench.py

The measurement is chip_smoke.py's own, loaded from the checkout this file
lies in: its ``phase_device`` (the card's name and power limit, TF32 off)
and its K1, K2, K5 and K4 checks (``phase_decode_kernel``,
``phase_paged_decode_kernel``, ``check_verify_kernel``,
``phase_int8_decode``: each kernel against its plain version, its device
time with every call on a cold cache or weight copy, the plain version's,
SDPA with the gather or cuBLAS on the dequantized weight, the bound).
Those call only the kernels' public wrappers, so the second command times
an older checkout's kernels on the same inputs: run the two commands in
turn in one call (parent, change, change, parent) for an A/B.
``--blocks-per-sm N`` sets K2's and K5's split planner's aim
(``SPLIT_BLOCKS_PER_SM``) for a tuning sweep. Prints JSON lines. Needs a
card.
"""

from __future__ import annotations

import argparse
import importlib.util
from pathlib import Path

import torch

# K5's lanes in this bench: the spec serve runs' k = 4 drafts plus one
VERIFY_LANES = 5


def _chip_smoke():
    """chip_smoke.py of the checkout this file lies in, as a module."""
    path = Path(__file__).resolve().parents[3] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--blocks-per-sm", type=int, default=None,
                        help="the split planner's blocks an SM (K2, K5)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_bench: needs a CUDA device")
    cs = _chip_smoke()
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_decode_attention as k2
    if args.blocks_per_sm is not None:
        k2.SPLIT_BLOCKS_PER_SM = args.blocks_per_sm
    cs.phase_device()
    build.build(["decode_attention", "paged_decode_attention",
                 "paged_verify_attention", "int8_matmul"])
    cs.emit({"phase": "checkout", "src": str(Path(build.__file__).parents[2]),
             "split_blocks_per_sm": getattr(k2, "SPLIT_BLOCKS_PER_SM", None),
             **{f"{name}_ptxas": [
                 line.strip() for line in build.build_log(name).splitlines()
                 if "ptxas info" in line]
                for name in ("decode_attention", "int8_matmul")}})
    cs.phase_decode_kernel()
    cs.phase_paged_decode_kernel()
    cs.check_verify_kernel(VERIFY_LANES)
    cs.phase_int8_decode()


if __name__ == "__main__":
    main()
