"""Decode-path attention timings of the PyTorch port on the card, for a
before/after comparison of two checkouts: K2 (``paged_decode_attention``)
and K5 (``paged_verify_attention``, T = 5 lanes) in every mode and window
at chip_smoke.py's shapes, and K1 (``decode_attention``) beside them, each
by device time, with K1's ptxas lines.

    PYTHONPATH=src python src/repro_torch/benchmarks/decode_bench.py
    PYTHONPATH=<older checkout>/src \\
        python src/repro_torch/benchmarks/decode_bench.py

The measurement is chip_smoke.py's own, loaded from the checkout this file
lies in: its ``phase_device`` (the card's name and power limit, TF32 off)
and its K1, K2 and K5 checks (``phase_decode_kernel``,
``phase_paged_decode_kernel``, ``check_verify_kernel``: each kernel against
its plain version, its device time with every call on a cold cache copy,
the plain version's, SDPA with the gather, the bound). Those call only the
kernels' public wrappers, so the second command times an older checkout's
kernels on the same inputs. ``--blocks-per-sm N`` sets K2's and K5's split
planner's aim (``SPLIT_BLOCKS_PER_SM``) for a tuning sweep. Prints JSON
lines. Needs a card.
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
                 "paged_verify_attention"])
    cs.emit({"phase": "checkout", "src": str(Path(build.__file__).parents[2]),
             "split_blocks_per_sm": getattr(k2, "SPLIT_BLOCKS_PER_SM", None),
             "decode_attention_ptxas": [
                 line.strip() for line in
                 build.build_log("decode_attention").splitlines()
                 if "ptxas info" in line]})
    cs.phase_decode_kernel()
    cs.phase_paged_decode_kernel()
    cs.check_verify_kernel(VERIFY_LANES)


if __name__ == "__main__":
    main()
