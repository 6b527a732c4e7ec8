"""Timings of the coded GEMM's two kernels on the card, for a before/after
comparison of two checkouts: K9 (``int8_matmul_dx``) at the training
projections' shapes and K11 (``ternary_matmul``) at the CNN workloads' FC
shapes, M = 1 and 64, with the ptxas lines of both sources.

    PYTHONPATH=src python src/repro_torch/benchmarks/coded_gemm_bench.py
    PYTHONPATH=<older checkout>/src \\
        python src/repro_torch/benchmarks/coded_gemm_bench.py --k11-only

The measurement is chip_smoke.py's own, loaded from the checkout this file
lies in: its ``phase_device`` (the card's name and power limit, TF32 off),
``phase_int8_dx`` and ``phase_ternary_matmul`` (each kernel against its
plain version, its time (K11 by device time, every call on a cold copy of
the codes), the plain version's, cuBLAS on the dequantized or widened
weight, and the bound). ``--k11-only`` runs K11's rows alone, through
``ternary_matmul`` and its plain version only, with no route or launch
checks, so that an older checkout's kernels time on the same inputs: run
parent, change, change, parent in one call for an A/B. Prints JSON lines.
Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
from pathlib import Path

import torch


def _chip_smoke():
    """chip_smoke.py of the checkout this file lies in, as a module."""
    path = Path(__file__).resolve().parents[3] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def k11_rows(cs) -> None:
    """chip_smoke.py's K11 rows (``K11_CASES``) through the public wrapper
    only: checked against the plain version, timed by device time on cold
    code copies, beside cuBLAS on the dequantized weight."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ternary_matmul as k11
    from repro_torch.quant import ternary
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 17)
    for m, k, n, x_name, codes in cs.K11_CASES:
        dt = getattr(torch, x_name)
        x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
        w = torch.randn((k, n), generator=gen, device="cuda")
        tw = (ternary.ternarize if codes == "ternary" else ternary.binarize)(w)
        got = k11.ternary_matmul(x, tw.q, tw.scale)
        want = ref.ternary_matmul_ref(x, tw.q, tw.scale)
        err = float((got.float() - want.float()).abs().max())
        qs = [tw.q] + [tw.q.clone() for _ in range(
            max(3, int(cs.K4_COLD_BYTES // tw.q.numel())))]
        ms = cs.device_ms(
            lambda i: k11.ternary_matmul(x, qs[i % len(qs)], tw.scale), 24)
        wd = [(c.float() * tw.scale).to(dt) for c in qs[:2]]
        lib = cs.device_ms(lambda i: x @ wd[i % len(wd)], 24)
        cs.emit({"phase": "k11_ab", "m": m, "k": k, "n": n, "x": x_name,
                 "codes": codes, "ms": ms, "library_ms": lib,
                 "max_abs_err": err,
                 "err_over_max": err / float(want.float().abs().max())})


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--k11-only", action="store_true",
                        help="K11's rows alone, no route or launch checks")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("coded_gemm_bench: needs a CUDA device")
    cs = _chip_smoke()
    from repro_torch.kernels import build
    cs.phase_device()
    names = ["ternary_matmul"] if args.k11_only \
        else ["int8_matmul", "ternary_matmul"]
    build.build(names)
    cs.emit({"phase": "checkout", "src": str(Path(build.__file__).parents[2]),
             **{f"{name}_ptxas": [
                 line.strip() for line in build.build_log(name).splitlines()
                 if "ptxas info" in line or "spill" in line
                 or "wgmma" in line]
                for name in names}})
    if args.k11_only:
        k11_rows(cs)
        return
    cs.phase_int8_dx()
    cs.phase_ternary_matmul()


if __name__ == "__main__":
    main()
