"""Where K4's decode kernel spends its time on the card: ``int8_matmul.cu``
built again with one part of the decode kernel's step loop removed at a
time, each copy timed at a decode tick's four projections of starcoder2-7b
(bf16 x, M = 8; (K, N) of wq/wo, wk/wv, w_in and w_out) by device time
from torch.profiler, CUDA events beside, every call on its own cold weight
copy, beside the kernel as it stands. A copy's time is that of the kernel
without the part; its results are wrong by design and are not checked.

    PYTHONPATH=src python src/repro_torch/benchmarks/int8_decode_parts.py
    PYTHONPATH=<older checkout>/src \\
        python src/repro_torch/benchmarks/int8_decode_parts.py

The parts are those of the decode kernel the source on ``PYTHONPATH`` has
(``PARTS``, keyed on its kernel's name). For the split-K kernel that
streams the weight through shared memory by cp.async
(``int8_gemv_kernel``, the older one): ``no_widen`` (the codes' widening
to bf16), ``no_tile`` (the widened tile's shared-memory store and its
ldmatrix), ``no_mma`` (the products) and ``stream_only`` (all three: the
cp.async stream alone). For the kernel whose lanes load their own
fragments to registers (``int8_decode_kernel``): ``no_widen``, ``no_mma``,
``stream_only`` (both: the loads alone), ``stages_2`` (one step a warp in
flight, not two), ``out_of_step`` (each tile walks its band's rounds from
another start, so the blocks of a band no longer read the same k rows at
the same time), ``warps_4`` (blocks of 4 warps and 64-row rounds, 4 of
them an SM) and ``min_rounds_1`` (the planner's bands 1 round long at
least, not 4). The whole kernels among them
(``WHOLE``) are held against the plain version within chip_smoke.py's
tolerance before they are timed. The copies
are made by replacing lines of the source, and a line that is not there
exactly once stops the script. They build into
``build/int8_decode_parts/``, one nvcc each, all started together, and
launch through the checkout's own wrapper (``int8_matmul.int8_matmul``),
so each copy gets the launch its source expects. Needs a card and nvcc.
"""

from __future__ import annotations

import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels import int8_matmul as k4

# the split-K kernel's parts
_OLD_WIDEN = [("const uint2 w0 = widen4(c.x), w1 = widen4(c.y), w2 = "
               "widen4(c.z), w3 = widen4(c.w);",
               "const uint2 w0 = make_uint2(c.x, c.y), w1 = make_uint2(c.z, "
               "c.w), w2 = w0, w3 = w1;")]
_OLD_TILE = [("    st_dst[0] = make_uint4(w0.x, w0.y, w1.x, w1.y);\n"
              "    st_dst[1] = make_uint4(w2.x, w2.y, w3.x, w3.y);\n", ""),
             ("      asm volatile(\n"
              '          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 '
              '{%0, %1, %2, %3}, [%4];\\n"\n'
              '          : "=r"(b[2 * h][0]), "=r"(b[2 * h][1]), '
              '"=r"(b[2 * h + 1][0]),\n'
              '            "=r"(b[2 * h + 1][1])\n'
              '          : "r"(ld_base + h * 16 * 2));',
              "      b[2 * h][0] = h ? w2.x : w0.x;\n"
              "      b[2 * h][1] = h ? w2.y : w0.y;\n"
              "      b[2 * h + 1][0] = h ? w3.x : w1.x;\n"
              "      b[2 * h + 1][1] = h ? w3.y : w1.y;")]
_OLD_MMA = [("    for (int i = 0; i < 4; ++i) mma_bf16(acc[i], a, b[i]);",
             "    for (int i = 0; i < 4; ++i) acc[i][0] += __int_as_float("
             "(b[i][0] ^ b[i][1] ^ a[0]) & 0x007f007fu);")]
# the register-streaming kernel's
_NEW_WIDEN = [("        const uint2 lo = widen4(__byte_perm(w0[i], w1[i], "
               "sel));",
               "        const uint2 lo = make_uint2(__byte_perm(w0[i], w1[i], "
               "sel), w0[i]);"),
              ("        const uint2 hi = widen4(__byte_perm(w2[i], w3[i], "
               "sel));",
               "        const uint2 hi = make_uint2(__byte_perm(w2[i], w3[i], "
               "sel), w2[i]);")]
_NEW_MMA = [("        mma_bf16(acc[2 * i + h], a, s.b);",
             "        acc[2 * i + h][0] += __int_as_float((a[0] ^ a[1] ^ "
             "a[2] ^ a[3] ^ s.b[0]) & 0x007f007fu);")]
_STAGES = "constexpr int kDecStages = 3;"
_WARPS_4 = [("constexpr int kDecWarps = 8;", "constexpr int kDecWarps = 4;"),
            ("constexpr int kDecBlocksPerSm = 2;",
             "constexpr int kDecBlocksPerSm = 4;")]
_ROUND = ("    const int rr = r;                    // the tile's round: "
          "in step with the band's other tiles")

PARTS = {
    "int8_gemv_kernel": {
        "as_is": [],
        "no_widen": _OLD_WIDEN,
        "no_tile": _OLD_TILE,
        "no_mma": _OLD_MMA,
        "stream_only": _OLD_WIDEN + _OLD_TILE + _OLD_MMA,
    },
    "int8_decode_kernel": {
        "as_is": [],
        "no_widen": _NEW_WIDEN,
        "no_mma": _NEW_MMA,
        "stream_only": _NEW_WIDEN + _NEW_MMA,
        "stages_2": [(_STAGES, _STAGES.replace("3", "2"))],
        "out_of_step": [(_ROUND, "    const int rr = r_lo + (r - r_lo + 5 "
                                 "* ct) % (r_hi - r_lo);")],
        "warps_4": _WARPS_4,
        "min_rounds_1": [],
    },
}
# the parts that are whole kernels (a depth, a round order, a shape or a
# plan, not a part removed): checked against the plain version before they
# are timed, with the wrapper's planner set as the part needs
WHOLE = {"as_is": {}, "stages_2": {}, "out_of_step": {},
         "warps_4": {"DECODE_ROUND": 64, "DECODE_BLOCKS_PER_SM": 4},
         "min_rounds_1": {"DECODE_MIN_ROUNDS": 1}}
# (K, N) of a decode tick's projections: wq/wo, wk/wv, w_in, w_out
SHAPES = ((4608, 4608), (4608, 512), (4608, 18432), (18432, 4608))
M = 8


def _chip_smoke():
    """chip_smoke.py of the checkout this file lies in, as a module (its
    timers, cold-copy size and input maker)."""
    path = Path(__file__).resolve().parents[3] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _parts():
    src = (build.CSRC / "int8_matmul.cu").read_text()
    kernels = [name for name in PARTS if f"{name}(" in src]
    if len(kernels) != 1:
        raise SystemExit(f"int8_decode_parts: the source holds {kernels} of "
                         f"the decode kernels {list(PARTS)}, not one")
    return src, PARTS[kernels[0]]


def _build(out_dir: Path):
    """One shared library per part, all nvcc runs started together."""
    src, parts = _parts()
    procs = {}
    for name, edits in parts.items():
        text = src.replace('#include "hopper.cuh"',
                           f'#include "{build.CSRC / "hopper.cuh"}"')
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"int8_decode_parts: {name}: the source has "
                                 f"{old!r} {text.count(old)} times, not "
                                 f"once")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o",
             str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"int8_decode_parts: {name} did not build:\n"
                             f"{logs[name]}")
    return {name: out_dir / f"{name}.so" for name in parts}, logs


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("int8_decode_parts: needs a CUDA device")
    cs = _chip_smoke()
    cs.phase_device()
    out_dir = build.BUILD_DIR.parent / "int8_decode_parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, logs = _build(out_dir)
    cs.emit({"phase": "int8_decode_parts", "src": str(build.CSRC),
             "ptxas": {name: [line.strip() for line in log.splitlines()
                              if "Compiling" in line or "registers" in line
                              or "spill" in line]
                       for name, log in logs.items()}})
    argtypes = k4._launcher().argtypes
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 4)
    real = k4._launcher
    for k, n in SHAPES:
        x, q, sc = cs._k4_inputs(gen, M, k, n, torch.bfloat16)
        qs = [q] + [q.clone() for _ in range(
            max(3, int(cs.K4_COLD_BYTES // q.numel())))]

        def call(i):
            return k4.int8_matmul(x, qs[i % len(qs)], sc)
        for name, lib in libs.items():
            fn = ctypes.CDLL(str(lib)).int8_matmul_launch
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            k4._launcher = lambda *_, fn=fn: fn
            plan = WHOLE.get(name, {})
            saved = {a: getattr(k4, a) for a in plan}
            for attr, value in plan.items():
                setattr(k4, attr, value)
            try:
                row = {"phase": "int8_decode_parts", "k": k, "n": n, "m": M,
                       "part": name}
                if name in WHOLE:
                    row["max_abs_err"] = cs._check_k4(x, q, sc,
                                                      torch.bfloat16)[1]
                row.update(device_ms=cs.device_ms(call, 24),
                           event_ms=cs.cuda_ms(call, 24))
                cs.emit(row)
            finally:
                k4._launcher = real
                for attr, value in saved.items():
                    setattr(k4, attr, value)
        del qs


if __name__ == "__main__":
    sys.exit(main())
