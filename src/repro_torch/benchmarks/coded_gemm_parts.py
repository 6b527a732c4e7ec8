"""Where the coded GEMM (``csrc/coded_gemm.cuh``: K9, and K11 at M > 8)
spends its time on the card: the kernel built again with one part removed
or changed at a time, each copy timed at K11's AlexNet fc0 and fc2 (M =
64, fp32 and bf16 x) and K9's (4608, 4608) projection (M = 4096), by device
time from torch.profiler, every K11 call on its own cold copy of the codes,
beside the kernel as it stands. A copy's time is that of the kernel
without the part; its results are wrong by design and are not checked.

    PYTHONPATH=src python src/repro_torch/benchmarks/coded_gemm_parts.py

The parts (``PARTS``): ``no_widen`` (the codes stored as loaded, not
widened to bf16), ``tma_only`` (the codes land by TMA and are not widened
at all), ``no_mma`` (no products), ``one_plane`` (fp32 x's hi plane
alone: a third of the products), ``no_split`` (fp32 x's fragments packed
without the split), ``no_combine`` (split K's last block reads each
partial's first 16 bytes a thread, not all); ``boxes_4`` (K11's code
tile as four TMA boxes of 16 rows, not one of 64); and two bounds of the
stream: ``stream_only`` (the TMA loads and
the ring's barriers alone: no widening, fragments or products) and
``no_a`` (no activation tile loaded). The
copies are made by replacing lines of the header, and a line that is not
there exactly once stops the script. They build into
``build/coded_gemm_parts/``, one nvcc a source and part, all started
together, and launch through the checkout's own wrappers. Needs a card and
nvcc.
"""

from __future__ import annotations

import ctypes
import importlib.util
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels import int8_matmul as k9
from repro_torch.kernels import ternary_matmul as k11

_NO_WIDEN = [(
    "  const uint2 w0 = widen4(raw.x), w1 = widen4(raw.y);\n"
    "  const uint2 w2 = widen4(raw.z), w3 = widen4(raw.w);\n",
    "  const uint2 w0 = make_uint2(raw.x, raw.y), w1 = make_uint2(raw.z, "
    "raw.w);\n"
    "  const uint2 w2 = w1, w3 = w0;\n")]
PARTS = {
    "as_is": [],
    "no_widen": _NO_WIDEN,
    "tma_only": [("      if (q_tma) widen_code_tile<kKMajor>(bt, r_s + s * kRawBytes, "
                  "t);\n      else", "      if (!q_tma)")],
    "no_mma": [("          hopper::wgmma_rs_n128<kKMajor ? 0 : 1>(part, "
                "f[j][p], desc, (j | p) != 0);",
                "          part[(j * P + p) & 63] += __uint_as_float("
                "(f[j][p][0] ^ f[j][p][3] ^ (uint32_t)desc) & 0x007f007fu);")],
    "one_plane": [("        for (int p = 0; p < P; ++p)\n"
                   "          hopper::wgmma_rs_n128",
                   "        for (int p = 0; p < 1; ++p)\n"
                   "          hopper::wgmma_rs_n128")],
    "no_split": [("      hopper::bf16x3_split(v[e].x, h0, m0, l0);\n"
                  "      hopper::bf16x3_split(v[e].y, h1, m1, l1);\n",
                  "      h0 = m0 = l0 = __float_as_uint(v[e].x);\n"
                  "      h1 = m1 = l1 = __float_as_uint(v[e].y);\n")],
    "stream_only": [("      if (q_tma) widen_code_tile<kKMajor>(bt, r_s + s * kRawBytes, "
                     "t);\n      else", "      if (!q_tma)"),
                    ("    hopper::wgmma_wait<0>();\n    hopper::fence_regs(part);",
                     "    if (nt < 0) hopper::wgmma_wait<0>();\n"
                     "    hopper::fence_regs(part);"),
                    ("      a_fragments<P, kKMajor>(f[j], at, r0, 16 * j + 2 * t, "
                     "scale, kc0 + 16 * j + 2 * t, Kc);",
                     "      if (nt < 0) a_fragments<P, kKMajor>(f[j], at, r0, 16 * j "
                     "+ 2 * t, scale, kc0 + 16 * j + 2 * t, Kc);"),
                    ("      hopper::wgmma_fence();\n#pragma unroll\n      for (int j = 2 * h",
                     "      if (nt < 0) hopper::wgmma_fence();\n#pragma unroll\n"
                     "      for (int j = 2 * h"),
                    ("          hopper::wgmma_rs_n128<kKMajor ? 0 : 1>(part, "
                     "f[j][p], desc, (j | p) != 0);",
                     "          if (nt < 0) hopper::wgmma_rs_n128<kKMajor ? 0 : 1>("
                     "part, f[j][p], desc, (j | p) != 0);")],
    "no_a": [("        if (a_tma) {\n          hopper::tma_load_2d(at, &a_map, "
              "full + s, kc0, m0);",
              "        if (a_tma && nt < 0) {\n          hopper::tma_load_2d(at, "
              "&a_map, full + s, kc0, m0);"),
             ("        hopper::mbar_expect_tx(full + s, a_tma ? kA : 0);",
              "        hopper::mbar_expect_tx(full + s, 0);")],
    "boxes_4": [("          else hopper::tma_load_2d(rt, &q_map, loaded + s, n0, "
                 "kc0);",
                 "          else for (int b = 0; b < 4; ++b) hopper::tma_load_2d("
                 "rt + b * (kRawBytes / 4), &q_map, loaded + s, n0, kc0 + 16 * b);"),
                ("kBK, kBN, CU_TENSOR_MAP_SWIZZLE_NONE)))",
                 "kBK / 4, kBN, CU_TENSOR_MAP_SWIZZLE_NONE)))")],
    "no_combine": [("        const float4 v = __ldcg(rp + (e / 4) * kConsumers "
                    "+ tid);",
                    "        const float4 v = __ldcg(rp + tid);")],
}
# (M, K, N, x) of K11 and (M, K, N) of K9 timed for every part
K11_ROWS = ((64, 9216, 4096, "float32"), (64, 9216, 4096, "bfloat16"),
            (64, 4096, 1000, "float32"), (64, 4096, 1000, "bfloat16"))
K9_ROWS = ((4096, 4608, 4608),)
SOURCES = ("ternary_matmul", "int8_matmul")


def _chip_smoke():
    """chip_smoke.py of the checkout this file lies in, as a module."""
    path = Path(__file__).resolve().parents[3] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _build(out_dir: Path):
    """One library per (part, source), all nvcc runs started together."""
    header = (build.CSRC / "coded_gemm.cuh").read_text()
    procs = {}
    for name, edits in PARTS.items():
        text = header
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"coded_gemm_parts: {name}: the header has "
                                 f"{old!r} {text.count(old)} times, not once")
            text = text.replace(old, new)
        part_dir = out_dir / name
        part_dir.mkdir(parents=True, exist_ok=True)
        (part_dir / "coded_gemm.cuh").write_text(text)
        (part_dir / "hopper.cuh").write_text(
            (build.CSRC / "hopper.cuh").read_text())
        for src in SOURCES:
            cu = part_dir / f"{src}.cu"
            cu.write_text((build.CSRC / f"{src}.cu").read_text())
            procs[name, src] = subprocess.Popen(
                [build.nvcc(), *build.NVCC_FLAGS, "-o",
                 str(part_dir / f"{src}.so"), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for key, proc in procs.items():
        logs[key] = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"coded_gemm_parts: {key} did not build:\n"
                             f"{logs[key]}")
    return logs


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("coded_gemm_parts: needs a CUDA device")
    cs = _chip_smoke()
    cs.phase_device()
    out_dir = build.BUILD_DIR.parent / "coded_gemm_parts"
    logs = _build(out_dir)
    cs.emit({"phase": "coded_gemm_parts_build", "ptxas": {
        f"{name}/{src}": [line.strip() for line in log.splitlines()
                          if "coded_gemm" in line or "spill" in line
                          or "registers" in line]
        for (name, src), log in logs.items() if src == "ternary_matmul"}})
    from repro_torch.quant import ternary
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 23)
    k11_argtypes = k11._launcher().argtypes
    k9_argtypes = k9._launcher("int8_matmul_dx_launch").argtypes
    real11, real9 = k11._launcher, k9._launcher
    try:
        for m, k, n, x_name in K11_ROWS:
            x = torch.randn((m, k), generator=gen, device="cuda").to(
                getattr(torch, x_name))
            tw = ternary.ternarize(torch.randn((k, n), generator=gen,
                                               device="cuda"))
            qs = [tw.q] + [tw.q.clone() for _ in range(
                max(3, int(cs.K4_COLD_BYTES // tw.q.numel())))]
            row = {"phase": "coded_gemm_parts", "kernel": "K11", "m": m,
                   "k": k, "n": n, "x": x_name}
            for name in PARTS:
                fn = ctypes.CDLL(str(out_dir / name / "ternary_matmul.so")
                                 ).ternary_matmul_launch
                fn.argtypes, fn.restype = k11_argtypes, ctypes.c_int
                k11._launcher = lambda fn=fn: fn
                row[name] = cs.device_ms(lambda i: k11.ternary_matmul(
                    x, qs[i % len(qs)], tw.scale), 24)
            cs.emit(row)
        for m, k, n in K9_ROWS:
            dy, q, sc = cs._k9_inputs(gen, m, k, n)
            row = {"phase": "coded_gemm_parts", "kernel": "K9", "m": m,
                   "k": k, "n": n, "out": "float32"}
            for name in PARTS:
                fn = ctypes.CDLL(str(out_dir / name / "int8_matmul.so")
                                 ).int8_matmul_dx_launch
                fn.argtypes, fn.restype = k9_argtypes, ctypes.c_int
                k9._launcher = lambda *_, fn=fn: fn
                row[name] = cs.device_ms(lambda i: k9.int8_matmul_dx(
                    dy, q, sc, torch.float32), 4)
            cs.emit(row)
    finally:
        k11._launcher, k9._launcher = real11, real9


if __name__ == "__main__":
    main()
