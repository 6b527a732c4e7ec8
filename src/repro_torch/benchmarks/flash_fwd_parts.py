"""Where the flash forward's time goes on the card: K6's kernels
(``csrc/flash_attention.cu``) built again with one part of a tile loop
removed at a time, each copy timed at the training path's shapes (B = 2, S
= 2048, H = 36, Hkv = 4, D = 128, causal, windows -1 and 256) by CUDA
events beside the kernels as they stand. A copy's time is that of the
kernel without the part; its results are wrong by design and are not
checked.

    PYTHONPATH=src python src/repro_torch/benchmarks/flash_fwd_parts.py

fp32 q, the 3xTF32 kernel (``flash_fwd_tc_kernel``): ``no_s`` (S = Q K^T's
wgmma, S taken as zeros), ``no_pv`` (P V's wgmma, its partial sums zeros),
``no_exp`` (the softmax's exp), ``fast_exp`` (``__expf`` for the softmax's
exp: a rate, not a part), ``no_fetch`` (the cp.async copies of the next
tile's planes), ``no_barrier`` (the barrier at the end of each tile) and
``split_only`` (the K/V split pre-pass alone). bf16 q, the bf16 kernel
(``flash_fwd_bf16_kernel``): ``bf16_no_s`` (S's wgmma), ``bf16_no_pv``
(P V's wgmma and its fma into O), ``bf16_no_exp``,
``bf16_no_fetch`` (the cp.async copies of the next K and V tiles) and
``bf16_no_barrier`` (the block's barrier at the start of each tile: its
warpgroup then reads tiles other threads' copies may not have filled).
``as_is`` is timed in both modes.

The copies are made by replacing lines of the source (``part_source``), and
a line that is not there exactly once stops the script. They build into
``build/flash_fwd_parts/``, one nvcc each, all started together. Needs a
card and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa

FP32, BF16 = ("float32",), ("bfloat16",)
# name -> (q dtypes it is timed at, [(line of the source, its replacement)])
PARTS = {
    "as_is": (FP32 + BF16, []),
    "no_s": (FP32, [("dots_wgmma_rs<D>(qa, q_lo, kb, kb + kPlane, s);",
                     "for (int x = 0; x < 16; ++x) "
                     "reinterpret_cast<float*>(s)[x] = 0.f;")]),
    "no_pv": (FP32, [("pv_wgmma<kPvN>(pf, vt + kPvN * c * kFwdKeys, "
                      "vt + kPlane + kPvN * c * kFwdKeys, part);",
                      "for (int x = 0; x < kPvN / 2; ++x) part[x] = 0.f;")]),
    "no_exp": (FP32, [("expf(s[0][j][e] - m_new[e >> 1])",
                       "(s[0][j][e] - m_new[e >> 1])")]),
    "fast_exp": (FP32, [("expf(s[0][j][e] - m_new[e >> 1])",
                         "__expf(s[0][j][e] - m_new[e >> 1])")]),
    "no_fetch": (FP32, [("if (kStages == 2 && i + 1 < n_tiles) "
                         "fetch(i + 1);", "")]),
    "no_barrier": (FP32, [("    __syncthreads();                      "
                           "// tile i + 1 has landed",
                           "    // tile i + 1 has landed")]),
    "split_only": (FP32, [("  kernel<<<grid, kTcThreads, smem, stream>>>(\n"
                           "      static_cast<const float*>(q), "
                           "static_cast<const float*>(ws)",
                           "  if (Sq < 0) kernel<<<grid, kTcThreads, smem, "
                           "stream>>>(\n      static_cast<const float*>(q), "
                           "static_cast<const float*>(ws)")]),
    "bf16_no_s": (BF16, [("bf_dots<DH>(s, q_s, k_t);                      "
                          " // S = Q K^T",
                          "for (int x = 0; x < 32; ++x) s[x] = 0.f;")]),
    "bf16_no_pv": (BF16, [("pv_bf16<DH>(acc, pp, k_t + kTileB, alpha[0], "
                           "alpha[1]);", "")]),
    "bf16_no_exp": (BF16, [("expf(s[x] - m_new[rr])",
                            "(s[x] - m_new[rr])")]),
    "bf16_no_fetch": (BF16, [("if (kStages == 2 && i + 1 < n_tiles) {\n"
                              "      fetch(i + 1);",
                              "if (kStages == 2 && i + 1 < 0) {\n"
                              "      fetch(i + 1);")]),
    "bf16_no_barrier": (BF16, [("__syncthreads();                          "
                                "      // tile i is in, tile i - 1 is read",
                                "")]),
}
B, S, H, HKV, D = 2, 2048, 36, 4, 128


def part_source(name: str) -> str:
    """The flash source with part ``name``'s lines replaced; raises
    ValueError if a line is not in the source exactly once."""
    text = (build.CSRC / "flash_attention.cu").read_text()
    for old, new in PARTS[name][1]:
        if text.count(old) != 1:
            raise ValueError(f"flash_fwd_parts: {name}: the source has "
                             f"{old!r} {text.count(old)} times, not once")
        text = text.replace(old, new)
    return text.replace('#include "hopper.cuh"',
                        f'#include "{build.CSRC / "hopper.cuh"}"')


def _build(out_dir: Path):
    """One shared library per part, all nvcc runs started together."""
    procs = {}
    for name in PARTS:
        cu = out_dir / f"{name}.cu"
        cu.write_text(part_source(name))
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o",
             str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"flash_fwd_parts: {name} did not build:\n{log}")
    return {name: out_dir / f"{name}.so" for name in PARTS}


def _ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_parts: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out_dir = build.BUILD_DIR.parent / "flash_fwd_parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    try:
        libs = _build(out_dir)
    except ValueError as e:
        raise SystemExit(str(e))
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {}
    for q_name in FP32 + BF16:
        dt = getattr(torch, q_name)
        q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dt)
        k = torch.randn((B, S, HKV, D), generator=gen, device="cuda").to(dt)
        v = torch.randn((B, S, HKV, D), generator=gen, device="cuda").to(dt)
        ws = (fa.fwd_workspace(B, S, HKV, D, q.device)
              if dt == torch.float32 else None)
        inputs[q_name] = (q, k, v, torch.empty_like(q),
                          torch.empty((B, H, S), device="cuda"), ws)
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for window in (-1, 256):
        for name, lib in libs.items():
            fn = ctypes.CDLL(str(lib)).flash_attention_fwd_launch
            fn.argtypes = [p] * 6 + [i] * 8 + [ctypes.c_float, i, p]
            fn.restype = i
            for q_name in PARTS[name][0]:
                q, k, v, out, lse, ws = inputs[q_name]

                def call():
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), lse.data_ptr(),
                             ws.data_ptr() if ws is not None else None, B,
                             S, S, H, HKV, D, 1, window, D ** -0.5,
                             int(q_name == "bfloat16"), stream)
                    if err:
                        raise SystemExit(f"flash_fwd_parts: {name}: CUDA "
                                         f"error {err}")

                print(f'{{"window": {window}, "q": "{q_name}", '
                      f'"part": "{name}", "ms": {_ms(call)}}}', flush=True)


if __name__ == "__main__":
    sys.exit(main())
