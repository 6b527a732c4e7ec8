"""Where the flash forward's time goes on the card: K6's kernel
(``csrc/flash_attention.cu``) built again with one part of its tile loop
removed at a time, each copy timed at the training path's shapes (fp32, B =
2, S = 2048, H = 36, Hkv = 4, D = 128, causal, windows -1 and 256) by CUDA
events beside the kernel as it stands. A copy's time is that of the kernel
without the part; its results are wrong by design and are not checked.

    PYTHONPATH=src python src/repro_torch/benchmarks/flash_fwd_parts.py

The parts: ``no_s`` (S = Q K^T's wgmma, S taken as zeros), ``no_pv`` (P V's
wgmma, its partial sums zeros), ``no_exp`` (the softmax's exp), ``fast_exp``
(``__expf`` for the softmax's exp: a rate, not a part), ``no_fetch`` (the
cp.async copies of the next tile's planes), ``no_barrier`` (the barrier at
the end of each tile) and ``split_only`` (the K/V split pre-pass alone). The
copies are made by replacing lines of the source, and a line that is not
there exactly once stops the script. They build into
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

PARTS = {
    "as_is": [],
    "no_s": [("dots_wgmma_rs<D, kKvLo>(qa, q_lo, kb, kb + kPlane, s);",
              "for (int x = 0; x < 16; ++x) "
              "reinterpret_cast<float*>(s)[x] = 0.f;")],
    "no_pv": [("pv_wgmma<kKvLo>(pf, vt + 64 * c * kFwdKeys, "
               "vt + kPlane + 64 * c * kFwdKeys, part);",
               "for (int x = 0; x < 32; ++x) part[x] = 0.f;")],
    "no_exp": [("expf(s[0][j][e] - m_new[e >> 1])",
                "(s[0][j][e] - m_new[e >> 1])")],
    "fast_exp": [("expf(s[0][j][e] - m_new[e >> 1])",
                  "__expf(s[0][j][e] - m_new[e >> 1])")],
    "no_fetch": [("if (i + 1 < n_tiles) fetch(i + 1);    // its buffer's",
                  "// its buffer's")],
    "no_barrier": [("    __syncthreads();                      // tile i + 1 "
                    "has landed", "    // tile i + 1 has landed")],
    "split_only": [("  kernel<<<grid, kTcThreads, smem, stream>>>(\n"
                    "      static_cast<const QT*>(q), static_cast<const "
                    "float*>(ws)",
                    "  if (Sq < 0) kernel<<<grid, kTcThreads, smem, "
                    "stream>>>(\n      static_cast<const QT*>(q), "
                    "static_cast<const float*>(ws)")],
}
B, S, H, HKV, D = 2, 2048, 36, 4, 128


def _build(out_dir: Path):
    """One shared library per part, all nvcc runs started together."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for name, edits in PARTS.items():
        text = src.replace('#include "hopper.cuh"',
                           f'#include "{build.CSRC / "hopper.cuh"}"')
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"flash_fwd_parts: {name}: the source has "
                                 f"{old!r} {text.count(old)} times, not "
                                 f"once")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
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
    libs = _build(out_dir)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((B, S, H, D), generator=gen, device="cuda")
    k = torch.randn((B, S, HKV, D), generator=gen, device="cuda")
    v = torch.randn((B, S, HKV, D), generator=gen, device="cuda")
    out, lse = torch.empty_like(q), torch.empty((B, H, S), device="cuda")
    ws = fa.fwd_workspace(B, S, HKV, D, q.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for window in (-1, 256):
        for name, lib in libs.items():
            fn = ctypes.CDLL(str(lib)).flash_attention_fwd_launch
            fn.argtypes = [p] * 6 + [i] * 8 + [ctypes.c_float, i, p]
            fn.restype = i

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), lse.data_ptr(), ws.data_ptr(), B, S,
                         S, H, HKV, D, 1, window, D ** -0.5, 0, stream)
                if err:
                    raise SystemExit(f"flash_fwd_parts: {name}: CUDA error "
                                     f"{err}")

            print(f'{{"window": {window}, "part": "{name}", '
                  f'"ms": {_ms(call)}}}', flush=True)


if __name__ == "__main__":
    sys.exit(main())
