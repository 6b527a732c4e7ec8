"""Kernel micro-benchmark of the PyTorch port: the rows of
``benchmarks/kernel_bench.py``, for K11 and K10.

At the reference's shapes (the ternary matmul at M = 256, K = 2048, N = 512
in fp32 with codes from ``ternarize``; flash attention at B = 2, S = 256,
H = 8 on 2 KV heads, D = 64, causal) it times each plain version
(``ref.ternary_matmul_ref`` and ``ref.flash_attention_ref``, the
counterparts of the reference's jitted oracles) and each kernel
(``ops.ternary_matmul``, ``ops.flash_attention``), and reports the kernel's
max abs error against the plain version (for the ternary matmul also the
plain version's max abs output, the scale of that error). On the card the times come from
CUDA events; on the CPU the ops run the plain versions themselves, so the
errors are 0 and the times are CPU times.

    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_bench [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Callable, List, Tuple

import torch

from repro_torch import device as device_lib
from repro_torch.kernels import ops, ref
from repro_torch.quant import ternary

OUT_PATH = (Path(__file__).resolve().parents[3] / "build" / "bench"
            / "BENCH_torch_kernels.json")
Row = Tuple[str, float, str]


def timed_us(fn: Callable[[], torch.Tensor], dev: torch.device,
             iters: int = 20) -> float:
    """Mean microseconds per call after one warm-up: CUDA events on the
    card, the host clock on the CPU."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return 1e3 * start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return 1e6 * (time.perf_counter() - t0) / iters


def run(device="cuda") -> List[Row]:
    """name, us_per_call, derived rows."""
    dev = device_lib.resolve(device)
    rows = ternary_rows(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    b, s, h, hkv, d = 2, 256, 8, 2, 64
    q = torch.randn((b, s, h, d), generator=gen, device=dev)
    k = torch.randn((b, s, hkv, d), generator=gen, device=dev)
    v = torch.randn((b, s, hkv, d), generator=gen, device=dev)
    kw = dict(scale=d ** -0.5, causal=True)
    shape = f"shape=b{b}s{s}h{h}kv{hkv}d{d}"

    def oracle():
        return ref.flash_attention_ref(q, k, v, **kw)

    def kernel():
        return ops.flash_attention(q, k, v, **kw)

    err = float((kernel() - oracle()).abs().max())
    return rows + [
        ("kernel/flash_attention_oracle", timed_us(oracle, dev), shape),
        ("kernel/flash_attention", timed_us(kernel, dev),
         f"{shape};device={dev.type}"),
        ("kernel/flash_attention_vs_oracle", 0.0, f"max_err={err:.2e}")]


def ternary_rows(dev: torch.device) -> List[Row]:
    """The ternary matmul's rows at the reference bench's shape."""
    gen = torch.Generator(device=dev).manual_seed(1)
    m, k, n = 256, 2048, 512
    x = torch.randn((m, k), generator=gen, device=dev)
    tw = ternary.ternarize(torch.randn((k, n), generator=gen, device=dev))
    shape = f"shape={m}x{k}x{n};flops={2 * m * k * n:.2e}"

    def oracle():
        return ref.ternary_matmul_ref(x, tw.q, tw.scale)

    def kernel():
        return ops.ternary_matmul(x, tw)

    want = oracle()
    err = float((kernel() - want).abs().max())
    return [("kernel/ternary_matmul_oracle", timed_us(oracle, dev), shape),
            ("kernel/ternary_matmul", timed_us(kernel, dev),
             f"{shape};device={dev.type}"),
            ("kernel/ternary_matmul_vs_oracle", 0.0,
             f"max_err={err:.2e};ref_max={float(want.abs().max()):.2e}")]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(OUT_PATH))
    args = ap.parse_args(argv)
    rows = run(args.device)
    for name, us, derived in rows:
        print(f"{name},{us:.3f},{derived}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps([list(r) for r in rows], indent=2))


if __name__ == "__main__":
    main()
