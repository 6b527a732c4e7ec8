"""Whether torch.profiler on the card keeps every kernel record of a short
profile, before and after a long one. A short profile is two of AlexNet's
batch-1 forwards through the K11 route (``forward(matmul_fn=ternary_mm)``,
chip_smoke.py's CNN phase); each series takes it 12 times and prints, for
each take, the card's records in all and K11's. Then one profile of N
single-kernel calls (N = 30000, then 100000), and the series again: at
once, with the window held open 1 s after the synchronize, and once more.
A record that a profile lost is not in its counts; the kernels ran.

    PYTHONPATH=src python src/repro_torch/benchmarks/profiler_records.py

Prints one JSON line a series. Needs a card and nvcc.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.examples.edge_cnn_repro import fc_predicate, ternary_mm
from repro_torch.models import cnn
from repro_torch.quant import ternary

ACTIVITIES = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
LONG = (30000, 100000)


def device_records(prof, word=""):
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0 and word in e.key)


def short_profile(fn, pad_s):
    """(records, K11's records) of one profile of two calls of ``fn``."""
    with profile(activities=ACTIVITIES) as prof:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    return device_records(prof), device_records(prof, "ternary_gemv")


def series(fn, tag, takes=12, pad_s=0.0):
    t0 = time.monotonic()
    counts = [short_profile(fn, pad_s) for _ in range(takes)]
    print(json.dumps({"series": tag, "pad_s": pad_s,
                      "seconds": time.monotonic() - t0, "counts": counts}),
          flush=True)


def long_profile(n):
    x = torch.zeros(16, device="cuda")
    with profile(activities=ACTIVITIES) as prof:
        for _ in range(n):
            x.add_(1)
        torch.cuda.synchronize()
    print(json.dumps({"long_profile_calls": n,
                      "records": device_records(prof)}), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profiler_records: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    cfg = cnn.ALEXNET
    params = cnn.init_cnn(cfg, seed=0, device="cuda")
    qparams = ternary.quantize_tree(params, predicate=fc_predicate)
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randn((1, cfg.image_size, cfg.image_size, cfg.in_channels),
                         generator=gen, device="cuda")

    def forward():
        with torch.no_grad():
            return cnn.forward(qparams, cfg, images, matmul_fn=ternary_mm)

    forward()
    torch.cuda.synchronize()
    series(forward, "before any long profile")
    for n in LONG:
        long_profile(n)
        series(forward, f"after {n}")
        series(forward, f"after {n}, window open 1 s more", 6, 1.0)
        series(forward, f"after {n}, again")


if __name__ == "__main__":
    main()
