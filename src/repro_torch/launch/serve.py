"""Serving launcher of the PyTorch port: batched request serving with
carbon accounting (mirror of ``repro.launch.serve``, dense path).

    python -m repro_torch.launch.serve --arch starcoder2-7b \\
        [--smoke] [--device cpu] --requests 8 --max-tokens 16 \\
        [--prompt-len 4 12] [--profile-ticks N]

Runs on the card unless ``--device cpu`` is given. The full-width model is
built in bf16 from a seed; ``--smoke`` builds the arch's reduced config in
fp32. On the card the carbon report bills ``h100_sxm``; on the CPU the
report's wall-time-derived keys are left out, since CPU seconds say
nothing about the card's joules.

``--profile-ticks N`` runs N decode ticks under ``torch.profiler`` once
every slot is decoding and prints the kernels with the most device time
and the device's busy share of those ticks' wall time.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.configs import base as cfgbase
from repro_torch.core import accounting
from repro_torch.models import transformer as tf_lib
from repro_torch.serve import (Scheduler, SchedulerConfig, ServeConfig,
                               ServeEngine)

# report keys computed from wall time (active seconds x board power)
WALL_KEYS = frozenset({"operational_j", "operational_gco2", "j_per_token",
                       "tokens_per_j", "gco2_per_mtoken", "active_s",
                       "amortized_fraction"})


def profile_ticks(eng: ServeEngine, n: int, top: int = 12):
    """Run ``n`` engine steps under torch.profiler. Returns the requests
    they finished and a report: the device time by kernel name (ms,
    largest first) and the busy share of the wall time. On the CPU the
    profiler sees no device, and the share is 0. Only device-side events
    count: a host op's device time repeats that of the kernels it
    launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda = eng.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    finished = []
    with profile(activities=acts) as prof:
        t0 = time.monotonic()
        for _ in range(n):
            finished += eng.step()
        if cuda:
            torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    kernels = sorted(((e.key, e.self_device_time_total / 1e3)
                      for e in events), key=lambda kv: -kv[1])
    busy_ms = sum(ms for _, ms in kernels)
    return finished, {
        "ticks": n, "wall_ms": 1e3 * wall_s, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / (1e3 * wall_s),
        "kernel_launches_per_tick": sum(e.count for e in events) / n,
        "top_kernels_ms": dict(kernels[:top])}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config, in fp32")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--grid-mix", default="NY")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--policy", default="fifo",
                    choices=("fifo", "longest_prompt"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(4, 12),
                    metavar=("LO", "HI"),
                    help="prompt lengths drawn uniformly from [LO, HI)")
    ap.add_argument("--profile-ticks", type=int, default=0,
                    help="profile this many decode ticks once every slot "
                         "decodes (0 = off)")
    args = ap.parse_args(argv)
    if args.requests < 0 or args.max_tokens < 1 or args.slots < 1:
        ap.error("--requests >= 0, --max-tokens >= 1 and --slots >= 1")
    lo, hi = args.prompt_len
    if not 1 <= lo < hi or hi > args.max_len:
        ap.error("--prompt-len needs 1 <= LO < HI <= --max-len")
    if args.profile_ticks < 0:
        ap.error("--profile-ticks must be >= 0")

    dev = device_lib.resolve(args.device)
    arch = cfgbase.get(args.arch)
    if arch.kind != "lm":
        raise SystemExit(f"serve launcher supports LM archs; {args.arch} is "
                         f"{arch.kind}")
    cfg = arch.make_smoke() if args.smoke else arch.make_config()
    dtype = torch.float32 if args.smoke else torch.bfloat16
    params = tf_lib.init_lm(cfg, seed=args.seed, dtype=dtype, device=dev)
    acct = accounting.CarbonAccountant(accounting.AccountantConfig(
        device="h100_sxm", n_devices=1, grid_mix=args.grid_mix))
    eng = ServeEngine(params, cfg,
                      ServeConfig(max_slots=args.slots, max_len=args.max_len,
                                  temperature=args.temperature,
                                  seed=args.seed, device=str(dev)),
                      accountant=acct,
                      scheduler=Scheduler(SchedulerConfig(policy=args.policy)))
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=rng.integers(lo, hi))
        eng.submit(prompt, max_tokens=args.max_tokens)
    done = []
    if args.profile_ticks:
        done += eng.step()              # the first admission fills the slots
        finished, report = profile_ticks(eng, args.profile_ticks)
        done += finished
        print("profile:", json.dumps(report))
    done = sorted(done + eng.run_until_drained(), key=lambda r: r.uid)
    for r in done:
        print(f"req {r.uid}: prompt_len={len(r.prompt)} -> {r.generated}")
    s = eng.summary()
    print("summary:", json.dumps(s))
    rep = acct.report()
    if dev.type == "cpu":
        rep = {k: v for k, v in rep.items() if k not in WALL_KEYS}
        print("carbon report (CPU run: wall-time-derived keys left out):",
              json.dumps(rep, default=float))
    else:
        print(f"device: {torch.cuda.get_device_name(dev)}")
        print("carbon report:", json.dumps(rep, default=float))


if __name__ == "__main__":
    main()
