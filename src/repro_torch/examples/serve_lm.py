"""End-to-end serving example: batched request serving with continuous
batching, KV caches and live carbon accounting (mirror of
``examples/serve_lm.py``).

The paper's kind is edge inference sustainability, and this is its
end-to-end example: a small LM (an arch's smoke config, fp32, random
weights from seed 0) serves a stream of requests; every decode tick is
billed by the CarbonAccountant on ``h100_sxm``; the report answers the
paper's question (operational energy, carbon by grid mix, embodied
amortization).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm \\
        [--arch gemma3-27b] [--device cpu]

Runs on the card unless ``--device cpu`` is given. On the CPU the
report's wall-time-derived figures are left out, since CPU seconds say
nothing about the card's joules. gemma3-27b's smoke config serves its
sliding-window layers (window 8) through the same kernels as its full
width's (K1 on the card: head dim 24 there, 168 at full width).
``--arch`` takes any LM arch of the port's registry, the MoE archs
moonshot-v1-16b-a3b and kimi-k2-1t-a32b and the SSD/hybrid archs
mamba2-1.3b and zamba2-7b among them.
"""

import argparse

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.configs import base as cfgbase
from repro_torch.core import accounting
from repro_torch.launch.serve import WALL_KEYS
from repro_torch.models import transformer as tf
from repro_torch.serve import ServeConfig, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-27b",
                    help="arch whose SMOKE config is served")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--grid-mix", default="CA")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = device_lib.resolve(args.device)
    arch = cfgbase.get(args.arch)
    if arch.kind != "lm":
        raise SystemExit(f"{args.arch} is {arch.kind}; pick an LM arch")
    cfg = arch.make_smoke()
    params = tf.init_lm(cfg, seed=0, dtype=torch.float32, device=dev)

    acct = accounting.CarbonAccountant(accounting.AccountantConfig(
        device="h100_sxm", n_devices=1, grid_mix=args.grid_mix))
    eng = ServeEngine(params, cfg,
                      ServeConfig(max_slots=args.slots, max_len=256,
                                  cache_dtype=torch.float32,
                                  device=str(dev)),
                      accountant=acct)

    rng = np.random.default_rng(0)
    print(f"serving {args.requests} requests on {args.arch} (smoke config), "
          f"{args.slots} slots, continuous batching, on {dev}:")
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=int(rng.integers(4, 16)))
        eng.submit(prompt, max_tokens=args.max_tokens)
    done = eng.run_until_drained()
    for r in done[:6]:
        print(f"  req {r.uid:2d}: {len(r.prompt):2d} prompt toks -> "
              f"{len(r.generated)} generated")
    print(f"  ... {len(done)} requests completed")

    s = eng.summary()
    print(f"\nserve metrics (live path): {s['ticks']} ticks, "
          f"{s['decode_tokens']:.0f} decode tokens at "
          f"{s['decode_tokens_per_s']:.1f} tok/s on {dev.type} "
          f"(+ {s['prefill_tokens']:.0f} prefill tokens)")

    rep = acct.report()
    print("\ncarbon report (billed as h100_sxm):")
    print(f"  decode ticks: {rep['steps']}, tokens: {rep['tokens']:.0f}")
    if dev.type == "cpu":
        print("  (CPU run: the wall-time-derived figures "
              f"{', '.join(sorted(WALL_KEYS))} are left out)")
    else:
        if rep.get("j_per_token") is not None:
            print(f"  J/token (live): {rep['j_per_token']:.3f}")
        print(f"  operational: {rep['operational_j']:.1f} J = "
              f"{rep['operational_gco2']:.4f} gCO2eq ({args.grid_mix} grid)")
        print(f"  tokens/J: {rep['tokens_per_j']:.2f}")
        print(f"  lifecycle amortized so far: "
              f"{rep['amortized_fraction']:.2e}")
        print(f"  device: {torch.cuda.get_device_name(dev)}")
    print(f"  fleet embodied budget: {rep['embodied_j']/1e6:.0f} MJ "
          f"({rep['embodied_gco2']/1e3:.1f} kgCO2eq)")


if __name__ == "__main__":
    main()
