"""Training launcher of the PyTorch port (mirror of ``repro.launch.train``,
the fused engine's smoke path).

    python -m repro_torch.launch.train --arch starcoder2-7b --smoke \\
        [--device cpu] --engine fused --steps 4 --steps-per-tick 2 \\
        [--grid-mix NY] [--report out.json]

Runs the arch's reduced config in fp32 through the fused ``TrainEngine``
(k optimizer steps per tick, one metrics readback per tick) on the
reference's Markov token stream and AdamW schedule, and prints the final
metrics, the engine summary and the carbon report, whose ``train`` block
splits the modeled energy into forward, backward and optimizer phases.
Runs on the card unless ``--device cpu`` is given; on the card the report
bills ``h100_sxm``, on the CPU its wall-time-derived keys are left out.
``--engine loop`` (the checkpointing Trainer) is not ported yet.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch import device as device_lib
from repro_torch.configs import base as cfgbase
from repro_torch.core import accounting
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.launch.serve import WALL_KEYS
from repro_torch.models import transformer as tf_lib
from repro_torch.optim import AdamWConfig
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train import TrainEngine, TrainEngineConfig


def build_smoke_engine(arch_id: str, *, steps: int, grid_mix: str = "NY",
                       seed: int = 0, global_batch: int = 8,
                       seq_len: int = 64, steps_per_tick: int = 8,
                       lr: float = 3e-3, device="cuda") -> TrainEngine:
    """The arch's smoke config in fp32 with random weights from ``seed``,
    the Markov stream and the warmup-cosine AdamW of the reference's smoke
    engine, billed to ``h100_sxm``."""
    dev = device_lib.resolve(device)
    arch = cfgbase.get(arch_id)
    if arch.kind != "lm":
        raise SystemExit(f"{arch_id}: the fused engine trains LM archs")
    cfg = arch.make_smoke()
    params = tf_lib.init_lm(cfg, seed=seed, dtype=torch.float32, device=dev)
    pipeline = make_pipeline(DataConfig(
        vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch,
        seed=seed, source="markov"))
    acct = accounting.CarbonAccountant(accounting.AccountantConfig(
        device="h100_sxm", n_devices=1, grid_mix=grid_mix))
    return TrainEngine.for_lm(
        params, cfg,
        opt_cfg=AdamWConfig(lr=warmup_cosine(lr, max(steps // 10, 1), steps)),
        pipeline=pipeline,
        engine_cfg=TrainEngineConfig(steps_per_tick=steps_per_tick),
        accountant=acct)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config, in fp32")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--grid-mix", default="NY")
    ap.add_argument("--report", default=None, help="write accounting JSON")
    ap.add_argument("--engine", choices=("loop", "fused"), default="fused",
                    help="fused: the TrainEngine tick with per-phase energy "
                         "accounting; loop: the checkpointing Trainer (not "
                         "ported yet)")
    ap.add_argument("--steps-per-tick", type=int, default=8,
                    help="fused engine: optimizer steps per tick")
    args = ap.parse_args(argv)
    if args.steps < 1 or args.steps_per_tick < 1:
        ap.error("--steps and --steps-per-tick must be >= 1")
    if args.engine == "loop":
        raise NotImplementedError("--engine loop: the checkpointing Trainer "
                                  "is not ported yet; use --engine fused")
    if not args.smoke:
        raise SystemExit("the full config does not fit one card with fp32 "
                         "AdamW state; use --smoke (chip_smoke.py trains "
                         "starcoder2-7b at full width, reduced depth)")

    dev = device_lib.resolve(args.device)
    eng = build_smoke_engine(args.arch, steps=args.steps,
                             grid_mix=args.grid_mix,
                             steps_per_tick=args.steps_per_tick, device=dev)
    metrics = eng.run(args.steps)
    print("final metrics:", json.dumps(metrics))
    print("engine summary:", json.dumps(eng.summary()))
    rep = eng.accountant.report()
    if dev.type == "cpu":
        rep = {k: v for k, v in rep.items() if k not in WALL_KEYS}
        print("carbon report (CPU run: wall-time-derived keys left out):",
              json.dumps(rep, default=float))
    else:
        print(f"device: {torch.cuda.get_device_name(dev)}")
        print("carbon report:", json.dumps(rep, default=float))
    if args.report:
        with open(args.report, "w") as f:
            json.dump({"metrics": metrics, "summary": eng.summary(),
                       "carbon": rep}, f, default=float)


if __name__ == "__main__":
    main()
