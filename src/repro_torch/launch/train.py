"""Training launcher of the PyTorch port (mirror of ``repro.launch.train``,
its smoke path).

    python -m repro_torch.launch.train --arch starcoder2-7b --smoke \\
        [--device cpu] --steps 8 [--ckpt-dir DIR [--resume]] \\
        [--engine fused --steps-per-tick 4] [--grid-mix NY] \\
        [--report out.json]

Runs the arch's reduced config in fp32 on the reference's Markov token
stream and AdamW schedule: an LM arch (with zero vision embeddings over
its first ``vision_tokens`` positions when it has a vision frontend), or
the encoder-decoder on zero audio frames, as the reference's smoke
trainer does. ``--engine loop`` (the default, as in the
reference) drives the checkpointing host-loop ``Trainer``: a checkpoint
every quarter of the run into ``--ckpt-dir``, the latest one restored
first with ``--resume`` (params, optimizer state, step and stream), a
synchronous checkpoint on SIGTERM. ``--engine fused`` drives the
``TrainEngine`` (k optimizer steps per tick, one metrics readback per
tick) and prints its summary; its carbon report's ``train`` block splits
the modeled energy into forward, backward and optimizer phases (LM archs
only: an encoder-decoder arch is refused, use the loop). Both print
the final metrics and the carbon report. Runs on the card unless
``--device cpu`` is given; the report bills ``h100_sxm``, and on the CPU
its wall-time-derived keys are left out.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import torch

from repro_torch import device as device_lib
from repro_torch.checkpoint import CheckpointConfig
from repro_torch.configs import base as cfgbase
from repro_torch.core import accounting
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.launch.serve import WALL_KEYS
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.optim import AdamWConfig
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train import (TrainConfig, Trainer, TrainEngine,
                               TrainEngineConfig)
from repro_torch.train.ft import HeartbeatWriter


def _smoke_arch(arch_id: str, what: str, kinds=("lm", "encdec")):
    arch = cfgbase.get(arch_id)
    if arch.kind not in kinds:
        raise SystemExit(f"{arch_id}: the {what} trains "
                         f"{' and '.join(kinds)} archs")
    return arch


def _accountant(grid_mix: str) -> accounting.CarbonAccountant:
    return accounting.CarbonAccountant(accounting.AccountantConfig(
        device="h100_sxm", n_devices=1, grid_mix=grid_mix))


def build_smoke_trainer(arch_id: str, *, steps: int, ckpt_dir: Optional[str],
                        grid_mix: str = "NY", seed: int = 0,
                        global_batch: int = 8, seq_len: int = 64,
                        heartbeat_dir: Optional[str] = None,
                        lr: float = 3e-3, device="cuda") -> Trainer:
    """The arch's smoke config in fp32 with random weights from ``seed``,
    the Markov stream and warmup-cosine AdamW of the reference's smoke
    trainer, a checkpoint every quarter of ``steps`` into ``ckpt_dir``, a
    heartbeat file when ``heartbeat_dir`` is given, billed to
    ``h100_sxm``. Every batch gets the constant inputs of the reference's
    smoke trainer (launch/train.py:47-66): an encoder-decoder arch zero
    ``frames`` (global_batch, n_audio_ctx, d_model), an LM arch with a
    vision frontend zero ``vision_embeds`` (global_batch, vision_tokens,
    d_model)."""
    dev = device_lib.resolve(device)
    arch = _smoke_arch(arch_id, "Trainer")
    cfg = arch.make_smoke()
    if arch.kind == "encdec":
        params = encdec_lib.init_encdec(cfg, seed=seed, dtype=torch.float32,
                                        device=dev)
        extra = {"frames": torch.zeros(
            (global_batch, cfg.n_audio_ctx, cfg.d_model), device=dev)}
        model_loss = encdec_lib.loss_fn
    else:
        params = tf_lib.init_lm(cfg, seed=seed, dtype=torch.float32,
                                device=dev)
        extra = ({"vision_embeds": torch.zeros(
            (global_batch, cfg.vision_tokens, cfg.d_model), device=dev)}
            if cfg.vision_tokens else {})
        model_loss = tf_lib.loss_fn
    pipeline = make_pipeline(DataConfig(
        vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch,
        seed=seed, source="markov"))
    hb = (HeartbeatWriter(heartbeat_dir, host_id="host0")
          if heartbeat_dir else None)
    return Trainer(
        loss_fn=lambda p, b: model_loss(p, cfg, {**b, **extra}),
        params=params,
        opt_cfg=AdamWConfig(lr=warmup_cosine(lr, max(steps // 10, 1), steps)),
        train_cfg=TrainConfig(num_steps=steps, log_every=max(steps // 10, 1),
                              checkpoint_every=max(steps // 4, 1)),
        pipeline=pipeline,
        ckpt_cfg=(CheckpointConfig(directory=ckpt_dir) if ckpt_dir else None),
        accountant=_accountant(grid_mix), heartbeat=hb)


def build_smoke_engine(arch_id: str, *, steps: int, grid_mix: str = "NY",
                       seed: int = 0, global_batch: int = 8,
                       seq_len: int = 64, steps_per_tick: int = 8,
                       lr: float = 3e-3, device="cuda") -> TrainEngine:
    """The arch's smoke config in fp32 with random weights from ``seed``,
    the Markov stream and the warmup-cosine AdamW of the reference's smoke
    engine, billed to ``h100_sxm``. LM archs only, as in the reference:
    an encoder-decoder smoke run uses the loop engine."""
    dev = device_lib.resolve(device)
    if cfgbase.get(arch_id).kind == "encdec":
        raise SystemExit(f"{arch_id}: encdec smoke runs use --engine loop")
    cfg = _smoke_arch(arch_id, "fused engine", kinds=("lm",)).make_smoke()
    params = tf_lib.init_lm(cfg, seed=seed, dtype=torch.float32, device=dev)
    pipeline = make_pipeline(DataConfig(
        vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch,
        seed=seed, source="markov"))
    return TrainEngine.for_lm(
        params, cfg,
        opt_cfg=AdamWConfig(lr=warmup_cosine(lr, max(steps // 10, 1), steps)),
        pipeline=pipeline,
        engine_cfg=TrainEngineConfig(steps_per_tick=steps_per_tick),
        accountant=_accountant(grid_mix))


def _print_report(rep: dict, dev: torch.device) -> dict:
    if dev.type == "cpu":
        rep = {k: v for k, v in rep.items() if k not in WALL_KEYS}
        print("carbon report (CPU run: wall-time-derived keys left out):",
              json.dumps(rep, default=float))
    else:
        print(f"device: {torch.cuda.get_device_name(dev)}")
        print("carbon report:", json.dumps(rep, default=float))
    return rep


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config, in fp32")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grid-mix", default="NY")
    ap.add_argument("--report", default=None, help="write accounting JSON")
    ap.add_argument("--engine", choices=("loop", "fused"), default="loop",
                    help="loop: host-loop Trainer (checkpoint/FT path); "
                         "fused: the TrainEngine tick with per-phase energy "
                         "accounting")
    ap.add_argument("--steps-per-tick", type=int, default=8,
                    help="fused engine: optimizer steps per tick")
    args = ap.parse_args(argv)
    if args.steps < 1 or args.steps_per_tick < 1:
        ap.error("--steps and --steps-per-tick must be >= 1")
    if not args.smoke:
        raise SystemExit("the full config does not fit one card with fp32 "
                         "AdamW state; use --smoke (chip_smoke.py trains "
                         "starcoder2-7b at full width, reduced depth)")

    dev = device_lib.resolve(args.device)
    if args.engine == "fused":
        eng = build_smoke_engine(args.arch, steps=args.steps,
                                 grid_mix=args.grid_mix,
                                 steps_per_tick=args.steps_per_tick,
                                 device=dev)
        metrics = eng.run(args.steps)
        print("final metrics:", json.dumps(metrics))
        print("engine summary:", json.dumps(eng.summary()))
        rep = _print_report(eng.accountant.report(), dev)
        if args.report:
            with open(args.report, "w") as f:
                json.dump({"metrics": metrics, "summary": eng.summary(),
                           "carbon": rep}, f, default=float)
        return

    tr = build_smoke_trainer(args.arch, steps=args.steps,
                             ckpt_dir=args.ckpt_dir, grid_mix=args.grid_mix,
                             device=dev)
    tr.install_preemption_handler()
    if args.resume:
        restored = tr.maybe_restore()
        print(f"resume: "
              f"{'restored step ' + str(tr.step_num) if restored else 'fresh'}")
    metrics = tr.run()
    print("final metrics:", json.dumps(metrics))
    rep = _print_report(tr.accountant.report(), dev)
    if args.report:
        with open(args.report, "w") as f:
            json.dump({"metrics": metrics, "step": tr.step_num,
                       "carbon": rep}, f, default=float)


if __name__ == "__main__":
    main()
