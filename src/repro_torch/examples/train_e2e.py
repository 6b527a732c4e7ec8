"""End-to-end training example at ~100M scale (mirror of
``examples/train_e2e.py``).

On the card this trains the ~100M-param gemma3-family model (12 layers,
d_model 768, five 256-token-window layers per global one) with the full
stack of the checkpointing ``Trainer``: checkpoints (keep 2), resume of the
latest one, a heartbeat file, SIGTERM preemption and carbon accounting.
``--cpu-scale`` runs a ~0.7M model through the same code on the CPU.

    PYTHONPATH=src python -m repro_torch.examples.train_e2e --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_e2e --device cpu \\
        --cpu-scale --steps 60

The reference config's ``remat`` field steers TPU compilation only and has
no counterpart here (``bridge.config_from_dict`` drops it).
"""

import argparse
import json
import tempfile

import torch

from repro_torch import device as device_lib
from repro_torch.checkpoint import CheckpointConfig
from repro_torch.core import accounting
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.launch.serve import WALL_KEYS
from repro_torch.models import transformer as tf
from repro_torch.models.common import flatten
from repro_torch.optim import AdamWConfig
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train.ft import HeartbeatWriter


def model_100m() -> tf.LMConfig:
    """~100M params: 12L, d=768, gemma3-style 5:1 local:global pattern."""
    local, glob = tf.BlockSpec(window=256), tf.BlockSpec(window=-1)
    return tf.LMConfig(name="e2e-100m", d_model=768, n_heads=12,
                       n_kv_heads=4, d_ff=3072, vocab=32768,
                       pattern=(local,) * 5 + (glob,), repeats=2,
                       act="gelu")


def model_cpu() -> tf.LMConfig:
    local, glob = tf.BlockSpec(window=64), tf.BlockSpec(window=-1)
    return tf.LMConfig(name="e2e-cpu", d_model=128, n_heads=4, n_kv_heads=2,
                       d_ff=256, vocab=512, pattern=(local, glob), repeats=2,
                       act="gelu")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--cpu-scale", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grid-mix", default="NY")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)

    cfg = model_cpu() if args.cpu_scale else model_100m()
    params = tf.init_lm(cfg, seed=0, dtype=torch.float32, device=dev)
    n_params = sum(p.numel() for p in flatten(params)[0])
    print(f"model {cfg.name}: {n_params/1e6:.1f}M params, "
          f"{cfg.n_layers} layers, on {dev}")

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="e2e_ckpt_")
    hb_dir = tempfile.mkdtemp(prefix="e2e_hb_")
    acct = accounting.CarbonAccountant(accounting.AccountantConfig(
        device="h100_sxm", n_devices=1, grid_mix=args.grid_mix))
    trainer = Trainer(
        loss_fn=lambda p, b: tf.loss_fn(p, cfg, b),
        params=params,
        opt_cfg=AdamWConfig(lr=warmup_cosine(3e-3, args.steps // 10,
                                             args.steps)),
        train_cfg=TrainConfig(num_steps=args.steps,
                              log_every=max(args.steps // 10, 1),
                              checkpoint_every=max(args.steps // 4, 1),
                              grad_accum=1),
        pipeline=make_pipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                          global_batch=args.batch,
                                          source="markov")),
        ckpt_cfg=CheckpointConfig(directory=ckpt_dir, keep_last=2),
        accountant=acct,
        heartbeat=HeartbeatWriter(hb_dir, host_id="host0"))
    trainer.install_preemption_handler()
    resumed = trainer.maybe_restore()
    print(f"{'resumed from step ' + str(trainer.step_num) if resumed else 'fresh start'}; "
          f"training {args.steps} steps...")
    trainer.run()
    for e in trainer.metrics_log:
        print(f"  step {e['step']:5d} loss={e['loss']:.3f} "
              f"gnorm={e.get('grad_norm', 0):.2f} "
              f"({e['step_time_s']*1e3:.0f} ms)")
    trainer.save(wait=True)
    print(f"checkpoints in {ckpt_dir}: latest step {trainer.ckpt.latest_step()}")
    rep = acct.report()
    if dev.type == "cpu":
        rep = {k: v for k, v in rep.items() if k not in WALL_KEYS}
    print("carbon report:", json.dumps(rep, default=float, indent=2))


if __name__ == "__main__":
    main()
