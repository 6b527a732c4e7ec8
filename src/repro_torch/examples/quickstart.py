"""Quickstart: train a tiny LM with live carbon accounting, then generate
(mirror of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import accounting
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.launch.serve import WALL_KEYS
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)
    cfg = tf.LMConfig(name="quickstart", d_model=96, n_heads=4, n_kv_heads=2,
                      d_ff=192, vocab=128, pattern=(tf.BlockSpec(),),
                      repeats=3)
    params = tf.init_lm(cfg, seed=0, dtype=torch.float32, device=dev)

    acct = accounting.CarbonAccountant(accounting.AccountantConfig(
        device="h100_sxm", n_devices=1, grid_mix="CA"))
    trainer = Trainer(
        loss_fn=lambda p, b: tf.loss_fn(p, cfg, b),
        params=params,
        opt_cfg=AdamWConfig(lr=warmup_cosine(3e-3, 10, 100)),
        train_cfg=TrainConfig(num_steps=100, log_every=20),
        pipeline=make_pipeline(DataConfig(vocab=128, seq_len=64,
                                          global_batch=8, source="markov")),
        accountant=acct)
    print("training 100 steps on markov data...")
    trainer.run()
    for e in trainer.metrics_log:
        print(f"  step {e['step']:4d} loss {e['loss']:.3f} "
              f"({e['step_time_s']*1e3:.0f} ms/step)")

    rep = acct.report()
    if dev.type == "cpu":
        rep = {k: v for k, v in rep.items() if k not in WALL_KEYS}
    print("\ncarbon report (the paper's holistic accounting, live; billed "
          "as h100_sxm" + (", wall-time-derived keys left out on the CPU"
                           if dev.type == "cpu" else "") + "):")
    for k, v in rep.items():
        print(f"  {k}: {v}")

    print("\ngreedy generation from the trained model:")
    with torch.no_grad():
        eng = ServeEngine(trainer.params, cfg,
                          ServeConfig(max_slots=2, max_len=96,
                                      cache_dtype=torch.float32,
                                      device=str(dev)))
        eng.submit(np.arange(8), max_tokens=12)
        for r in eng.run_until_drained():
            print(f"  prompt={list(r.prompt)} -> {r.generated}")


if __name__ == "__main__":
    main()
