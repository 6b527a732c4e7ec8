"""On-line training benchmark of the PyTorch port (mirror of
``benchmarks/train_bench.py``): the fused ``TrainEngine`` against the
host-loop ``Trainer``.

Two arms on the SAME model, token stream, optimizer and device:

* **reference**: the host-loop Trainer (``train/loop.py``): per-step batch
  staging, the step's launches, and a device sync every step;
* **fused**: the TrainEngine tick (``train/engine.py``): ``steps_per_tick``
  optimizer steps per tick, double-buffered batch staging overlapped with
  the device's work, one metrics readback per tick.

The bench model is the paper's edge regime, on-line adaptation with small
incremental updates (batch 2, seq 16), where step latency is dominated by
per-step host work. Beside the step-time ratio the bench checks that the
fast path is numerically honest: the fused engine's parameter updates
against ``make_train_step``'s (``update_parity_max_abs_diff``), and the
kernels' gradients against autograd through the plain versions
(``grad_parity_vs_ref``): the flash attention through K6-K8 against
``ref.flash_attention_fwd_ref``, the int8 matmul through K4 (fp32 output)
and K9 against ``(x @ q) * scale`` in fp32. On the CPU the kernels' plain
versions run in their place.

Differences from the reference's bench, by design: each of the model's 4
heads has 64 dims (the reference's d_model 64 / 4 heads gives 16) and the
flash grad parity runs at head_dim 64, because the port's flash kernels
take head_dim 64 and 128; the int8 grad parity's x is (5, 48), not (5,
40), because K4 takes K % 16 == 0; the output goes to ``build/bench/
BENCH_torch_train.json``, never to the reference's ``BENCH_train.json``.

    PYTHONPATH=src python -m repro_torch.benchmarks.train_bench [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import accounting
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as tf_lib
from repro_torch.models.common import flatten
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train import (TrainConfig, Trainer, TrainEngine,
                               TrainEngineConfig, make_train_step)

OUT_PATH = (Path(__file__).resolve().parents[3] / "build" / "bench"
            / "BENCH_torch_train.json")

# edge on-line adaptation workload: small incremental updates
D_MODEL, N_HEADS, N_KV, HEAD_DIM, D_FF, VOCAB = 64, 4, 2, 64, 128, 128
BATCH, SEQ = 2, 16
STEPS = 64
STEPS_PER_TICK = 32
WARMUP = STEPS_PER_TICK        # the timed run's tick shape, run once before


def _cfg() -> tf_lib.LMConfig:
    return tf_lib.LMConfig(name="train-bench", d_model=D_MODEL,
                           n_heads=N_HEADS, n_kv_heads=N_KV,
                           head_dim=HEAD_DIM, d_ff=D_FF, vocab=VOCAB,
                           pattern=(tf_lib.BlockSpec(),), repeats=2,
                           vocab_pad_multiple=1)


def _params(cfg, dev):
    return tf_lib.init_lm(cfg, seed=0, dtype=torch.float32, device=dev)


def _pipeline():
    return make_pipeline(DataConfig(vocab=VOCAB, seq_len=SEQ,
                                    global_batch=BATCH, seed=0,
                                    source="markov"))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _bench_reference(cfg, params, opt, dev):
    """Host-loop Trainer: stage -> launch -> sync, every step."""
    tr = Trainer(loss_fn=lambda p, b: tf_lib.loss_fn(p, cfg, b),
                 params=params, opt_cfg=opt,
                 train_cfg=TrainConfig(num_steps=STEPS, log_every=10 ** 9),
                 pipeline=_pipeline())
    tr.run(WARMUP)                    # allocator and kernel-build warm-up
    _sync(dev)
    t0 = time.monotonic()
    tr.run(STEPS)
    wall = time.monotonic() - t0
    with torch.no_grad():
        loss = float(tf_lib.loss_fn(tr.params, cfg, {
            k: torch.from_numpy(v).to(dev)
            for k, v in tr.pipeline.batch_at(tr.step_num).items()})[0])
    return {"steps": STEPS, "wall_s": round(wall, 4),
            "s_per_step": wall / STEPS, "final_loss": loss}


def _bench_fused(cfg, params, opt, dev):
    """Device tick: k steps per tick, one readback per tick."""
    acct = accounting.CarbonAccountant(accounting.AccountantConfig(
        device="h100_sxm", n_devices=1, grid_mix="NY"))
    eng = TrainEngine.for_lm(
        params, cfg, opt_cfg=opt, pipeline=_pipeline(),
        engine_cfg=TrainEngineConfig(steps_per_tick=STEPS_PER_TICK),
        accountant=acct)
    eng.run(WARMUP)
    eng.metrics_log.clear()
    _sync(dev)
    t0 = time.monotonic()
    last = eng.run(STEPS)
    wall = time.monotonic() - t0
    rep = acct.train_report()
    return {"steps": STEPS, "wall_s": round(wall, 4),
            "s_per_step": wall / STEPS, "final_loss": last["loss"],
            "steps_per_tick": STEPS_PER_TICK,
            "ticks": len(eng.metrics_log),
            "host_readbacks_per_step": eng.host_readbacks / (WARMUP + STEPS),
            "energy": {k: rep[k] for k in
                       ("fwd_j", "bwd_j", "opt_j", "total_j", "j_per_step",
                        "j_per_sample", "bwd_fwd_ratio")}}


def _grads(fn, *xs):
    xs = [x.detach().clone().requires_grad_(True) for x in xs]
    with torch.enable_grad():
        return torch.autograd.grad(fn(*xs), xs)


def _grad_parity(dev):
    """Gradients through the kernels' autograd Functions against autograd
    through the plain versions: max abs error."""
    rng = np.random.default_rng(0)

    def t(shape, dtype=np.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(dtype)) \
            .to(dev)

    b, sq, h, hkv, d = 2, 13, 4, 2, HEAD_DIM
    q, k, v = t((b, sq, h, d)), t((b, sq, hkv, d)), t((b, sq, hkv, d))
    ct = t((b, sq, h, d))
    gk = _grads(lambda q, k, v: (ops.flash_attention_train(
        q, k, v, scale=0.35) * ct).sum(), q, k, v)
    gr = _grads(lambda q, k, v: (ref.flash_attention_fwd_ref(
        q, k, v, scale=0.35)[0] * ct).sum(), q, k, v)
    flash_err = max(float((a - w).abs().max()) for a, w in zip(gk, gr))

    x = t((5, 48))
    qw = torch.from_numpy(rng.integers(-127, 128, (48, 24)).astype(
        np.int8)).to(dev)
    sc = torch.from_numpy(rng.uniform(0.01, 0.1, (24,)).astype(
        np.float32)).to(dev)
    ct2 = t((5, 24))
    gx, gs = _grads(lambda x, s: (ops.int8_matmul_train(x, qw, s)
                                  * ct2).sum(), x, sc)
    rx, rs = _grads(lambda x, s: ((x @ qw.float()) * s * ct2).sum(), x, sc)
    return {"flash_attention_max_abs_err": flash_err,
            "int8_matmul_max_abs_err": float((gx - rx).abs().max()),
            # dscale sums O(1e2-1e3) terms: its error over its max
            "int8_matmul_dscale_rel_err": float((gs - rs).abs().max()
                                                / rs.abs().max())}


def _update_parity(cfg, opt, dev):
    """Fused engine vs ``make_train_step`` after 4 identical steps."""
    eng = TrainEngine.for_lm(_params(cfg, dev), cfg, opt_cfg=opt,
                             pipeline=_pipeline(),
                             engine_cfg=TrainEngineConfig(steps_per_tick=4))
    eng.run(4)
    step = make_train_step(lambda p, b: tf_lib.loss_fn(p, cfg, b), opt)
    params = _params(cfg, dev)
    for p in flatten(params)[0]:
        p.requires_grad_(True)
    state = init_opt_state(params, opt)
    pipe = _pipeline()
    for i in range(4):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.batch_at(i).items()}
        params, state, _ = step(params, state, batch)
    return max(float((a.detach() - b.detach()).abs().max()) for a, b in
               zip(flatten(eng.params)[0], flatten(params)[0]))


def bench(out=OUT_PATH, device="cuda") -> dict:
    dev = device_lib.resolve(device)
    cfg = _cfg()
    opt = AdamWConfig(lr=1e-3)
    res = {
        "workload": {"d_model": D_MODEL, "head_dim": HEAD_DIM,
                     "layers": cfg.n_layers, "batch": BATCH,
                     "seq_len": SEQ, "steps": STEPS,
                     "regime": "edge on-line adaptation (small incremental "
                               "updates; step latency host-dominated)",
                     "device": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu")},
        "reference": _bench_reference(cfg, _params(cfg, dev), opt, dev),
        "fused": _bench_fused(cfg, _params(cfg, dev), opt, dev),
        "grad_parity_vs_ref": _grad_parity(dev),
        "update_parity_max_abs_diff": _update_parity(cfg, opt, dev),
    }
    res["speedup_s_per_step"] = (res["reference"]["s_per_step"]
                                 / res["fused"]["s_per_step"])
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=2))
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(OUT_PATH))
    args = ap.parse_args(argv)
    res = bench(out=args.out, device=args.device)
    print(json.dumps(res, indent=2))
    print(f"\nwrote {Path(args.out).resolve()}")
    print(f"step-time speedup: {res['speedup_s_per_step']:.2f}x; "
          f"update parity {res['update_parity_max_abs_diff']:.1e}; "
          f"flash grad err "
          f"{res['grad_parity_vs_ref']['flash_attention_max_abs_err']:.1e}; "
          f"int8 grad err "
          f"{res['grad_parity_vs_ref']['int8_matmul_max_abs_err']:.1e}")


if __name__ == "__main__":
    main()
