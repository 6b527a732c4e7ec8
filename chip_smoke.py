#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version at the main path's shapes, then drives the
dense serve path of starcoder2-7b at full width and full depth with random
weights from a seed. Phases, each printing one JSON line; any failure raises,
so the script exits non-zero and prints no result:

1. device: the card's name and power limit (nvidia-smi), TF32 off;
2. kernels: K1 vs ``decode_attention_ref`` at B=8, H=36, Hkv=4, D=128,
   Sk=2048, with timings of the kernel, the plain version and one library
   call (masked ``F.scaled_dot_product_attention``, a yardstick the port
   never calls);
3. streams: fp32 weights and cache, 4 requests x 16 greedy tokens; the
   engine (through K1) must be token-identical to the host-loop reference
   (through masked ``sdpa``);
4. serve: bf16 weights, fp32 cache, 8 slots, max_len 2048, 16 requests of
   32-1024 prompt tokens and 64 new tokens each; the K1 launch count must be
   decode ticks x 32 layers;
5. a ``kernels`` line, then the result line ``{"ok": true, "device": ...}``.

Needs one card and no network. Exits non-zero without a card, and outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0
# dense device peaks of one H100 SXM at its full 700 W limit (NVIDIA's data
# sheet): bytes/s of HBM3, FLOP/s in fp32 outside the tensor cores and in
# bf16 on them
HBM_BYTES_PER_S = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
N_LAYERS = 32


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn(i)`` over calls i = 0 .. iters-1 after a
    warm-up, from CUDA events."""
    import torch
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})


def phase_build():
    from repro_torch.kernels import build
    t0 = time.monotonic()
    build.build()
    ptxas = [line.strip() for name in build.SOURCES
             for line in build.build_log(name).splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "sources": list(build.SOURCES), "ptxas": ptxas})


def _decode_inputs(q_dtype, kv_dtype):
    import torch
    b, h, hkv, d, sk = 8, 36, 4, 128, 2048
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn((b, h, d), generator=gen, device="cuda").to(q_dtype)
    k = torch.randn((b, sk, hkv, d), generator=gen, device="cuda").to(kv_dtype)
    v = torch.randn((b, sk, hkv, d), generator=gen, device="cuda").to(kv_dtype)
    lengths = torch.tensor([0, 1, 2048, 777, 1500, 33, 2047, 129],
                           dtype=torch.int32, device="cuda")
    return q, k, v, lengths


def _decode_bound(q, k, lengths, window):
    """Least time for the call: live K/V rows, q and the output once each
    over the HBM rate, or 4*live*H*D FLOPs over the input type's peak."""
    live = lengths.clamp(max=window) if window > 0 else lengths
    n_live = int(live.sum())
    b, h, d = q.shape
    hkv = k.shape[2]
    nbytes = (2 * n_live * hkv * d * k.element_size()
              + 2 * q.numel() * q.element_size() + 4 * b)
    ops = 4.0 * n_live * h * d
    import torch
    peak = PEAK_BF16 if torch.float32 not in (q.dtype, k.dtype) else PEAK_FP32
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _library_call(q, k, v, lengths, *, scale, window):
    """Masked F.scaled_dot_product_attention on the same inputs (timed as a
    yardstick only; K/V views in its (B, Hkv, Sk, D) layout; mask building
    is part of the call)."""
    import torch
    import torch.nn.functional as F
    sk = k.shape[1]
    pos = torch.arange(sk, device=q.device)[None]
    mask = pos < lengths[:, None]
    if window > 0:
        mask &= (lengths[:, None] - 1 - pos) < window
    mask = mask[:, None, None, :]
    qs = q[:, :, None].to(k.dtype)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    return F.scaled_dot_product_attention(
        qs, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True)


def phase_kernels():
    """K1 vs its plain version at the main path's shapes. Returns the main
    path's entry (bf16 queries from bf16 weights, fp32 cache)."""
    import torch
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import ref
    scale = 128 ** -0.5
    main = None
    cases = [(torch.float32, torch.float32, 1e-5, 0.0),
             (torch.bfloat16, torch.bfloat16, 2e-2, 1e-2),
             (torch.bfloat16, torch.float32, 2e-2, 1e-2)]
    for q_dtype, kv_dtype, atol, rtol in cases:
        q, k, v, lengths = _decode_inputs(q_dtype, kv_dtype)
        for window in (-1, 256):
            got = k1.decode_attention(q, k, v, lengths, scale=scale,
                                      window=window)
            torch.cuda.synchronize()
            want = ref.decode_attention_ref(q, k, v, lengths, scale=scale,
                                            window=window)
            err = (got.float() - want.float()).abs()
            max_err = float(err.max())
            ok = bool((err <= atol + rtol * want.float().abs()).all())
            dead = lengths == 0
            dead_zero = bool((got[dead] == 0).all())
            if not (ok and dead_zero and torch.isfinite(got).all()):
                raise AssertionError(
                    f"K1 disagrees with its plain version: q {q_dtype}, kv "
                    f"{kv_dtype}, window {window}: max abs err {max_err} "
                    f"(atol {atol}, rtol {rtol}), dead rows zero "
                    f"{dead_zero}")
            # each timed call reads its own copy of the cache: the decode
            # tick's 32 layers find their K/V cold in the 50 MB L2
            kv = [(k.clone(), v.clone()) for _ in range(4)]

            def timed(fn):
                return lambda i: fn(q, *kv[i % len(kv)], lengths,
                                    scale=scale, window=window)

            kernel_ms = cuda_ms(timed(k1.decode_attention), 48)
            plain_ms = cuda_ms(timed(ref.decode_attention_ref), 12)
            library_ms = cuda_ms(timed(_library_call), 24)
            bound_ms, bound_by = _decode_bound(q, k, lengths, window)
            row = {"phase": "kernels", "kernel": "decode_attention",
                   "q": str(q_dtype), "kv": str(kv_dtype), "window": window,
                   "max_abs_err": max_err, "atol": atol, "rtol": rtol,
                   "ms": kernel_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by}
            emit(row)
            if q_dtype == torch.bfloat16 and kv_dtype == torch.float32 \
                    and window == -1:
                main = row
    return main


def phase_streams():
    """fp32 full width: the engine through K1 vs the host-loop reference
    through masked sdpa, token for token."""
    import numpy as np
    import torch
    from repro_torch.configs import starcoder2_7b
    from repro_torch.models import costing
    from repro_torch.models import transformer as tf_lib
    from repro_torch.serve import ReferenceEngine, ServeConfig, ServeEngine
    cfg = starcoder2_7b.make_config()
    t0 = time.monotonic()
    params = tf_lib.init_lm(cfg, seed=SEED, dtype=torch.float32,
                            device="cuda")
    init_s = time.monotonic() - t0
    scfg = ServeConfig(max_slots=4, max_len=512, device="cuda")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (17, 64, 130, 250)]
    eng = ServeEngine(params, cfg, scfg)
    ref = ReferenceEngine(params, cfg, scfg)
    for p in prompts:
        eng.submit(p, max_tokens=16)
        ref.submit(p, max_tokens=16)
    got = {r.uid: r.generated for r in eng.run_until_drained()}
    want = {r.uid: r.generated for r in ref.run_until_drained()}
    if got != want or any(len(s) != 16 for s in got.values()):
        raise AssertionError(f"fp32 streams differ: engine {got}, "
                             f"reference {want}")
    emit({"phase": "streams", "dtype": "float32", "requests": len(prompts),
          "tokens_each": 16, "identical": True, "init_s": init_s,
          "param_gb": costing.tree_bytes(params) / 1e9})
    del params, eng, ref


def phase_serve():
    """bf16 full width, the serve loop billed to h100_sxm; returns K1's
    launches in the run."""
    import numpy as np
    import torch
    from repro_torch.configs import starcoder2_7b
    from repro_torch.core import accounting
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.models import transformer as tf_lib
    from repro_torch.serve import ServeConfig, ServeEngine
    cfg = starcoder2_7b.make_config()
    params = tf_lib.init_lm(cfg, seed=SEED, dtype=torch.bfloat16,
                            device="cuda")
    acct = accounting.CarbonAccountant(accounting.AccountantConfig(
        device="h100_sxm", n_devices=1))
    eng = ServeEngine(params, cfg, ServeConfig(max_slots=8, max_len=2048,
                                               device="cuda"),
                      accountant=acct)
    rng = np.random.default_rng(SEED)
    for _ in range(16):
        eng.submit(rng.integers(0, cfg.vocab, int(rng.integers(32, 1025))),
                   max_tokens=64)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.decode_attention.launches = 0
    done = eng.run_until_drained()
    launches = k1.decode_attention.launches
    s = eng.summary()
    rep = acct.report()
    decode_ticks = sum(1 for m in eng.metrics_log if m.active_slots > 0)
    admissions = sum(1 for m in eng.metrics_log if m.admitted > 0)
    if len(done) != 16 or any(len(r.generated) != 64 for r in done):
        raise AssertionError("serve run did not finish every request")
    if launches != decode_ticks * N_LAYERS:
        raise AssertionError(f"K1 launches {launches} != decode ticks "
                             f"{decode_ticks} x {N_LAYERS}")
    emit({"phase": "serve", "dtype": "bfloat16", "cache": "float32",
          "requests": 16, "new_tokens_each": 64,
          "decode_tokens_per_s": s["decode_tokens_per_s"],
          "decode_tokens": s["decode_tokens"],
          "prefill_tokens": s["prefill_tokens"], "ticks": s["ticks"],
          "decode_ticks": decode_ticks,
          "ms_per_decode_tick": 1e3 * (s["wall_s"] - s["prefill_wall_s"])
          / max(decode_ticks, 1),
          "prefill_ms_per_admission": 1e3 * s["prefill_wall_s"]
          / max(admissions, 1),
          "admissions": admissions,
          "modeled_j_per_token": rep["modeled_j_per_token"],
          "bytes_moved": rep["bytes_moved"],
          "host_readbacks": eng.host_readbacks,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "k1_launches": launches})
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        raise SystemExit("chip_smoke: PyTorch is not installed")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures "
                         "the port on a card and has no CPU mode")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: {SRC / 'repro_torch'} not found; run "
                         f"from a checkout of the repository")
    sys.path.insert(0, str(SRC))
    t0 = time.monotonic()
    phase_device()
    phase_build()
    k1_main = phase_kernels()
    phase_streams()
    torch.cuda.empty_cache()
    launches = phase_serve()
    emit({"phase": "total", "seconds": time.monotonic() - t0})
    emit({"kernels": [{
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:122",
        "launches": launches, "max_abs_err": k1_main["max_abs_err"],
        "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"],
        "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"],
        "library_ms": k1_main["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
