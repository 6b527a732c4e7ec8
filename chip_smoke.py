#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version at the main path's shapes, then drives the
dense and the paged serve paths of starcoder2-7b at full width and full
depth with random weights from a seed. Phases, each printing one JSON line;
any failure raises, so the script exits non-zero and prints no result:

1. device: the card's name and power limit (nvidia-smi), TF32 off;
2. build: every kernel source, one nvcc each, all started together;
3. kernels, each against its plain version (``kernels/ref.py``) in three
   dtype modes (fp32/fp32, bf16/bf16, bf16 q with fp32 K/V) and windows
   -1 and 256, with timings of the kernel, the plain version and one
   library call (masked ``F.scaled_dot_product_attention``, a yardstick
   the port never calls; for the paged kernels the gather through the
   table is part of that call):
   K1 at B=8, H=36, Hkv=4, D=128, Sk=2048; K2 at the same shapes through a
   permuted table of 128 pages of 16 per slot; K3 at 8 rows, C=256, ragged
   starts (unaligned ones too) and lengths (0 too);
4. streams: fp32 weights and cache, 4 requests x 16 greedy tokens; the
   dense engine (through K1) must be token-identical to the host-loop
   reference (through masked ``sdpa``), and the paged engine (K2, K3;
   page_size 16, prefill_chunk 64, no prefix cache) to the dense engine;
   a paged run with the prefix cache on requests that share a 128-token
   prefix must hit, and prints its agreement with the dense streams;
5. serve: bf16 weights, fp32 cache, 8 slots, max_len 2048, 16 requests of
   32-1024 prompt tokens and 64 new tokens each; the K1 launch count must be
   decode ticks x 32 layers;
6. paged serve: the same weights, page_size 16, prefill_chunk 256, prefix
   cache on, 16 requests of a shared 512-token prompt plus a 32-512-token
   tail; K2 launches must be decode ticks x 32, K3 launches extend calls x
   32, and the prefix cache must hit;
7. a ``kernels`` line, then the result line ``{"ok": true, "device": ...}``.

Needs one card and no network. Exits non-zero without a card, and outside a
checkout of the repository.
"""

from __future__ import annotations

import dataclasses
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


# (q dtype, K/V dtype, atol, rtol): the bf16 bounds cover one bf16 rounding
# of the output (2^-8 relative) with room; K3's rows of one or two live
# keys give O(1) outputs
MODES = (("float32", "float32", 1e-5, 0.0),
         ("bfloat16", "bfloat16", 5e-3, 1e-2),
         ("bfloat16", "float32", 5e-3, 1e-2))
WINDOWS = (-1, 256)
B, H, HKV, D = 8, 36, 4, 128
PAGE, N_BLOCKS = 16, 128                       # 2048 positions per slot
LENGTHS = (0, 1, 2048, 777, 1500, 33, 2047, 129)
STARTS = (0, 512, 1000, 37, 1777, 256, 100, 1200)
CHUNK_LENS = (256, 256, 200, 0, 256, 1, 128, 256)
CHUNK = 256


def _randn(gen, shape, dtype):
    import torch
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _decode_inputs(q_dtype, kv_dtype):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q = _randn(gen, (B, H, D), q_dtype)
    k = _randn(gen, (B, N_BLOCKS * PAGE, HKV, D), kv_dtype)
    v = _randn(gen, (B, N_BLOCKS * PAGE, HKV, D), kv_dtype)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device="cuda")
    return q, k, v, lengths


def _pool_inputs(gen, kv_dtype):
    """A pool of B * N_BLOCKS pages plus the sink, and a permuted
    (fragmented) page table over it."""
    import torch
    pages = B * N_BLOCKS
    k_pool = _randn(gen, (pages + 1, PAGE, HKV, D), kv_dtype)
    v_pool = _randn(gen, (pages + 1, PAGE, HKV, D), kv_dtype)
    table = torch.randperm(pages, generator=gen, device="cuda").to(
        torch.int32).reshape(B, N_BLOCKS)
    return k_pool, v_pool, table


def _paged_decode_inputs(q_dtype, kv_dtype):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    q = _randn(gen, (B, H, D), q_dtype)
    k_pool, v_pool, table = _pool_inputs(gen, kv_dtype)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device="cuda")
    return q, k_pool, v_pool, table, lengths


def _prefill_inputs(q_dtype, kv_dtype):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    q = _randn(gen, (B, CHUNK, H, D), q_dtype)
    k_new = _randn(gen, (B, CHUNK, HKV, D), q_dtype)
    v_new = _randn(gen, (B, CHUNK, HKV, D), q_dtype)
    k_pool, v_pool, table = _pool_inputs(gen, kv_dtype)
    starts = torch.tensor(STARTS, dtype=torch.int32, device="cuda")
    lens = torch.tensor(CHUNK_LENS, dtype=torch.int32, device="cuda")
    return q, k_new, v_new, k_pool, v_pool, table, starts, lens


def _peak(*tensors):
    import torch
    return (PEAK_FP32 if any(t.dtype == torch.float32 for t in tensors)
            else PEAK_BF16)


def _bound(nbytes, t_ops):
    """The larger of the bytes' time over the HBM rate and ``t_ops``
    seconds of operations, in ms, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _decode_bound(q, k, lengths, window, paged=False):
    """Least time of a decode call (K1, K2): the live K/V rows, q, the
    output and the lengths once each over the HBM rate (K2 adds the table
    entries of the live rows), or 4*live*H*D FLOPs over the inputs' peak
    (fp32 if any input is fp32)."""
    lens = lengths.tolist()
    los = [max(0, n - window) if window > 0 else 0 for n in lens]
    n_live = sum(n - lo for n, lo in zip(lens, los))
    b, h, d = q.shape
    hkv = k.shape[2]
    nbytes = (2 * n_live * hkv * d * k.element_size()
              + 2 * q.numel() * q.element_size() + 4 * b)
    if paged:
        nbytes += 4 * sum(-(-n // PAGE) - lo // PAGE
                          for n, lo in zip(lens, los) if n > 0)
    return _bound(nbytes, 4.0 * n_live * h * d / _peak(q, k))


def _prefill_bound(q, k_new, k_pool, starts, lens, window):
    """Least time of a K3 call: the live chunk tokens' q, k, v, the cached
    keys the live tokens attend (per row, [start - window + 1, start) or
    [0, start)), the output and the table entries once each over the HBM
    rate; or 4*D*H FLOPs per valid (query, key) pair, the pairs on cached
    keys over the peak of q's and the pool's types, those on the chunk's
    own keys over the peak of q's type (k_new, v_new share it)."""
    _, c, h, d = q.shape
    hkv = k_pool.shape[2]
    cached = cached_pairs = chunk_pairs = 0
    for start, ln in zip(starts.tolist(), lens.tolist()):
        if ln <= 0:
            continue
        lo = max(0, start - window + 1) if window > 0 else 0
        cached += start - lo
        for t in range(ln):
            if window > 0:      # keys with q_abs - k_abs < window
                cached_pairs += min(start, max(0, window - 1 - t))
                chunk_pairs += min(t + 1, window)
            else:
                cached_pairs += start
                chunk_pairs += t + 1
    live = int(lens.clamp(min=0).sum())
    nbytes = (live * (h + 2 * hkv) * d * q.element_size()
              + 2 * cached * hkv * d * k_pool.element_size()
              + q.numel() * q.element_size()
              + 4 * sum(-(-s // PAGE) for s in starts.tolist()) + 8 * B)
    return _bound(nbytes, 4.0 * h * d * (cached_pairs / _peak(q, k_pool)
                                         + chunk_pairs / _peak(q)))


def _library_decode(q, k, v, lengths, *, scale, window):
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


def _library_paged_decode(q, k_pool, v_pool, table, lengths, *, scale,
                          window):
    """The gather through the table, then the masked SDPA of K1's
    yardstick; the gather is part of the call."""
    from repro_torch.kernels import ref
    return _library_decode(q, ref.paged_gather(k_pool, table),
                           ref.paged_gather(v_pool, table), lengths,
                           scale=scale, window=window)


def _library_prefill(q, k_new, v_new, k_pool, v_pool, table, starts, lens, *,
                     scale, window):
    """The cached window gathered through the table and the chunk as one
    key set, then one masked SDPA over it (the gather, the concatenation
    and the mask are part of the call)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    k_all = ref.paged_gather(k_pool, table)
    v_all = ref.paged_gather(v_pool, table)
    c = q.shape[1]
    starts, lens = starts.long(), lens.long()
    j = torch.arange(k_all.shape[1], device=q.device)[None]
    rel = torch.arange(c, device=q.device)[None]
    q_abs = starts[:, None] + rel
    tags = torch.cat([torch.where(j < starts[:, None], j, -1),
                      torch.where(rel < lens[:, None], q_abs, -1)], dim=1)
    k_att = torch.cat([k_all, k_new.to(k_all.dtype)], dim=1)
    v_att = torch.cat([v_all, v_new.to(v_all.dtype)], dim=1)
    diff = q_abs[:, :, None] - tags[:, None, :]
    mask = (diff >= 0) & (tags >= 0)[:, None, :]
    if window > 0:
        mask &= diff < window
    return F.scaled_dot_product_attention(
        q.transpose(1, 2).to(k_att.dtype), k_att.transpose(1, 2),
        v_att.transpose(1, 2), attn_mask=mask[:, None], scale=scale,
        enable_gqa=True)


def _check_kernel(name, kernel, plain, library, inputs, bound, dead, cold,
                  iters):
    """Hold ``kernel`` against ``plain`` in every mode and window, time the
    kernel, the plain version and the library call, and return the main
    path's row (bf16 q, fp32 K/V, no window). ``inputs(q_dtype,
    kv_dtype)`` gives the call's tensors, the first being q; ``bound(args,
    window)`` is the least time; ``dead`` masks the output's leading dims
    where the kernel must write exact zeros; ``cold`` names the positions
    of the large tensors each timed call reads from its own copy."""
    import torch
    scale = D ** -0.5
    dead = dead.cuda()
    main = None
    for q_name, kv_name, atol, rtol in MODES:
        args = inputs(getattr(torch, q_name), getattr(torch, kv_name))
        for window in WINDOWS:
            got = kernel(*args, scale=scale, window=window)
            torch.cuda.synchronize()
            want = plain(*args, scale=scale, window=window)
            err = (got.float() - want.float()).abs()
            max_err = float(err.max())
            ok = bool((err <= atol + rtol * want.float().abs()).all())
            dead_zero = bool((got[dead] == 0).all())
            if not (ok and dead_zero and torch.isfinite(got).all()):
                raise AssertionError(
                    f"{name} disagrees with its plain version: q {q_name}, "
                    f"kv {kv_name}, window {window}: max abs err {max_err} "
                    f"(atol {atol}, rtol {rtol}), dead rows zero "
                    f"{dead_zero}")
            # each timed call reads its own copy of the cache: the 32
            # layers of a tick find their K/V cold in the 50 MB L2
            copies = [[a.clone() if i in cold else a
                       for i, a in enumerate(args)] for _ in range(4)]

            def timed(fn):
                return lambda i: fn(*copies[i % len(copies)], scale=scale,
                                    window=window)

            kernel_ms = cuda_ms(timed(kernel), iters)
            plain_ms = cuda_ms(timed(plain), max(iters // 4, 4))
            library_ms = cuda_ms(timed(library), max(iters // 2, 4))
            bound_ms, bound_by = bound(args, window)
            row = {"phase": "kernels", "kernel": name, "q": q_name,
                   "kv": kv_name, "window": window, "max_abs_err": max_err,
                   "atol": atol, "rtol": rtol, "ms": kernel_ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by}
            emit(row)
            del copies
            if (q_name, kv_name, window) == ("bfloat16", "float32", -1):
                main = row
    return main


def phase_kernels():
    """K1, K2 and K3 against their plain versions at the main path's
    shapes. Returns each kernel's main-path row."""
    import torch
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import paged_decode_attention as k2
    from repro_torch.kernels import paged_prefill_attention as k3
    from repro_torch.kernels import ref

    dead_slots = torch.tensor(LENGTHS) == 0
    rows = {}
    rows["decode_attention"] = _check_kernel(
        "decode_attention", k1.decode_attention, ref.decode_attention_ref,
        _library_decode, _decode_inputs,
        lambda a, w: _decode_bound(a[0], a[1], a[3], w), dead=dead_slots,
        cold=(1, 2), iters=48)
    rows["paged_decode_attention"] = _check_kernel(
        "paged_decode_attention", k2.paged_decode_attention,
        ref.paged_decode_attention_ref, _library_paged_decode,
        _paged_decode_inputs,
        lambda a, w: _decode_bound(a[0], a[1], a[4], w, paged=True),
        dead=dead_slots, cold=(1, 2), iters=48)
    rows["paged_prefill_attention"] = _check_kernel(
        "paged_prefill_attention", k3.paged_prefill_attention,
        ref.paged_prefill_attention_ref, _library_prefill, _prefill_inputs,
        lambda a, w: _prefill_bound(a[0], a[1], a[3], a[6], a[7], w),
        dead=torch.arange(CHUNK)[None] >= torch.tensor(CHUNK_LENS)[:, None],
        cold=(3, 4), iters=16)
    return rows


def _shared_prefix_prompts(rng, vocab, prefix, tails):
    import numpy as np
    head = rng.integers(0, vocab, prefix)
    return [np.concatenate([head, rng.integers(0, vocab, n)]) for n in tails]


def _drain(eng, prompts, max_tokens):
    for p in prompts:
        eng.submit(p, max_tokens=max_tokens)
    return {r.uid: r.generated for r in eng.run_until_drained()}


def phase_streams():
    """fp32 full width: the dense engine through K1 vs the host-loop
    reference through masked sdpa, and the paged engine through K2 and K3
    vs the dense engine, token for token; then a prefix-cache run."""
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
    got = _drain(ServeEngine(params, cfg, scfg), prompts, 16)
    want = _drain(ReferenceEngine(params, cfg, scfg), prompts, 16)
    if got != want or any(len(s) != 16 for s in got.values()):
        raise AssertionError(f"fp32 streams differ: engine {got}, "
                             f"reference {want}")
    paged_cfg = dataclasses.replace(scfg, paged=True, page_size=PAGE,
                                    prefill_chunk=64, prefix_cache=False)
    paged = _drain(ServeEngine(params, cfg, paged_cfg), prompts, 16)
    if paged != got:
        raise AssertionError(f"fp32 paged streams differ from the dense "
                             f"engine's: paged {paged}, dense {got}")
    # two slots, so the later requests find the first ones' published
    # prefix blocks
    shared = _shared_prefix_prompts(rng, cfg.vocab, 128, (9, 40, 77, 130))
    dense_shared = _drain(ServeEngine(params, cfg, scfg), shared, 16)
    eng = ServeEngine(params, cfg, dataclasses.replace(
        paged_cfg, max_slots=2, prefix_cache=True))
    hit_streams = _drain(eng, shared, 16)
    hits = eng.summary()["prefix_hit_tokens"]
    if hits <= 0:
        raise AssertionError("the prefix-cache run hit no prefix block")
    same = sum(a == b for u in dense_shared
               for a, b in zip(dense_shared[u], hit_streams[u]))
    emit({"phase": "streams", "dtype": "float32", "requests": len(prompts),
          "tokens_each": 16, "identical": True, "paged_identical": True,
          "prefix_hit_tokens": hits,
          "prefix_run_agreement": same / (16 * len(shared)),
          "init_s": init_s, "param_gb": costing.tree_bytes(params) / 1e9})
    del params, eng


def _serve_report(eng, acct, done, n_requests, n_new):
    import torch
    s = eng.summary()
    rep = acct.report()
    decode_ticks = sum(1 for m in eng.metrics_log if m.active_slots > 0)
    extends = sum(1 for m in eng.metrics_log if m.prefill_tokens > 0)
    if len(done) != n_requests or any(len(r.generated) != n_new
                                      for r in done):
        raise AssertionError("serve run did not finish every request")
    return decode_ticks, extends, s, {
        "dtype": "bfloat16", "cache": "float32", "requests": n_requests,
        "new_tokens_each": n_new,
        "decode_tokens_per_s": s["decode_tokens_per_s"],
        "decode_tokens": s["decode_tokens"],
        "prefill_tokens": s["prefill_tokens"], "ticks": s["ticks"],
        "decode_ticks": decode_ticks,
        "ms_per_decode_tick": 1e3 * (s["wall_s"] - s["prefill_wall_s"])
        / max(decode_ticks, 1),
        "prefill_ms_per_admission": 1e3 * s["prefill_wall_s"]
        / max(extends, 1),
        "admissions": extends,
        "modeled_j_per_token": rep["modeled_j_per_token"],
        "bytes_moved": rep["bytes_moved"],
        "host_readbacks": eng.host_readbacks,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_serve():
    """bf16 full width, the dense serve loop billed to h100_sxm. Returns
    the bf16 params (the paged phase reuses them) and K1's launches."""
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
    decode_ticks, _, _, row = _serve_report(eng, acct, done, 16, 64)
    if launches != decode_ticks * N_LAYERS:
        raise AssertionError(f"K1 launches {launches} != decode ticks "
                             f"{decode_ticks} x {N_LAYERS}")
    emit({"phase": "serve", **row, "k1_launches": launches})
    return cfg, params, launches


def phase_paged_serve(cfg, params):
    """bf16 weights, fp32 pool: the paged serve loop with the prefix cache
    on shared-prompt traffic. Returns K2's and K3's launches."""
    import numpy as np
    import torch
    from repro_torch.core import accounting
    from repro_torch.kernels import paged_decode_attention as k2
    from repro_torch.kernels import paged_prefill_attention as k3
    from repro_torch.serve import ServeConfig, ServeEngine
    acct = accounting.CarbonAccountant(accounting.AccountantConfig(
        device="h100_sxm", n_devices=1))
    eng = ServeEngine(params, cfg, ServeConfig(
        max_slots=8, max_len=2048, device="cuda", paged=True,
        page_size=PAGE, prefill_chunk=256, prefix_cache=True),
        accountant=acct)
    rng = np.random.default_rng(SEED + 3)
    tails = [int(n) for n in rng.integers(32, 513, 16)]
    for p in _shared_prefix_prompts(rng, cfg.vocab, 512, tails):
        eng.submit(p, max_tokens=64)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k2.paged_decode_attention.launches = 0
    k3.paged_prefill_attention.launches = 0
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    launches = (k2.paged_decode_attention.launches,
                k3.paged_prefill_attention.launches)
    decode_ticks, extends, s, row = _serve_report(eng, acct, done, 16, 64)
    if launches != (decode_ticks * N_LAYERS, extends * N_LAYERS):
        raise AssertionError(
            f"K2/K3 launches {launches} != (decode ticks {decode_ticks}, "
            f"extend calls {extends}) x {N_LAYERS}")
    if s["prefix_hit_tokens"] <= 0:
        raise AssertionError("the paged serve run hit no prefix block")
    emit({"phase": "paged_serve", **row, "page_size": PAGE,
          "prefill_chunk": 256, "pool_pages": s["pool_pages"],
          "prefix_hit_tokens": s["prefix_hit_tokens"],
          "prefix_hit_rate": s["prefix_hit_rate"],
          "prefill_gather_bytes": s["prefill_gather_bytes"],
          "k2_launches": launches[0], "k3_launches": launches[1]})
    return launches


KERNELS = (
    ("decode_attention", "src/repro/kernels/decode_attention.py:122"),
    ("paged_decode_attention", "src/repro/kernels/decode_attention.py:245"),
    ("paged_prefill_attention", "src/repro/kernels/flash_attention.py:494"),
)


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
    rows = phase_kernels()
    phase_streams()
    torch.cuda.empty_cache()
    cfg, params, k1_launches = phase_serve()
    torch.cuda.empty_cache()
    k2_launches, k3_launches = phase_paged_serve(cfg, params)
    launches = {"decode_attention": k1_launches,
                "paged_decode_attention": k2_launches,
                "paged_prefill_attention": k3_launches}
    emit({"phase": "total", "seconds": time.monotonic() - t0})
    emit({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": rows[name]["max_abs_err"], "ms": rows[name]["ms"],
        "plain_ms": rows[name]["plain_ms"],
        "bound_ms": rows[name]["bound_ms"],
        "bound_by": rows[name]["bound_by"],
        "library_ms": rows[name]["library_ms"]}
        for name, replaces in KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
