"""Accuracy oracles for the serving fast paths (mirror of
``repro.serve.quality``).

The full-precision model is the ground truth; the int8 fast path must stay
bounded against it. ``token_agreement`` is teacher-forced, so one early
argmax flip cannot cascade into a meaningless whole-suffix mismatch: both
models decode the same token stream (the full-precision greedy trajectory)
and each step compares the next-token argmax each would emit, plus the
worst logit gap.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import transformer as tf_lib

PyTree = Any


def token_agreement(params: PyTree, cfg: tf_lib.LMConfig,
                    prompts: np.ndarray, n_tokens: int,
                    qparams: PyTree = None) -> Dict[str, float]:
    """Teacher-forced greedy agreement, int8 fast path vs full precision.

    ``prompts``: (B, L) equal-length prompt batch. Both models prefill the
    batch into fp32 caches (the int8 model's cache holds codes and
    scales), then decode ``n_tokens`` steps at a shared scalar position,
    feeding the full-precision greedy token back to BOTH. Returns the
    agreement fraction, the token count and the max |logit| gap. Runs on
    the device ``params`` live on; ``qparams`` (already quantized) saves
    quantizing again.
    """
    dev = params["embed"]["w"].device
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                              device=dev)
    b, plen = prompts.shape
    max_len = plen + n_tokens + 1
    fp_cfg = dataclasses.replace(cfg, quant=tf_lib.QuantPolicy())
    q_cfg = dataclasses.replace(cfg, quant=tf_lib.INT8_QUANT)
    qparams = tf_lib.quantize_lm(params) if qparams is None else qparams

    lg_fp, cc_fp = tf_lib.prefill(params, fp_cfg, prompts, max_len=max_len,
                                  cache_dtype=torch.float32)
    lg_q, cc_q = tf_lib.prefill(qparams, q_cfg, prompts, max_len=max_len,
                                cache_dtype=torch.float32)
    agree = total = 0
    max_gap = 0.0
    for t in range(n_tokens):
        a_fp = torch.argmax(lg_fp[:, 0], dim=-1)
        a_q = torch.argmax(lg_q[:, 0], dim=-1)
        agree += int((a_fp == a_q).sum())
        total += b
        max_gap = max(max_gap, float((lg_fp - lg_q).abs().max()))
        if t == n_tokens - 1:
            break
        cur = a_fp[:, None]              # teacher forcing: fp greedy drives
        pos = torch.tensor(plen + t, device=dev)
        lg_fp, cc_fp = tf_lib.decode_step(params, fp_cfg, cur, pos, cc_fp)
        lg_q, cc_q = tf_lib.decode_step(qparams, q_cfg, cur, pos, cc_q)
    return {"agreement": agree / total, "tokens": total,
            "max_logit_gap": max_gap}


def run_workload(engine, prompts, max_tokens: int = 8,
                 max_ticks: int = 10000) -> Dict[int, list]:
    """Submit ``prompts`` in order and drain — the shared driver for
    engine-vs-engine comparisons. Returns {uid: generated tokens}."""
    for p in prompts:
        engine.submit(np.asarray(p, np.int32), max_tokens=max_tokens)
    done = engine.run_until_drained(max_ticks=max_ticks)
    return {r.uid: list(r.generated) for r in done}


def generation_agreement(got: Dict[int, list], want: Dict[int, list]
                         ) -> Dict[str, float]:
    """Position-wise token agreement between two engines' outputs on the
    same workload (matched by request uid). ``identical`` is 1.0 iff every
    stream matches token for token (including lengths)."""
    if set(got) != set(want):
        raise ValueError(f"different requests: {sorted(got)} vs "
                         f"{sorted(want)}")
    agree = total = 0
    ident = True
    for uid in got:
        a, b = got[uid], want[uid]
        ident &= a == b
        total += max(len(a), len(b))
        agree += sum(1 for x, y in zip(a, b) if x == y)
    return {"agreement": agree / total if total else 1.0,
            "tokens": total,
            "identical": 1.0 if ident else 0.0}
