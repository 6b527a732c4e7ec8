"""Serving launcher of the PyTorch port: batched request serving with
carbon accounting (mirror of ``repro.launch.serve``, dense and paged
paths).

    python -m repro_torch.launch.serve --arch starcoder2-7b \\
        [--smoke] [--repeats R] [--device cpu] --requests 8 --max-tokens 16 \\
        [--prompt-len 4 12] [--profile-ticks N] [--quant int8] \\
        [--paged [--page-size 16] [--num-pages N] [--no-prefix-cache] \\
         [--prefill-chunk C] [--compact-threshold F] [--evict-policy cost] \\
         [--spec-k K [--spec-drafter oracle | --spec-tree-m M]] \\
         [--nbest N]] [--fault-kind KIND [--fault-tick T] [--fault-seed S]] \\
        [--deadline-ticks D] [--checkpoint-dir DIR
         [--checkpoint-interval N] [--resume]]

Runs on the card unless ``--device cpu`` is given. The full-width model is
built in bf16 from a seed; ``--smoke`` builds the arch's reduced config in
fp32. ``--arch`` takes every LM arch of the port's registry: starcoder2-7b
and the dense family beyond it, gemma3-27b (head dim 168, 5 sliding-window
layers of 1024 to 1 global), granite-34b (MQA), qwen1.5-110b (QKV bias,
untied head) and qwen2-vl-72b (M-RoPE; its text tokens on three equal
position streams), and the MoE family, moonshot-v1-16b-a3b (64 experts,
top-6) and kimi-k2-1t-a32b (384 experts, top-8, head dim 112), whose
blocks drop routes past their capacity on every path, and the SSD/hybrid
family, mamba2-1.3b (48 SSD blocks, no attention) and zamba2-7b (81
slots: 13 x (5 SSD blocks and a site of the one shared attention block of
32 heads of 112) and 3 SSD blocks), on the dense path only (``--paged``
raises ``NotImplementedError``, as the reference does): their admissions
prefill equal-length prompts together, unpadded. ``--repeats R`` cuts
the depth to R repeats of the arch's layer pattern (its tail stays), the
width untouched: one card holds qwen1.5-110b's full width at a few layers,
not its 80, and kimi-k2-1t-a32b's at one. On the card the carbon report bills ``h100_sxm``; on the CPU the
report's wall-time-derived keys are left out, since CPU seconds say
nothing about the card's joules.

``--quant int8`` serves through the quantized fast path (int8 weights
through K4, an int8 KV cache through the int8-KV modes of K1-K3); the
carbon report's bytes moved and modeled J/token fall against the
unquantized run of the same workload.

``--spec-k K`` (paged only) decodes speculatively: K drafted tokens per
slot per tick, verified in one multi-query pass (K5 on the card); the run
prints its accept rate, emitted tokens per slot-tick and modeled J per
accepted token. ``--spec-tree-m M`` (with ``--spec-k``, the ngram
drafter) verifies M draft branches per greedy slot in that one pass, over
copy-on-write forked write windows, and commits the one that emits the
most.

``--nbest N`` (paged only) prefills each prompt once and forks it into N
streams that share the prompt's pages copy-on-write; each request prints
its N streams and the run its forks, page copies and the duplicate KV the
forks did not write.

``--fault-kind KIND`` replays one seeded fault of the chaos tier at tick
``--fault-tick`` (seed ``--fault-seed``) and prints what was injected,
quarantined and shed, the recovery bill and the degraded ticks;
``process_kill`` needs ``--checkpoint-dir``: the killed engine is
replaced by a fresh one that restores from the directory and serves on.
``--deadline-ticks D`` sheds a request still queued D ticks after its
submission. The summary's chaos keys (``faults_injected``, ``shed``,
``shed_rate``, ``degraded_ticks``, ``readback_retries``, ``fp_fallbacks``,
``compaction_pauses``, ``audit_failures``) are printed in every run.

``--checkpoint-dir DIR`` turns the durability tier on: every submit is
journaled (fsync'd) before it is acked and every ``--checkpoint-interval``
ticks the engine is snapshotted there; ``--resume`` restores from the
directory before serving (the latest snapshot, then the journal's tail).
The run prints a ``durability:`` line: snapshots and their bytes, journal
bytes, the write joules and the ticks replayed on restore.

``--profile-ticks N`` runs N decode ticks under ``torch.profiler`` once
every slot is decoding and prints the kernels with the most device time
and the device's busy share of those ticks' wall time.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.configs import base as cfgbase
from repro_torch.core import accounting
from repro_torch.models import transformer as tf_lib
from repro_torch.serve import (FAULT_KINDS, FaultPlan, ProcessKilled,
                               Scheduler, SchedulerConfig, ServeConfig,
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


def validate_args(ap: argparse.ArgumentParser,
                  args: argparse.Namespace) -> None:
    """Reject flag combinations that make no sense, with a usage line,
    before any device work (the engine would raise too, but deep in its
    constructor). The JAX launcher's checks and messages, then the port's
    own (the request and prompt shapes, ``--profile-ticks``)."""
    if args.spec_k < 0:
        ap.error(f"--spec-k must be >= 0, got {args.spec_k}")
    if args.page_size <= 0:
        ap.error(f"--page-size must be > 0, got {args.page_size}")
    if args.prefill_chunk < 0:
        ap.error(f"--prefill-chunk must be >= 0, got {args.prefill_chunk}")
    if (args.paged and args.prefill_chunk > 0
            and args.prefill_chunk % args.page_size != 0):
        ap.error(f"--prefill-chunk ({args.prefill_chunk}) must be a "
                 f"multiple of --page-size ({args.page_size}) in paged "
                 f"mode: chunk boundaries must land on page boundaries")
    if not (0.0 <= args.compact_threshold <= 1.0):
        ap.error(f"--compact-threshold must be in [0, 1], got "
                 f"{args.compact_threshold}")
    if args.num_pages is not None and args.num_pages <= 0:
        ap.error(f"--num-pages must be > 0, got {args.num_pages}")
    if args.spec_k > 0 and not args.paged:
        ap.error("--spec-k requires --paged (speculative decode runs on "
                 "the paged path only)")
    if args.fault_kind is not None and args.fault_tick < 0:
        ap.error(f"--fault-tick must be >= 0, got {args.fault_tick}")
    if args.deadline_ticks is not None and args.deadline_ticks <= 0:
        ap.error(f"--deadline-ticks must be > 0, got {args.deadline_ticks}")
    if args.nbest < 1:
        ap.error(f"--nbest must be >= 1, got {args.nbest}")
    if args.nbest > 1 and not args.paged:
        ap.error("--nbest requires --paged (n-best sampling forks the "
                 "paged KV cache)")
    if args.nbest > args.slots:
        ap.error(f"--nbest ({args.nbest}) cannot exceed --slots "
                 f"({args.slots}): every fork decodes concurrently")
    if args.spec_tree_m < 1:
        ap.error(f"--spec-tree-m must be >= 1, got {args.spec_tree_m}")
    if args.spec_tree_m > 1 and args.spec_k <= 0:
        ap.error("--spec-tree-m > 1 requires --spec-k > 0 (tree "
                 "speculation rides the speculative verify pass)")
    if args.spec_tree_m > 1 and args.spec_drafter != "ngram":
        ap.error("--spec-tree-m > 1 drafts with the ngram drafter only")
    if args.checkpoint_interval < 0:
        ap.error(f"--checkpoint-interval must be >= 0, got "
                 f"{args.checkpoint_interval}")
    if args.checkpoint_interval > 0 and args.checkpoint_dir is None:
        ap.error("--checkpoint-interval requires --checkpoint-dir "
                 "(snapshots need somewhere durable to land)")
    if args.resume and args.checkpoint_dir is None:
        ap.error("--resume requires --checkpoint-dir (restore loads the "
                 "snapshot + journal written there)")
    if args.fault_kind == "process_kill" and args.checkpoint_dir is None:
        ap.error("--fault-kind process_kill requires --checkpoint-dir: "
                 "the kill is only survivable with a snapshot + journal "
                 "to restart from")
    if args.requests < 0 or args.max_tokens < 1 or args.slots < 1:
        ap.error("--requests >= 0, --max-tokens >= 1 and --slots >= 1")
    lo, hi = args.prompt_len
    if not 1 <= lo < hi or hi > args.max_len:
        ap.error("--prompt-len needs 1 <= LO < HI <= --max-len")
    if args.profile_ticks < 0:
        ap.error("--profile-ticks must be >= 0")
    if args.repeats is not None and args.repeats < 1:
        ap.error(f"--repeats must be >= 1, got {args.repeats}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config, in fp32")
    ap.add_argument("--repeats", type=int, default=None,
                    help="cut the depth to this many repeats of the arch's "
                         "layer pattern (the tail stays; default: all)")
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
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache with prefix reuse")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (paged mode)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="pool capacity in pages (default: dense-equivalent)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable prefix block reuse")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="admit prompts in chunks of this many tokens, "
                         "interleaved with decode ticks (0 = whole prompt)")
    ap.add_argument("--compact-threshold", type=float, default=0.0,
                    help="compact a slot's private page suffix into a "
                         "contiguous run when its page-table fragmentation "
                         "reaches this score in [0, 1] (paged mode; 0 = "
                         "compaction off)")
    ap.add_argument("--evict-policy", default="lru", choices=("lru", "cost"),
                    help="parked-prefix reclamation: lru evicts the least-"
                         "recently-parked block; cost evicts the cheapest-"
                         "to-recompute block first")
    ap.add_argument("--quant", default="none", choices=("none", "int8"),
                    help="int8: serve through the quantized fast path "
                         "(int8 weights + int8 KV cache)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decode: draft this many tokens per "
                         "tick and verify them in one multi-query pass "
                         "(paged mode only; 0 = off)")
    ap.add_argument("--spec-drafter", default="ngram",
                    choices=("ngram", "oracle"),
                    help="ngram: prompt-lookup self-drafting; oracle: the "
                         "target model drafts itself (parity harness)")
    ap.add_argument("--spec-tree-m", type=int, default=1,
                    help="tree speculation: verify this many draft branches "
                         "per greedy slot in the one verify pass and commit "
                         "the one that emits the most (1 = linear; needs "
                         "--spec-k)")
    ap.add_argument("--nbest", type=int, default=1,
                    help="n-best sampling: fork each request into this many "
                         "streams sharing its prompt's pages copy-on-write "
                         "(paged mode only)")
    ap.add_argument("--fault-kind", default=None, choices=FAULT_KINDS,
                    help="chaos tier: inject one seeded fault of this kind "
                         "and exercise the degradation ladder (default: no "
                         "injection)")
    ap.add_argument("--fault-tick", type=int, default=2,
                    help="engine tick at which the fault fires")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the fault's random choices")
    ap.add_argument("--deadline-ticks", type=int, default=None,
                    help="per-request deadline in ticks; a request still "
                         "queued past it is shed, not served late")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="durability tier: journal every admission "
                         "(fsync'd) and snapshot the engine here; a killed "
                         "engine restarts from it with the same streams "
                         "(--resume)")
    ap.add_argument("--checkpoint-interval", type=int, default=0,
                    help="snapshot every N ticks (0 = journal only; needs "
                         "--checkpoint-dir). Smaller: less replay after a "
                         "crash, more write energy")
    ap.add_argument("--resume", action="store_true",
                    help="restore from --checkpoint-dir before serving: "
                         "load the latest snapshot, replay the journal's "
                         "tail, resume the requests mid-stream")
    args = ap.parse_args(argv)
    validate_args(ap, args)

    dev = device_lib.resolve(args.device)
    arch = cfgbase.get(args.arch)
    if arch.kind != "lm":
        raise SystemExit(f"serve launcher supports LM archs; {args.arch} is "
                         f"{arch.kind}")
    cfg = arch.make_smoke() if args.smoke else arch.make_config()
    if args.repeats is not None:
        cfg = dataclasses.replace(cfg, repeats=args.repeats)
    dtype = torch.float32 if args.smoke else torch.bfloat16
    params = tf_lib.init_lm(cfg, seed=args.seed, dtype=dtype, device=dev)
    acct = accounting.CarbonAccountant(accounting.AccountantConfig(
        device="h100_sxm", n_devices=1, grid_mix=args.grid_mix))
    scfg = ServeConfig(max_slots=args.slots, max_len=args.max_len,
                       temperature=args.temperature, seed=args.seed,
                       device=str(dev), paged=args.paged,
                       page_size=args.page_size, num_pages=args.num_pages,
                       prefix_cache=not args.no_prefix_cache,
                       prefill_chunk=args.prefill_chunk,
                       compact_threshold=args.compact_threshold,
                       evict_policy=args.evict_policy, quant=args.quant,
                       spec_k=args.spec_k, spec_drafter=args.spec_drafter,
                       spec_tree_m=args.spec_tree_m,
                       faults=(FaultPlan.single(args.fault_kind,
                                                tick=args.fault_tick,
                                                seed=args.fault_seed)
                               if args.fault_kind else None),
                       checkpoint_dir=args.checkpoint_dir,
                       checkpoint_interval=args.checkpoint_interval)

    def build() -> ServeEngine:
        return ServeEngine(params, cfg, scfg, accountant=acct,
                           scheduler=Scheduler(SchedulerConfig(
                               policy=args.policy)))

    try:    # the engine checks how the paged flags combine
        eng = build()
    except ValueError as e:
        ap.error(str(e))
    done = []
    if args.resume:
        done += eng.restore()
    lo, hi = args.prompt_len
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=rng.integers(lo, hi))
        eng.submit(prompt, max_tokens=args.max_tokens,
                   deadline_ticks=args.deadline_ticks, n_best=args.nbest)
    profile = args.profile_ticks
    while True:
        try:
            if profile:
                profile = 0
                done += eng.step()      # the first admission fills the slots
                finished, report = profile_ticks(eng, args.profile_ticks)
                done += finished
                print("profile:", json.dumps(report))
            done += eng.run_until_drained()
            break
        except ProcessKilled as e:
            # a simulated crash: the engine object is dead; restart from
            # disk alone and keep serving
            print(f"engine killed ({e}); warm-restarting from "
                  f"{args.checkpoint_dir}")
            del eng
            eng = build()
            done += eng.restore()
    # a restore delivers at least once: dedupe by uid
    done = sorted({r.uid: r for r in done}.values(), key=lambda r: r.uid)
    for r in done:
        print(f"req {r.uid}: prompt_len={len(r.prompt)} -> {r.generated}")
        if r.nbest is not None:
            for i, alt in enumerate(r.nbest[1:], start=1):
                print(f"  nbest[{i}]: {alt}")
    s = eng.summary()
    print("summary:", json.dumps(s))
    rep = acct.report()
    if args.paged and (args.nbest > 1 or s["cow_copies"] > 0):
        print(f"copy-on-write: {s['forks']:.0f} forks, "
              f"{s['cow_copies']:.0f} page copies "
              f"({rep['cow_bytes']:.3g} bytes = {rep['cow_dram_j']:.3e} J "
              f"DRAM), saved {rep['fork_saved_bytes']:.3g} duplicate KV "
              f"bytes = {rep['fork_saved_dram_j']:.3e} J DRAM")
    if args.fault_kind is not None:
        print(f"chaos ({args.fault_kind}@{args.fault_tick}): "
              f"{s['faults_injected']} injected, {s['quarantined']} "
              f"quarantined, {s['shed']} shed, recovery "
              f"{s['recovery_j']:.3e} J ({s['recovery_tokens']} toks), "
              f"{s['degraded_ticks']} degraded ticks, "
              f"{s['readback_retries']} readback retries")
    if args.checkpoint_dir is not None:
        print(f"durability: {s['snapshots_taken']:.0f} snapshots "
              f"({s['snapshot_bytes']:.3g} B) + journal "
              f"{s['journal_bytes']:.3g} B = "
              f"{s['durability_write_j']:.3e} J writes; replayed "
              f"{s['replayed_ticks']:.0f} ticks on restore "
              f"({s['restore_j']:.3e} J)")
    if args.spec_k > 0:
        print(f"speculative decode (k={args.spec_k}, {args.spec_drafter}): "
              f"{s['accept_rate']:.1%} accept rate, "
              f"{s['accepted_tokens_per_tick']:.2f} emitted tokens/slot-tick, "
              f"J/accepted-token {rep['spec']['j_per_accepted_token']:.3e}")
    if dev.type == "cpu":
        rep = {k: v for k, v in rep.items() if k not in WALL_KEYS}
        print("carbon report (CPU run: wall-time-derived keys left out):",
              json.dumps(rep, default=float))
    else:
        print(f"device: {torch.cuda.get_device_name(dev)}")
        print("carbon report:", json.dumps(rep, default=float))


if __name__ == "__main__":
    main()
