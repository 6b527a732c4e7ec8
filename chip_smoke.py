#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version at the main path's shapes, then drives the
dense, the paged and the speculative serve paths of starcoder2-7b at full
width and 16 of its 32 layers with random weights from a seed, unquantized and in
the int8 mode (with tree speculation, n-best forks, a quarantined slot,
the chaos tier's seeded faults and degradation ladder, and the
durability tier's kill, snapshot restore and journal replay), gemma3-27b
at full width (head dim 168, sliding windows of 1024) and 14 layers on
the dense, paged and speculative paths, granite-34b, qwen1.5-110b and
qwen2-vl-72b at full width and 2 layers on the paged path, the MoE family
(one layer of moonshot-v1-16b-a3b and of kimi-k2-1t-a32b at full width,
moonshot at full width through every serve path and kimi-k2 at one
layer), the SSD/hybrid family (mamba2-1.3b and zamba2-7b at full width
and full depth on the dense serve path), the encoder-decoder family
(whisper-large-v3 at full width and full depth: encode, greedy decode,
the teacher-forced decoder through K6, and its Trainer), the training
launcher's smoke run on the card for every LM and encoder-decoder arch,
the families' training at full width (gemma3-27b, zamba2-7b and
moonshot-v1-16b-a3b at reduced depth, mamba2-1.3b at full depth), the
fused training tick at full width and 8 layers, the checkpointing
Trainer on the ~100M e2e model at full size, the port's train and kernel
benches, and the paper's ternary AlexNet and VGG-16 at full size.
Phases, each printing JSON lines; any failure raises, so the script exits
non-zero and prints no result:

1. device: the card's name and power limit (nvidia-smi), TF32 off;
2. build: every kernel source, one nvcc each, all started together;
3. kernels, each against its plain version (``kernels/ref.py``) in five
   dtype modes (q / K,V: fp32/fp32, bf16/bf16, bf16/fp32, and the int8-KV
   modes fp32/int8 and bf16/int8: random codes in [-127, 127] with
   positive fp32 row scales) and windows -1 and 256, with timings of the
   kernel, the plain version and one library call (masked
   ``F.scaled_dot_product_attention``, a yardstick the port never calls;
   for the paged kernels the gather through the table, for int8 K/V the
   dequantization, is part of that call; fp32 operations bounds count
   fp32-accurate work at the 3xTF32 rate, PEAK_TF32 / 3):
   K1 at B=8, H=36, Hkv=4, D=128, Sk=2048; K2 at the same shapes through a
   permuted table of 128 pages of 16 per slot (K1's, K2's and K5's times
   are device time from torch.profiler, their CUDA-event times beside
   them; K1, K2 and K5 run one body that splits each slot's keys across
   the SMs, their bf16-q modes over bf16 and int8 caches on its
   tensor-core kernel, the others on its SIMT kernel, and each row names
   the kernel its call launched); K1 on the dense cache equal bit for bit
   to K2 on a permuted pool that holds the same rows, in every mode and
   both windows, and two calls of K1 equal bit for bit; K3 at 8 rows,
   C=256, ragged
   starts (unaligned ones too) and lengths (0 too), then (checked, not
   timed) at C=200 with a window of 300 that starts inside cached pages
   and key tiles (K3's bf16-q modes over bf16 and int8 pools run its
   tensor-core kernel, the others its SIMT kernel; a ``routes`` line names
   the kernel that one call of each K1, K2, K3 and K5 mode, K4 regime and
   K6-K8 and K10 mode (fp32 and bf16, head dims 128 and 64) launched,
   read from the wrappers' per-kernel counters); K5 on K2's
   pools and lengths with T = 1, 2 and 5 query lanes per slot (lengths 1
   and 2 leave rows with no valid key, which must be exact zeros like a
   dead slot's), its library call masked SDPA with a per-lane causal
   mask, and lane t held against K2 at length ``lengths - T + t + 1``
   without a window in every mode (equal bit for bit on the SIMT kernel,
   asserted; on the tensor cores reported with the max abs difference);
   then (checked, not timed) K5 at a tree tick's rows: 24 rows of T = 5
   lanes, each slot's 3 branch rows over tables that share every page
   but the one holding its last key, every mode and window; and K2 and K5
   at a capacity of 2000 keys (no
   multiple of the split), lengths 0, 1, at a split edge and past it, a
   window of 300 that starts inside a split and a page, T = 1, 2 and 5,
   every mode, at head dims 128, 64, 256 and every other one of the
   reference's configs (168, 112, 24, 16, 8) and at granite-34b's MQA
   group of 48 (48 heads on one KV head of 128, on both kernels), with K1
   on the same rows gathered slot-major (equal to K2 bit for bit) and K3
   at C = 200 at the same head dims and group, each call on the kernel
   its route names (read from the counters); and K1, K2, K5 (T = 5) and
   K3 at gemma3-27b's heads (32 on 16 KV heads of 168), windows -1 and
   1024, in the two serve modes (bf16 q over the fp32 and the int8
   cache; K3 in every bf16-q mode, over bf16 and int8 pools on its
   tensor cores at 168 and 112, the route asserted), timed as at D = 128
   (phase ``kernels_d168``), and at kimi-k2's (64 on 8 KV heads of 112),
   no window (``kernels_d112``);
   K1 alone also at zamba2-7b's (32 on 32 KV heads of 112: a group of
   one), no window, the same two modes (``kernels_zamba2``);
   K3's checks hold every lane of a live row, the padding lanes past its
   length too (they attend the row's keys, as the Pallas kernel's do),
   and exact zeros on a dead row;
4. int8 matmul (K4) against its plain version at the main path's shapes:
   decode (M=8: the decode kernel, by device time from torch.profiler,
   CUDA events beside) and speculative-tick (M=40) for 4608->4608, ->512,
   ->18432 and 18432->4608, prefill (M=2048) for 4608->18432 and
   18432->4608, with bf16 x, each also called twice for equal bits; then
   (checked, not timed) the decode kernel at M = 1, 3, 7 and 8 over (K, N)
   = (48, 13), (4608, 1000), (4608, 4624) and (18464, 512), both outputs,
   and the wgmma kernel's
   ragged shapes (M = 9, 100, 2047; N = 1008, 4624) and an N = 1000 call
   that must raise its shape error, fp32 x at M=8
   for 4608->18432, and the fp32-output mode of bf16 x (the training
   forward's) at M=8 and M=4096 for 4608->18432; the library call is
   cuBLAS ``x @ w`` on the weight dequantized once to x's dtype, which is
   not the same function: it moves 2x (bf16) or 4x (fp32) the weight
   bytes; then K9 (the int8 backward, fp32 dy, on the coded GEMM's tensor
   cores) against its plain version
   at M = 4096 for (K, N) = (4608, 4608), (4608, 512), (4608, 18432) and
   (18432, 4608), dx in fp32 and bf16, two calls equal bit for bit, one
   launch a call, its library call cuBLAS ``(dy *
   scale) @ w^T`` on the weight widened once (4x the weight bytes), then
   (checked, not timed) at (M, K, N) = (100, 300, 50), (9, 7, 3) and (4096,
   4608, 1000); and
   K4 at the dense family's weight shapes at full width (gemma3-27b,
   granite-34b, qwen1.5-110b, qwen2-vl-72b: wq/wo, wk/wv, w_in, w_out) at
   M = 8 and 40, bf16 x, checked and not timed; and
   ``int8_matmul_train``'s dx and dscale (K4 + K9) against autograd
   through the plain math at (4096, 4608, 18432), fp32 and bf16 x; the
   bounds of fp32 x against int8 or ternary codes count three exact bf16
   products (``_peak_coded``: PEAK_BF16 / 3);
4c. ternary matmul (K11) against its plain version at the CNN workloads'
   FC shapes: AlexNet's (K, N) = (9216, 4096), (4096, 4096), (4096, 1000)
   and VGG-16's (25088, 4096) at M = 1 and 64, fp32 and bf16 x, codes from
   ``ternarize``, plus a binary case (no zero codes) per shape, and the
   kernel bench's 256 x 2048 x 512, then (checked, not timed) ragged
   shapes at M = 1-9, 64, 100 and 130; every call on the kernel its rule
   names (M > 8 on the tensor cores), two calls equal bit for bit, one
   launch a call; the library call is cuBLAS ``x @ w``
   on the weight dequantized once (4x the weight bytes in fp32); times are
   device time from torch.profiler (at M = 1 the host's launch time
   exceeds the kernel's), the CUDA-event time beside them;
4g. cells (``launch.cells``, after 4c), on one card and a one-device
   mesh, at full width: starcoder2-7b ``decode_32k`` (32 of 32 layers,
   bf16, global batch cut 128 -> 8: 128 rows of its bf16 cache are 256
   GiB) one step through ``Cell.run``, its logits equal bit for bit to a
   direct ``decode_step`` on the same tensors, K1 once a layer; the same
   cell with ``_weights_int8`` (K4 six times a layer, K1 once); whisper-
   large-v3's ``decode_32k`` cell (32 + 32 layers, batch cut to 8) against
   its direct ``decode_step``, no kernel; starcoder2-7b ``train_4k`` at 8
   of 32 layers and global batch 1 (from 256) with the cells' AdamW (bf16
   moments, no master), two steps: finite losses, K6 = K7 = K8 = 8 a step
   on the route's kernel, the route printed. Each cell's dry-run record
   (``launch.dryrun``, meta tensors: per-device argument bytes, analytic
   live bytes, FLOPs and bytes, the modeled roofline terms, collective
   bytes null) on the one-device mesh and the 16 x 16 and 2 x 16 x 16
   meshes, beside the card's peak allocated memory;
5. streams: fp32 weights and cache, 4 requests x 16 greedy tokens; the
   dense engine (through K1) must be token-identical to the host-loop
   reference (through masked ``sdpa``), and the paged engine (K2, K3;
   page_size 16, prefill_chunk 64, no prefix cache) to the dense engine;
   a paged run with the prefix cache on requests that share a 128-token
   prefix must hit, and prints its agreement with the dense streams; then
   the same with ``quant="int8"``: the dense int8 engine (K4 + K1) must be
   token-identical to the int8 host-loop reference (K4 + dequantize +
   ``sdpa``) given the engine's params and cfg, and the paged int8 engine
   (K4 + K2 + K3) to the dense int8 engine; the speculative engine (K5)
   must be token-identical to the plain paged engine: ``ngram`` at k = 1,
   2 and 4 and ``oracle`` at k = 2 (which must accept drafts), int8 at
   k = 4, and k = 4 with the prefix cache on the shared-prefix requests;
   so must tree speculation (k = 4, ``spec_tree_m=3``, unquantized and
   int8; at least linear's accepted tokens a tick) and n-best sampling
   (every request forked 2 ways, unquantized and int8); and a paged run
   whose decoding slot 0 has its first private K page set to NaN before
   tick 6 must quarantine that slot once, at that tick, and retry it to
   the same streams with a clean pool;
5b. chaos, on phase 5's fp32 params, prompts and paged streams: each
   transient fault kind (``FaultPlan.single(kind, tick=2, seed=11,
   slot=1)``; a stall of magnitude 10) on the paged engine with the pool
   auditor every tick: the streams phase 5's, at least one fault, a clean
   pool and audit, no non-finite pool value, the split kernels' counters at
   zero; the readback kinds retry (no quarantine), the numerics kinds
   quarantine once; ``nan_logits`` on the speculative (k = 4) and tree
   (m = 3) engines, unquantized and (after the int8 streams) int8, the
   plain paged streams; a ``process_kill`` raises at its tick; deadline 1
   on 16 requests over 4 slots sheds, shed + finished = 16; an int8 engine
   built from the fp32 params with the drift rung armed and a
   ``kv_bitflip``: every request its 16 tokens, a clean pool, at most one
   fp fallback (its count and the drift checks reported); K2, K5 (T = 5)
   and K3 in their int8-KV modes against their plain versions on pools
   whose K codes were XORed with 0x55 (codes -128..127);
5c. durability, on phase 5's fp32 params, prompts and streams: the
   paged, speculative (k = 4) and dense engines, then an int8 paged
   engine built from the fp32 params, each snapshotting every 4 ticks
   into a temporary directory and killed (``process_kill``) at tick 7,
   dropped, restored by a fresh engine (the tick-4 snapshot, 3 ticks of
   the journal replayed) and drained, journaling only: phase 5's streams
   token for token,
   3 replayed ticks, restore_j > 0, a clean pool and audit, the split
   kernels' counters at zero; an int8 run with ``_fallback_to_fp()``
   forced before tick 3 restores the fp runtime (``_fell_back``, an fp32
   pool) and gives the streams of the same forced run without a crash;
   the restore seconds split into loading and replay are reported;
6. serve: bf16 weights, fp32 cache, 8 slots, max_len 2048, 16 requests of
   32-1024 prompt tokens and 64 new tokens each; K1 launches must be
   decode ticks x the layers (phases 5-9 run 16 of starcoder2-7b's 32
   layers: their ticks are host-bound, and the cut halves their time);
7. paged serve: the same weights, page_size 16, prefill_chunk 256, prefix
   cache on, 16 requests of a shared 512-token prompt plus a 32-512-token
   tail; K2 launches must be decode ticks x 16, K3 launches extend calls x
   16, and the prefix cache must hit;
8. phases 6 and 7 again with ``quant="int8"`` (the same weights quantized
   once): K4 launches must be (decode ticks + admission or extend calls) x
   16 x 6, K1, K2 and K3 as in phases 6 and 7; each serve run also reads
   the per-kernel counters of K1, K2, K3, K4 and K5: K1, K2, K3 and K5
   must run on their tensor cores in the int8 runs and on their SIMT
   kernels in the others, and K4 in the
   int8 runs on its wgmma kernel and (outside the spec runs) its decode
   kernel, never its SIMT kernel;
8b. phase 7's traffic with speculative decode (``spec_k=4``, ``ngram``),
   unquantized and int8: K5 launches must be spec ticks x 16, K2 none, K3
   extend calls x 16, K4 (spec ticks + extend calls) x 96; reports the
   accept rate, accepted tokens per tick and the draft/verify energy;
   every paged run must drain its pool clean (no live page, a clean
   audit);
8d. phase 8b's traffic with tree speculation (``spec_tree_m=3``), per
   mode after 8b: K5 launches tree ticks x 16 on 8b's route; reports the
   streams' agreement with 8b's and phase 7's (bf16 GEMMs of 120, 40 and
   8 rows round differently, so a near tie may flip a greedy token: the
   identity is phase 5's, in fp32), the accepted tokens per tick beside
   8b's, the copy-on-write copies and bytes, and one profiled tree tick
   beside one linear tick (device ms a tick, on 8 of the requests once
   they all decode);
8c. n-best sampling, per mode after 8d: 8 requests of 100-500 prompt
   tokens (none page-aligned) forked 4 ways, 32 greedy tokens, 8 slots:
   every stream must equal a plain paged engine's fed each prompt at the
   tick its group was admitted (the same extend rows, the same 8-slot
   ticks), 24 forks, at least 24 page copies, saved bytes, a clean pool;
   then at temperature 0.8: a clean drain, the distinct streams of each
   group reported;
8e. chaos at full width, per mode after 8c: phase 7's traffic under
   ``FaultPlan.matrix(seed=0, n_ticks=40)`` over the transient kinds, a
   stall of magnitude 10 at tick 50 and a spike of half the pool for 4
   ticks at tick 64, with the auditor every tick, admission retries capped
   at 8 with backoff 1 and the compaction pause at 2x the tick EWMA: every
   request finished or shed, K2 = decode ticks x 16, K3 = extend calls x
   16 (K4 as in phase 8), a clean pool, no audit failure, a compaction
   pause, two readback retries; reports the agreement with phase 7's
   streams, host ms a tick beside phase 7's, recovery J/token and the
   auditor's host ms a tick; then 8b's traffic (unquantized) with the
   spec-k backoff armed (threshold 0.9, window 2): a backoff, K5 = spec
   ticks x 16; then an int8 engine built from the bf16 params on 8 of the
   requests with ``_fallback_to_fp()`` forced before tick 3: every
   request its 32 tokens, a clean pool, K2 and K3 on their tensor cores
   before and on SIMT after, no K4 after; the fallback's host seconds;
8f. durability at full width, per mode after 8e: phase 7's traffic on a
   durable engine killed at tick 3 (snapshots every 2 ticks: the tick-2
   snapshot its restore loads holds slots mid-prefill and queued
   requests) and, after that restore, at tick 40 (snapshots every 32
   ticks: 8 ticks replayed), each time dropped and replaced by a fresh
   engine that restores and serves on (the last journaling only): phase 7's streams (phase 8's int8
   paged streams), each restore's replayed ticks its kill tick minus its
   snapshot's, restore_j > 0, a clean pool and audit, K2 = decode ticks x
   16 and K3 = extend calls x 16 (K4 as in phase 8) over every tick the
   three engines ran; reports each snapshot's host seconds and GB, each
   restore's seconds split into loading and replay, the journal bytes,
   the write joules, restore J/token and the durability bytes a tick;
4b. flash kernels: K6 (forward with lse), K7 (dQ) and K8 (dK, dV) against
   their plain versions at the training path's shapes (B=2, S=2048, H=36,
   Hkv=4, D=128, causal) in fp32 and bf16 with windows -1 and 256, the
   backward on the kernel's own out and lse (fp32 K6-K8 and K10 run
   their 3xTF32 kernels, bf16 ones their bf16 ones: every call asserted
   on its route's kernel; each K6 and K10 row gives the device kernels a
   call launched, bf16 q one, the fp32 forward's split pre-pass and
   kernel two; the bounds count bf16's three-plane products, P V, dS K,
   P^T dO and dS^T Q, at a third of the bf16 rate); two calls of K6, K7
   and K8 on the same inputs must give the same bits; the kernels and the library calls timed by
   device time from torch.profiler, CUDA events beside; the library call
   is causal ``F.scaled_dot_product_attention`` with K/V repeated to H
   heads, and its autograd backward for K7 + K8 together; then (checked,
   not timed) K6 (out and lse), K7, K8 and K10 (K/V in q's dtype and
   int8) at ragged shapes: Sq = Sk in {1, 63, 65, 1000} and Sq = 100
   with Sk = 128, head dims 64 and 128, GQA groups of 1, 3 and 9, a window
   of 300 and a non-causal case, fp32 and bf16, each also called twice for
   equal bits; then K10 (the inference
   flash attention) at the same shapes, q fp32 and bf16, K/V in q's dtype
   or int8 with (B, S, Hkv) scales, windows -1 and 256, two calls equal
   bit for bit, its library call causal SDPA with K/V dequantized and
   repeated inside the call;
4d. flash kernels at the smoke configs' head dims (``flash_small_dims``):
   K6 (out, lse), K7, K8 and K10 (K/V in q's dtype and int8) at D 8, 16
   and 24, which run the D = 64 kernels on tiles zero past D, checked as
   in 4b's ragged cases (fp32 and bf16, windows -1 and 8, two calls equal
   bit for bit) at the training launcher's batch (B 8, S 64) with the
   heads of every smoke config whose training attention takes the flash
   route, and at S 67 (K8 split over each group's heads at these shapes:
   fewer (key tile, batch, KV head) blocks than SMs); timed at B 8, S 64
   with kimi-k2's (D 8), starcoder2's (D 16) and gemma3's (D 24) smoke
   heads, fp32 and bf16, by device time, beside the plain versions,
   causal SDPA and the bounds, K8's rows with its split and blocks;
4e. flash kernels at head dims 112 and 168 (``flash_wide_dims``): the
   same checks at kimi-k2's heads (64 on 8 of 112), zamba2-7b's (32 on
   32 of 112) and gemma3-27b's (32 on 16 of 168, windows -1 and 1024) at
   S 2048, then ragged lengths (1000 with a window of 300; Sq 100 < Sk
   128 at a group of 9; a non-causal case; one key), fp32 and bf16, each
   call on the tensor-core kernel its route names (112 on the D = 128
   kernels; 168 on kernels of 192 columns: the forward's own, the bf16
   backward and the fp32 backward's wide kernels); timed at kimi-k2's and
   gemma3-27b's heads, B 1, S 2048, as in 4d;
9. agreement: teacher-forced greedy token agreement of the int8 model with
   the bf16 one on 8 prompts of 64 tokens x 24 tokens (reported, not
   asserted); then the serve params are freed;
9b. gemma3-27b at full width (d_model 5376, 32/16 heads of 168, d_ff
   21504, vocab 262144), 14 layers (two repeats of 5 local layers of
   window 1024 and a global one, and the 2-layer local tail), fp32 params
   from SEED: 4 requests of 1100-1501 prompt tokens (the window's start
   inside a page and a split), 16 greedy tokens, 4 slots: the dense (K1),
   paged (K2, K3; pages of 16, chunks of 256) and speculative (K5, k = 4)
   engines' streams identical; then the same draws in bf16 on the paged
   engine, unquantized and int8 (K4), their agreement with the fp32
   streams reported; every run's launches checked (every layer, on the
   SIMT kernels at D = 168; K3 on its tensor cores in the int8 run);
9c. granite-34b, qwen1.5-110b and qwen2-vl-72b at full width, 2 layers,
   bf16: 4 requests of 100-400 tokens x 16 on the paged engine, streams
   and launches;
9d. the MoE family (``moe_layer``, ``moe``): one layer of
   moonshot-v1-16b-a3b (64 experts, top-6, d 2048, expert d_ff 1408) and
   of kimi-k2-1t-a32b (384, top-8, d 7168, 2048) at full width in fp32,
   at 4096 tokens and 8, inputs N(0, 1) plus one shared direction:
   ``moe_capacity`` at a capacity where no route drops against
   ``moe_dense``, and at the published factor its dropped routes against
   a host recount of the first-come ranks from the read-back ids and its
   output against a per-route fp32 sum over the kept routes (bound: the
   smoke tests' 2e-5 grown with the square root of d); moonshot at full
   width, 16 layers, fp32, the capacity factor raised to n_experts /
   top_k: the dense, paged and speculative (k = 4) streams identical and
   no route dropped; bf16 and int8 (quantized leaf by leaf) at the
   published factor on the paged engine, at 16 layers (agreement with
   the fp32 streams, routes dropped) and at full depth (8 slots, 3
   decode ticks profiled); kimi-k2 at full width and one layer, bf16,
   paged and speculative over the fp32 cache (K2, K3, K5 on SIMT at D
   112, one tick set profiled), and paged over a bf16 cache (K3 on its
   tensor cores; agreement with the fp32 cache's streams reported);
   every run's launches checked;
9e. the SSD/hybrid family (``ssd_scan``, ``ssm_family``), the dense
   serve path only (the paged path refuses SSD archs, as the reference's
   does), ``conv_b``/``conv_c`` of every SSD block drawn N(0, 0.2) from
   SEED after ``init_lm`` (its zeros leave every SSM state at 0): one
   mamba2-1.3b layer's ``ssd_chunked`` against ``ssd_naive`` at B 2, S
   1024 on the layer's own projections of N(0, 1) hidden states (bound
   2e-4 of max(1, max |y|), the final state too); then mamba2-1.3b (48
   SSD blocks) and zamba2-7b (81 slots: 13 x (5 SSD blocks and a shared
   attention site) and 3) at full width and full depth, 8 slots, max_len
   2048, prompts of 512 and 301 tokens alternating (equal-length
   admission groups: the 301s go back to the queue), 16 greedy tokens:
   fp32 dense streams identical to ``ReferenceEngine``'s (mamba2's also
   to a kill at tick 7 restored from the tick-4 snapshot and the
   journal), the SSM states nonzero; bf16 (and zamba2 int8: the shared
   block's projections through K4, the SSD blocks in bf16) with 3 decode
   ticks profiled (device and host ms a tick, launches a layer, peak
   memory), the int8-vs-bf16 and bf16-vs-fp32 agreement reported; K1
   launches = decode ticks x 13 at zamba2 (SIMT at D 112), none at
   mamba2;
9f. the encoder-decoder family (``encdec``): whisper-large-v3 at full
   width and full depth (32 + 32 layers, d_model 1280, 20 heads of 64,
   vocab 51866), fp32 weights from SEED, B 2, 1500 frames N(0, 1) from
   SEED: ``encode``, ``build_cross_cache``, a 4-token prompt and 32 greedy
   tokens through ``decode_step`` (a self cache of 448 rows); then
   ``decode_train`` on the fed stream through K6 (counted: 32 launches,
   no other kernel): every step's logits within 1e-4 x max(1, max
   |logit|) of the teacher-forced ones and the greedy tokens their
   argmax; then in bf16 (reported): host and device ms and launches of
   ``encode``, ``build_cross_cache`` and a decode step, peak memory;
9g. encoder-decoder training (``encdec_train_parity``, ``encdec_train``,
   ``launch_train_smoke``): whisper-large-v3 at full width and depth,
   fp32, B 2 x 64 decoder tokens, N(0, 1) frames: the first batch's loss
   and gradients through K6-K8 against the masked ``sdpa`` route (10's
   bounds; the key biases' gradients, zero in exact arithmetic, below
   1e-5 of the largest), then the Trainer 2 steps (K6 = K7 = K8 = 64 on
   the tensor cores; s/step, peak memory); then ``launch.train.main
   ["--arch", a, "--smoke", "--steps", "2"]`` on the card for every LM
   and encoder-decoder arch of the registry: a finite loss, K6 = K7 = K8
   for every arch whose training attention takes the flash route (qwen2-vl's
   M-RoPE and mamba2 launch none), no other kernel;
9h. the families' training on the card (``family_train``): gemma3-27b
   at full width cut to 3 sliding-window layers (1024) and a global one,
   zamba2-7b to 2 of its 13 groups (two sites of its shared block),
   moonshot-v1-16b-a3b to 2 of its 48 layers, mamba2-1.3b at full depth;
   fp32, AdamW, B 1 x S 2048 synthetic tokens (mamba2's S 1024), SSD
   blocks on live ``conv_b``/``conv_c``: for each arch with attention one
   step's loss and gradients through K6-K8 against the masked ``sdpa``
   route (the loss within 1e-6 relative, each leaf within 1e-5 of its max,
   an SSD block's per-head scalars within 1e-4, key biases held to
   noise), then 3 Trainer steps with
   finite losses (moonshot's aux loss above zero), K6 = K7 = K8 = the
   attention layers a step, each on the kernel its route names; s/step
   with the first step apart, peak memory, parameters and their 16 bytes
   a parameter, then one more step profiled (device time by kernel, busy
   share);
10. train parity: fp32 and bf16 params, full width, 2 layers, B=2,
   S=1024: the gradients of ``loss_fn`` through K6-K8
   (``positions=None``) against the masked ``sdpa`` route (explicit
   positions), the loss within 1e-5 (bf16: 1e-2) and each leaf within
   1e-4 (bf16: 6e-2) of its max, relative (TRAIN_PARITY_TOL); every K6,
   K7 and K8 launch on the tensor-core kernels;
11. train: ``TrainEngine.for_lm`` on the 8-layer full-width config,
   synthetic tokens, batch 2 x 2048, two ticks of two steps, with fp32
   params and AdamW state, then with bf16 params and the reference's
   fleet AdamW (bf16 moments, no fp32 master, grad_clip 1.0, lr 3e-4):
   every loss and grad norm finite, one readback per tick, K6, K7 and K8
   launches each steps x 8, all on the tensor-core kernels; reports
   s/step (the first tick apart), tokens/s, peak memory, model FLOP/s
   over the fp32 (bf16) peak and the accountant's train block, then
   profiles one more tick (device time by kernel, K6-K8's among it, busy
   share);
11b. trainer: the checkpointing ``Trainer`` on examples/train_e2e.py's
   model_100m at full size (12 layers, d_model 768, 129.0M params), fp32,
   batch 8 x 128: 2N steps straight against N steps, a save, and a fresh
   Trainer from another seed that restores and runs N more (params and
   AdamW state must match bit for bit, else within 1e-6 of each leaf's
   max); a preempted run's synchronous save at its step; a flipped byte in
   arrays.npz refused; K6 = K7 = K8 = 2N x 12 launches, all on the
   tensor-core kernels; s/step, tokens/s,
   save and restore seconds and bytes, peak memory, one profiled pair of
   steps;
11c. the port's train bench (both arms, update and kernel-grad parity;
   K9's launch) and kernel bench (K11's and K10's launches);
11d. the paper's CNN workloads, AlexNet and VGG-16 at 224 x 224 x 3 and
   1000 classes, fp32, random weights and synthetic normal images: the FC
   weights ternarized as examples/edge_cnn_repro.py does, and the K11
   route (``forward(matmul_fn=ternary_mm)``) at batch 1 and 64 held to
   the dequantized forward (1e-4 of the max |logit|, the same top-1),
   timed beside it, K11's share of the device time profiled, top-1
   agreement with the fp32 forward reported; then three fp32 training
   steps at batch 32 (dropout on, AdamW), losses and grad norms finite,
   s/step, model FLOP/s over the fp32 peak, peak memory; K11 launches 3
   times a forward, one kernel each (torch.profiler), on its streaming
   kernel at batch 1 and its tensor-core kernel at 64; the params are
   freed after each model. It runs right after the kernel phases (before
   phase 5), ahead of the long profiles of the serve and training phases;
12. a ``kernels`` line (K1-K11; K9's and K11's with the launches of each
   of their kernels in the main-path runs; K1's, K2's, K3's and K5's with
   the head dims of the serve runs that launched them and their
   ``kernels_d168`` and ``kernels_d112`` rows at the int8 mode; K1's also
   with its ``kernels_zamba2`` row as ``d112_zamba2``; K6's, K7's, K8's
   and K10's with the head dims of the counted runs that launched them
   and their fp32 ``flash_small_dims`` and ``flash_wide_dims`` rows as
   ``d8``, ``d16``, ``d24``, ``d112``, ``d168``), then the result line
   ``{"ok": true, "device": ...}``.

Every counter is set to 0 just before each serve, train, trainer, bench
or CNN run and read just after.
Needs one card and no network. Exits non-zero without a card, and outside a
checkout of the repository.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0
# dense device peaks of one H100 SXM at its full 700 W limit (NVIDIA's data
# sheet): bytes/s of HBM3, FLOP/s in fp32 outside the tensor cores, and in
# TF32 and bf16 on them
HBM_BYTES_PER_S = 3.35e12
PEAK_FP32 = 67e12
PEAK_TF32 = 494.7e12
PEAK_BF16 = 989e12
# starcoder2-7b's serve phases (5-9) at full width, cut to 16 of its 32
# layers: their ticks are host-bound, so their time halves with the depth
SERVE_LAYERS = 16


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


def device_ms(fn, iters: int, attempts: int = 5) -> float:
    """Mean device time of the kernels (and copies) that ``fn(i)``
    launches, over calls i = 0 .. iters-1 after a warm-up, from
    torch.profiler: the host's time to launch them is not in it, where
    ``cuda_ms`` includes it whenever the host is the slower side.
    torch.profiler on the H100 has returned profiles that lost device
    events (none at all, or some launches of a kernel: a call's time came
    out 0.7x its CUDA-event time). Every call of ``fn`` launches the same
    kernels, so a whole profile counts each kernel a multiple of ``iters``
    times; a profile that does not is taken again, up to ``attempts``
    times, after which the largest reading stands (a lost event only
    lowers it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    readings = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        us = sum(e.self_device_time_total for e in events)
        if us > 0 and all(e.count % iters == 0 for e in events):
            return us / 1e3 / iters
        if us > 0:
            readings.append(us / 1e3 / iters)
    if not readings:
        raise AssertionError(f"torch.profiler saw no device time in "
                             f"{attempts} profiles")
    return max(readings)


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
         ("bfloat16", "float32", 5e-3, 1e-2),
         ("float32", "int8", 1e-5, 0.0),
         ("bfloat16", "int8", 5e-3, 1e-2))
# the main path's mode of each slice: fp32 K/V (PR 12), int8 K/V (int8)
MAIN_FP = ("bfloat16", "float32", -1)
MAIN_INT8 = ("bfloat16", "int8", -1)
# K5's query lanes per slot: T = 5 is the spec serve runs' k = 4
VERIFY_LANES = (1, 2, 5)
SPEC_K = 4
# tree speculation's branches a slot, and n-best sampling's forks a request
# and new tokens a stream (phases 5, 8c, 8d)
TREE_M, NBEST, NBEST_NEW = 3, 4, 32
WINDOWS = (-1, 256)
B, H, HKV, D = 8, 36, 4, 128
PAGE, N_BLOCKS = 16, 128                       # 2048 positions per slot
LENGTHS = (0, 1, 2048, 777, 1500, 33, 2047, 129)
STARTS = (0, 512, 1000, 37, 1777, 256, 100, 1200)
CHUNK_LENS = (256, 256, 200, 0, 256, 1, 128, 256)
CHUNK = 256


def _randn(gen, shape, dtype):
    """Normal values, or for int8 random codes in [-127, 127]."""
    import torch
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _scales(gen, kv, kv_dtype):
    """Positive fp32 scales, one per K/V row and head, for int8 K/V (the
    codes times them span about +-1.4); nothing for fp K/V."""
    import torch
    if kv_dtype != torch.int8:
        return ()
    return tuple(torch.rand(kv.shape[:-1], generator=gen, device="cuda")
                 * 0.02 + 1e-3 for _ in range(2))


def _decode_inputs(q_dtype, kv_dtype, heads=(H, HKV, D)):
    """K1's inputs: q (B, H, D) and a slot-major cache of N_BLOCKS * PAGE
    keys a slot, at ``heads`` = (H, Hkv, D)."""
    import torch
    h, hkv, d = heads
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q = _randn(gen, (B, h, d), q_dtype)
    k = _randn(gen, (B, N_BLOCKS * PAGE, hkv, d), kv_dtype)
    v = _randn(gen, (B, N_BLOCKS * PAGE, hkv, d), kv_dtype)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device="cuda")
    return (q, k, v, lengths) + _scales(gen, k, kv_dtype)


def _pool_inputs(gen, kv_dtype, heads=(H, HKV, D)):
    """A pool of B * N_BLOCKS pages plus the sink, and a permuted
    (fragmented) page table over it."""
    import torch
    _, hkv, d = heads
    pages = B * N_BLOCKS
    k_pool = _randn(gen, (pages + 1, PAGE, hkv, d), kv_dtype)
    v_pool = _randn(gen, (pages + 1, PAGE, hkv, d), kv_dtype)
    table = torch.randperm(pages, generator=gen, device="cuda").to(
        torch.int32).reshape(B, N_BLOCKS)
    return k_pool, v_pool, table


def _paged_decode_inputs(q_dtype, kv_dtype, heads=(H, HKV, D)):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    q = _randn(gen, (B, heads[0], heads[2]), q_dtype)
    k_pool, v_pool, table = _pool_inputs(gen, kv_dtype, heads)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device="cuda")
    return (q, k_pool, v_pool, table, lengths) + _scales(gen, k_pool,
                                                         kv_dtype)


def _prefill_inputs(q_dtype, kv_dtype, heads=(H, HKV, D)):
    import torch
    h, hkv, d = heads
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    q = _randn(gen, (B, CHUNK, h, d), q_dtype)
    k_new = _randn(gen, (B, CHUNK, hkv, d), q_dtype)
    v_new = _randn(gen, (B, CHUNK, hkv, d), q_dtype)
    k_pool, v_pool, table = _pool_inputs(gen, kv_dtype, heads)
    starts = torch.tensor(STARTS, dtype=torch.int32, device="cuda")
    lens = torch.tensor(CHUNK_LENS, dtype=torch.int32, device="cuda")
    return (q, k_new, v_new, k_pool, v_pool, table, starts,
            lens) + _scales(gen, k_pool, kv_dtype)


def _peak(*tensors):
    """The fastest rate of fp32-accurate work when any input is fp32, else
    bf16's peak (int8 K/V codes are exact in bf16). fp32-accurate products
    run fastest on the tensor cores as 3xTF32 (three TF32 products of hi/lo
    halves), at PEAK_TF32 / 3 = 165 TFLOP/s, above the CUDA cores'
    PEAK_FP32: the least time of the same fp32 work, whatever implements
    it (before this rate the fp32 bounds used PEAK_FP32). Products with
    int8 or ternary weight codes take ``_peak_coded``."""
    import torch
    return (PEAK_TF32 / 3 if any(t.dtype == torch.float32 for t in tensors)
            else PEAK_BF16)


def _peak_coded(x):
    """The fastest rate of x's product with int8 or ternary codes: the codes
    are exact in bf16, so three exact bf16 products carry fp32 x
    (PEAK_BF16 / 3), and bf16 x is one (PEAK_BF16)."""
    import torch
    return PEAK_BF16 / 3 if x.dtype == torch.float32 else PEAK_BF16


def _bound(nbytes, t_ops):
    """The larger of the bytes' time over the HBM rate and ``t_ops``
    seconds of operations, in ms, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _decode_bound(q, k, lengths, window, paged=False):
    """Least time of a decode call (K1, K2): its bytes (``decode_work``:
    the live K/V rows with their scales for int8, q, the output and the
    lengths; K2 the table entries of the live rows too) over the HBM rate,
    or its 4*live*H*D FLOPs over the inputs' peak (fp32 if any input is
    fp32)."""
    from repro_torch.core import flops as fl
    cap, page = (N_BLOCKS * PAGE, PAGE) if paged else (k.shape[1], 0)
    ops, nbytes = fl.decode_work(q, k, lengths, window, cap, page)
    return _bound(nbytes, ops / _peak(q, k))


def _verify_bound(q, k, lengths, window):
    """Least time of a K5 call: its bytes (``verify_work``: the K/V rows
    some lane of a slot attends with their scales for int8, q, the output,
    the lengths and those rows' table entries) over the HBM rate, or 4*H*D
    FLOPs per valid (lane, key) pair over the inputs' peak."""
    from repro_torch.core import flops as fl
    ops, nbytes = fl.verify_work(q, k, lengths, window, N_BLOCKS * PAGE,
                                 PAGE)
    return _bound(nbytes, ops / _peak(q, k))


def _prefill_bound(q, k_new, k_pool, starts, lens, window):
    """Least time of a K3 call: its bytes (``prefill_work``: q of every
    lane of a live row, the live chunk tokens' k and v, the cached keys
    the row's lanes attend, the output and the table entries) over the
    HBM rate; or 4*D*H FLOPs per valid (query, key) pair, the pairs on
    cached keys over the peak of q's and the pool's types, those on the
    chunk's own keys over the peak of q's type (k_new, v_new share it)."""
    from repro_torch.core import flops as fl
    on_cached, on_chunk, nbytes = fl.prefill_work(q, k_pool, starts, lens,
                                                  window, PAGE)
    return _bound(nbytes, on_cached / _peak(q, k_pool) + on_chunk / _peak(q))


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


def _library_verify(q, k_pool, v_pool, table, lengths, *, scale, window):
    """The gather through the table, then one masked SDPA with a per-lane
    causal mask (lane t at lengths - T + t); the gather and the mask are
    part of the call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    k = ref.paged_gather(k_pool, table)
    v = ref.paged_gather(v_pool, table)
    t = q.shape[1]
    lengths = lengths.long()
    j = torch.arange(k.shape[1], device=q.device)[None, None]
    q_pos = (lengths - t)[:, None] + torch.arange(t, device=q.device)[None]
    diff = q_pos[:, :, None] - j
    mask = (diff >= 0) & (j < lengths[:, None, None])
    if window > 0:
        mask &= diff < window
    return F.scaled_dot_product_attention(
        q.transpose(1, 2).to(k.dtype), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask[:, None], scale=scale, enable_gqa=True)


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


def _with_scales(fn):
    """``fn`` taking int8 K/V's scales as its last two positional
    arguments, passed on as ``k_scale``/``v_scale``."""
    def call(*args, scale, window):
        return fn(*args[:-2], scale=scale, window=window, k_scale=args[-2],
                  v_scale=args[-1])
    return call


def _dequantized(library, kv_pos):
    """The library call on int8 K/V: codes times scales to q's dtype, then
    the call; the dequantization is part of the timed call."""
    def call(*args, scale, window):
        args = list(args)
        for pos, sc in zip(kv_pos, args[-2:]):
            args[pos] = (args[pos].float() * sc[..., None]).to(args[0].dtype)
        return library(*args[:-2], scale=scale, window=window)
    return call


def _check_kernel(name, kernel, plain, library, inputs, bound, dead, cold,
                  iters, kv_pos, extra=None, device_time=False, route=None,
                  modes=MODES, windows=WINDOWS, kv_arg=1):
    """Hold ``kernel`` against ``plain`` in every mode and window, time the
    kernel, the plain version and the library call, and return the rows of
    the main path's modes (``MAIN_FP``, ``MAIN_INT8``). ``inputs(q_dtype,
    kv_dtype)`` gives the call's tensors, the first being q and, for int8
    K/V, the last two the scales; ``bound(args, window)`` is the least
    time; ``dead`` masks the output's leading dims where the kernel must
    write exact zeros; ``cold`` names the positions of the large tensors
    each timed call reads from its own copy (int8 scales too); ``kv_pos``
    those of K and V; ``extra`` goes into every row. With ``device_time``
    the kernel's, the plain version's and the library call's times are
    device time from torch.profiler (``device_ms``), the kernel's and the
    library call's CUDA-event times beside them (host-paced where the
    host's launch is the slower side), as K1, K2 and K5 report them;
    a wrapper with per-kernel counters (``launches_by_kernel``) reports
    the kernel the checked call launched as the row's route, which must be
    the one that ``route(q dtype, K/V dtype, head dim)`` names (the split
    body's ``route``, for K1, K2 and K5; K3's own, with its pool at
    ``kv_arg`` 3) when both are there. ``modes``
    and ``windows`` narrow the checked and timed calls; the softmax scale
    is q's head dim ** -0.5."""
    import torch
    dead = dead.cuda()
    main = {}
    for q_name, kv_name, atol, rtol in modes:
        int8 = kv_name == "int8"
        fns = ((_with_scales(kernel), _with_scales(plain),
                _dequantized(library, kv_pos)) if int8
               else (kernel, plain, library))
        args = inputs(getattr(torch, q_name), getattr(torch, kv_name))
        scale = args[0].shape[-1] ** -0.5
        hot = cold + ((len(args) - 2, len(args) - 1) if int8 else ())
        counts = getattr(kernel, "launches_by_kernel", None)
        for window in windows:
            before = dict(counts or {})
            got = fns[0](*args, scale=scale, window=window)
            torch.cuda.synchronize()
            ran = [n for n in (counts or {}) if counts[n] != before[n]]
            want = fns[1](*args, scale=scale, window=window)
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
            copies = [[a.clone() if i in hot else a
                       for i, a in enumerate(args)] for _ in range(4)]

            def timed(fn):
                return lambda i: fn(*copies[i % len(copies)], scale=scale,
                                    window=window)

            timer = device_ms if device_time else cuda_ms
            kernel_ms = timer(timed(fns[0]), iters)
            plain_ms = timer(timed(fns[1]), max(iters // 4, 4))
            library_ms = timer(timed(fns[2]), max(iters // 2, 4))
            bound_ms, bound_by = bound(args, window)
            row = {"phase": "kernels", "kernel": name, "q": q_name,
                   "kv": kv_name, "window": window,
                   "head_dim": args[0].shape[-1], "max_abs_err": max_err,
                   "atol": atol, "rtol": rtol, "ms": kernel_ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by, **(extra or {})}
            if device_time:
                row.update({"timing": "device", "event_ms": cuda_ms(
                    timed(fns[0]), iters), "library_event_ms": cuda_ms(
                    timed(fns[2]), max(iters // 2, 4))})
            if counts is not None:
                row["route"] = ran[0] if len(ran) == 1 else ran
                rule = route and route(args[0].dtype, args[kv_arg].dtype,
                                       args[0].shape[-1])
                if rule and row["route"] != rule:
                    raise AssertionError(
                        f"{name}: q {q_name}, kv {kv_name} ran {ran}, not "
                        f"its route's {rule} kernel")
            emit(row)
            del copies
            if (q_name, kv_name, window) in (MAIN_FP, MAIN_INT8):
                main[q_name, kv_name, window] = row
    return main


def phase_kernels():
    """K1, K2, K5 and K3 against their plain versions at the main path's
    shapes, then K1 against K2 on the same rows. Returns each kernel's
    main-path rows."""
    main = {"decode_attention": phase_decode_kernel(),
            "paged_decode_attention": phase_paged_decode_kernel(),
            "paged_verify_attention": phase_verify_kernel(),
            "paged_prefill_attention": phase_prefill_kernel()}
    phase_decode_identity()
    phase_verify_tree_rows()
    return main


def phase_prefill_kernel():
    """K3 against its plain version at the main path's shapes, in every
    mode and window, timed. Returns its main-path rows."""
    import torch
    from repro_torch.kernels import paged_prefill_attention as k3
    from repro_torch.kernels import ref
    return _check_kernel(
        "paged_prefill_attention", k3.paged_prefill_attention,
        ref.paged_prefill_attention_ref, _library_prefill, _prefill_inputs,
        lambda a, w: _prefill_bound(a[0], a[1], a[3], a[6], a[7], w),
        dead=_dead_rows(CHUNK_LENS, CHUNK), cold=(3, 4), iters=16,
        kv_pos=(3, 4))


def _dead_rows(lens, c):
    """(B, C) the lanes K3 writes as exact zeros: every lane of a dead row
    (a live row's padding lanes attend its keys)."""
    import torch
    return (torch.tensor(lens) == 0)[:, None].expand(-1, c)


# K3 at a chunk of 200 tokens (no multiple of the tensor-core kernel's 128
# query rows or 64 keys) with a window of 300, whose start falls inside a
# cached page and inside a 64-key tile for every row but a block's first:
# every mode against its plain version, checked and not timed; at the main
# path's heads, at every other head dim of the reference's configs (168:
# gemma3-27b, 112: kimi-k2 and zamba2, 64: whisper, 24, 16 and 8: the smoke
# configs; on the SIMT kernel in every mode) and at granite-34b's MQA
# group of 48 (H 48 on one KV head of 128; bf16 q over bf16 and int8 pools
# on the tensor cores)
RAGGED_CHUNK, RAGGED_WINDOW = 200, 300
PREFILL_RAGGED_HEADS = ((H, HKV, D), (H, HKV, 168), (H, HKV, 112),
                        (H, HKV, 64), (H, HKV, 24), (H, HKV, 16), (H, HKV, 8),
                        (48, 1, 128))


def _launched(fn, call):
    """(``call()``'s result, the one kernel of ``fn`` it launched), read
    from the wrapper's per-kernel counters."""
    import torch
    before = dict(fn.launches_by_kernel)
    out = call()
    torch.cuda.synchronize()
    ran = [n for n, c in fn.launches_by_kernel.items() if c != before[n]]
    if len(ran) != 1:
        raise AssertionError(f"{fn.__name__}: one call launched {ran}")
    return out, ran[0]


def phase_prefill_ragged():
    """K3 at C = 200 with the window of 300 and without one, in every mode,
    at each of ``PREFILL_RAGGED_HEADS``, within MODES' bounds (a live
    row's padding lanes too), exact zeros on the dead row; each row names
    the kernel its call launched, which must be the one ``route``
    names."""
    import torch
    from repro_torch.kernels import paged_prefill_attention as k3
    from repro_torch.kernels import ref
    t0 = time.monotonic()
    lens = [min(n, RAGGED_CHUNK) for n in CHUNK_LENS]
    dead = _dead_rows(lens, RAGGED_CHUNK)
    rows = []
    for heads in PREFILL_RAGGED_HEADS:
        d = heads[2]
        for q_name, kv_name, atol, rtol in MODES:
            args = list(_prefill_inputs(getattr(torch, q_name),
                                        getattr(torch, kv_name), heads))
            for i in (0, 1, 2):                 # q, k_new, v_new
                args[i] = args[i][:, :RAGGED_CHUNK].contiguous()
            args[7] = torch.tensor(lens, dtype=torch.int32, device="cuda")
            kw = ({"k_scale": args[8], "v_scale": args[9]}
                  if kv_name == "int8" else {})
            rule = k3.route(args[0].dtype, args[3].dtype, d)
            for window in (-1, RAGGED_WINDOW):
                got, kernel = _launched(
                    k3.paged_prefill_attention,
                    lambda: k3.paged_prefill_attention(
                        *args[:8], scale=d ** -0.5, window=window, **kw))
                want = ref.paged_prefill_attention_ref(
                    *args[:8], scale=d ** -0.5, window=window, **kw)
                err = (got.float() - want.float()).abs()
                if not (bool((err <= atol + rtol * want.float().abs()).all())
                        and bool((got[dead.cuda()] == 0).all())
                        and bool(torch.isfinite(got).all())
                        and kernel == rule):
                    raise AssertionError(
                        f"paged_prefill_attention disagrees with its plain "
                        f"version at C = {RAGGED_CHUNK}, heads {heads}: q "
                        f"{q_name}, kv {kv_name}, window {window}: max abs "
                        f"err {float(err.max())} (atol {atol}, rtol {rtol}),"
                        f" ran {kernel} (route {rule})")
                rows.append([list(heads), q_name, kv_name, window, kernel,
                             float(err.max())])
    emit({"phase": "kernels_ragged", "kernel": "paged_prefill_attention",
          "chunk": RAGGED_CHUNK, "lens": lens,
          "rows_heads_q_kv_window_ran_err": rows,
          "seconds": time.monotonic() - t0})


def phase_routes():
    """Which kernel each K1, K2, K3 and K5 mode, each K4 regime, K9 and
    each K11 regime and each K6-K8 and K10 mode ran: one call of each at
    the main path's shapes (K1,
    K2 and K5 (T = 5) also at head dims 64 and 168, K3 at 168; K4 on a
    4608 x 512 weight; K9
    with fp32 and bf16 dx; K11 at M = 1, 8, 9 and 64, fp32 and bf16 x;
    K6-K8 in
    fp32 and bf16 and K10 in each of its modes at head dims 128 and 64, S
    = 256), read from the wrappers' per-kernel counters; each must be the
    kernel that the wrapper's rule (``route``, ``regime``) names."""
    import torch
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_matmul as k4
    from repro_torch.kernels import paged_decode_attention as k2
    from repro_torch.kernels import paged_prefill_attention as k3
    from repro_torch.kernels import paged_verify_attention as k5
    from repro_torch.kernels import ternary_matmul as k11
    from repro_torch.quant import ternary

    def ran(fn, call):
        return _launched(fn, call)[1]

    k3_ran, k4_ran = {}, {}
    for d in (D, 168):
        for q_name, kv_name, _, _ in MODES:
            args = _prefill_inputs(getattr(torch, q_name),
                                   getattr(torch, kv_name), (H, HKV, d))
            kw = ({"k_scale": args[8], "v_scale": args[9]}
                  if kv_name == "int8" else {})
            key = f"q {q_name}, kv {kv_name}, D = {d}"
            k3_ran[key] = ran(k3.paged_prefill_attention,
                              lambda: k3.paged_prefill_attention(
                                  *args[:8], scale=d ** -0.5, **kw))
            if k3_ran[key] != k3.route(args[0].dtype, args[3].dtype, d):
                raise AssertionError(f"K3 {key} ran its {k3_ran[key]} "
                                     f"kernel")
    k1_ran, k2_ran, k5_ran = {}, {}, {}
    lengths = [min(n, RAGGED_BLOCKS * PAGE) for n in LENGTHS]
    for d in (D, 64, 168):
        for q_name, kv_name, _, _ in MODES:
            q, *rest = _ragged_decode_inputs((H, HKV, d), SPEC_K + 1,
                                             lengths)(
                getattr(torch, q_name), getattr(torch, kv_name))
            kw = ({"k_scale": rest[4], "v_scale": rest[5]}
                  if kv_name == "int8" else {})
            key = f"q {q_name}, kv {kv_name}, D = {d}"
            want = k2.route(q.dtype, rest[0].dtype, d)
            k2_ran[key] = ran(k2.paged_decode_attention,
                              lambda: k2.paged_decode_attention(
                                  q[:, 0].contiguous(), *rest[:4],
                                  scale=d ** -0.5, **kw))
            k5_ran[key] = ran(k5.paged_verify_attention,
                              lambda: k5.paged_verify_attention(
                                  q, *rest[:4], scale=d ** -0.5, **kw))
            # K1 over the pool's first pages, seen as a slot-major cache
            dense = [t[:B * 16].reshape(B, 16 * PAGE, *t.shape[2:])
                     for t in rest[:2] + rest[4:]]
            dkw = dict(zip(("k_scale", "v_scale"), dense[2:]))
            k1_ran[key] = ran(k1.decode_attention,
                              lambda: k1.decode_attention(
                                  q[:, 0].contiguous(), *dense[:2], rest[3],
                                  scale=d ** -0.5, **dkw))
            if k1_ran[key] != want or k2_ran[key] != want \
                    or k5_ran[key] != want:
                raise AssertionError(f"K1 / K2 / K5 {key} ran their "
                                     f"{k1_ran[key]} / {k2_ran[key]} / "
                                     f"{k5_ran[key]} kernels, not {want}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for x_name, m in (("bfloat16", 8), ("bfloat16", 40), ("bfloat16", 2048),
                      ("float32", 8), ("float32", 4096)):
        x, q, sc = _k4_inputs(gen, m, 4608, 512, getattr(torch, x_name))
        key = f"x {x_name}, M = {m}"
        k4_ran[key] = ran(k4.int8_matmul, lambda: k4.int8_matmul(x, q, sc))
        if k4_ran[key] != k4.regime(m, x.dtype):
            raise AssertionError(f"K4 {key} ran its {k4_ran[key]} kernel")
    k9_ran, k11_ran = {}, {}
    dy, q9, sc9 = _k9_inputs(gen, 64, 512, 256)
    for out_name in K9_TOL:
        k9_ran[out_name] = ran(k4.int8_matmul_dx, lambda: k4.int8_matmul_dx(
            dy, q9, sc9, getattr(torch, out_name)))
        if k9_ran[out_name] != "tensor_cores":
            raise AssertionError(f"K9 {out_name} ran its {k9_ran[out_name]} "
                                 f"kernel")
    tw = ternary.ternarize(torch.randn((512, 256), generator=gen,
                                       device="cuda"))
    for x_name in ("float32", "bfloat16"):
        for m in (1, 8, 9, 64):
            x = torch.randn((m, 512), generator=gen, device="cuda").to(
                getattr(torch, x_name))
            key = f"x {x_name}, M = {m}"
            k11_ran[key] = ran(k11.ternary_matmul, lambda: k11.ternary_matmul(
                x, tw.q, tw.scale))
            if k11_ran[key] != k11.route(m):
                raise AssertionError(f"K11 {key} ran its {k11_ran[key]} "
                                     f"kernel")
    k6_ran, k7_ran, k8_ran, k10_ran = {}, {}, {}, {}
    for d in (D, 64):
        for q_name in FLASH_TOL:
            dt = getattr(torch, q_name)
            q, dout = (_randn(gen, (1, 256, 12, d), dt) for _ in range(2))
            k, v = (_randn(gen, (1, 256, 4, d), dt) for _ in range(2))
            kw = dict(scale=d ** -0.5, causal=True, window=-1)
            key = f"{q_name}, D = {d}"
            fwd = {}
            k6_ran[key] = ran(fa.flash_attention_fwd, lambda: fwd.update(
                res=fa.flash_attention_fwd(q, k, v, **kw)))
            out, lse = fwd["res"]
            if k6_ran[key] != fa.route(dt, d):
                raise AssertionError(f"K6 {key} ran its {k6_ran[key]} "
                                     f"kernel")
            for kv_name in ("int8", q_name):
                kv_dt = getattr(torch, kv_name)
                kk, vv = (_randn(gen, (1, 256, 4, d), kv_dt)
                          for _ in range(2))
                kvs = dict(zip(("k_scale", "v_scale"),
                               _scales(gen, kk, kv_dt)))
                key10 = f"q {q_name}, kv {kv_name}, D = {d}"
                k10_ran[key10] = ran(fa.flash_attention,
                                     lambda: fa.flash_attention(
                                         q, kk, vv, **kw, **kvs))
                if k10_ran[key10] != fa.route(dt, d):
                    raise AssertionError(f"K10 {key10} ran its "
                                         f"{k10_ran[key10]} kernel")
            delta = (dout.float() * out.float()).sum(-1).transpose(
                1, 2).contiguous()
            k7_ran[key] = ran(fa.flash_attention_bwd_dq,
                              lambda: fa.flash_attention_bwd_dq(
                                  q, k, v, dout, lse, delta, **kw))
            k8_ran[key] = ran(fa.flash_attention_bwd_dkv,
                              lambda: fa.flash_attention_bwd_dkv(
                                  q, k, v, dout, lse, delta, **kw))
            want = fa.route(dt, d)
            if k7_ran[key] != want or k8_ran[key] != want:
                raise AssertionError(f"K7 / K8 {key} ran their "
                                     f"{k7_ran[key]} / {k8_ran[key]} "
                                     f"kernels, not {want}")
    emit({"phase": "routes", "decode_attention": k1_ran,
          "paged_decode_attention": k2_ran,
          "paged_verify_attention": k5_ran, "paged_prefill_attention": k3_ran,
          "int8_matmul": k4_ran, "int8_matmul_dx": k9_ran,
          "ternary_matmul": k11_ran, "flash_attention_fwd": k6_ran,
          "flash_attention_bwd_dq": k7_ran,
          "flash_attention_bwd_dkv": k8_ran, "flash_attention": k10_ran})


def _verify_inputs(t, heads=(H, HKV, D)):
    """K2's inputs (the same pools, table, lengths and scales) with a q of
    T lanes per slot."""
    import torch

    def inputs(q_dtype, kv_dtype):
        _, *rest = _paged_decode_inputs(q_dtype, kv_dtype, heads)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
        return (_randn(gen, (B, t, heads[0], heads[2]), q_dtype), *rest)
    return inputs


def phase_decode_kernel():
    """K1 against its plain version in every mode and window at the main
    path's shapes, timed by device time, with the kernel each mode ran.
    Returns its main-path rows."""
    import torch
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import ref
    return _check_kernel(
        "decode_attention", k1.decode_attention, ref.decode_attention_ref,
        _library_decode, _decode_inputs,
        lambda a, w: _decode_bound(a[0], a[1], a[3], w),
        dead=torch.tensor(LENGTHS) == 0, cold=(1, 2), iters=48,
        kv_pos=(1, 2), device_time=True, route=_k25_route())


def _as_pool(kv, table):
    """A pool of pages of PAGE rows (and the sink page, zeros) holding the
    rows of the slot-major ``kv`` (B, Sk, ...) where ``table`` (B, Sk /
    PAGE) puts them: K2's view of K1's cache."""
    import torch
    b, sk = kv.shape[:2]
    pages = kv.reshape(b * (sk // PAGE), PAGE, *kv.shape[2:])
    pool = torch.zeros((pages.shape[0] + 1, *pages.shape[1:]),
                       dtype=kv.dtype, device=kv.device)
    pool[table.flatten().long()] = pages
    return pool


def phase_decode_identity():
    """K1 on the dense cache against K2 on a permuted pool of pages of 16
    that holds the same rows, at the main path's shapes, in every mode and
    both windows: equal bit for bit (the split body splits, walks and
    merges the same keys in the same order whatever the row policy), and
    two calls of K1 equal bit for bit."""
    import torch
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import paged_decode_attention as k2
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    table = torch.randperm(B * N_BLOCKS, generator=gen, device="cuda").to(
        torch.int32).reshape(B, N_BLOCKS)
    rows = []
    for q_name, kv_name, _, _ in MODES:
        q, k, v, lengths, *sc = _decode_inputs(getattr(torch, q_name),
                                               getattr(torch, kv_name))
        pools = [_as_pool(t, table) for t in (k, v, *sc)]
        for window in WINDOWS:
            kw = dict(scale=D ** -0.5, window=window)
            dense_kw = dict(zip(("k_scale", "v_scale"), sc), **kw)
            paged_kw = dict(zip(("k_scale", "v_scale"), pools[2:]), **kw)
            first = k1.decode_attention(q, k, v, lengths, **dense_kw)
            second = k1.decode_attention(q, k, v, lengths, **dense_kw)
            paged = k2.paged_decode_attention(q, *pools[:2], table, lengths,
                                              **paged_kw)
            torch.cuda.synchronize()
            label = f"K1: q {q_name}, kv {kv_name}, window {window}"
            _same_bits(label, (first,), (second,))
            if not torch.equal(first, paged):
                raise AssertionError(
                    f"{label} differs from K2 on the same rows: max abs diff "
                    f"{float((first.float() - paged.float()).abs().max())}")
            rows.append([q_name, kv_name, window,
                         k2.route(q.dtype, k.dtype, D)])
    emit({"phase": "decode_identity", "kernel": "decode_attention",
          "equal_to": "paged_decode_attention, page size 16",
          "rows_q_kv_window_route": rows})


# K1's, K2's and K5's rule for the kernel a mode runs; a checkout from
# before their split (which decode_bench.py times beside this one) has none
def _k25_route():
    from repro_torch.kernels import paged_decode_attention as k2
    return getattr(k2, "route", None)


def phase_paged_decode_kernel():
    """K2 against its plain version in every mode and window at the main
    path's shapes, timed by device time. Returns its main-path rows."""
    import torch
    from repro_torch.kernels import paged_decode_attention as k2
    from repro_torch.kernels import ref
    return _check_kernel(
        "paged_decode_attention", k2.paged_decode_attention,
        ref.paged_decode_attention_ref, _library_paged_decode,
        _paged_decode_inputs,
        lambda a, w: _decode_bound(a[0], a[1], a[4], w, paged=True),
        dead=torch.tensor(LENGTHS) == 0, cold=(1, 2), iters=48,
        kv_pos=(1, 2), device_time=True, route=_k25_route())


def check_verify_kernel(t):
    """K5 with T lanes against its plain version in every mode and
    window at the main path's shapes, timed by device time. Returns its
    main-path rows."""
    import torch
    from repro_torch.kernels import paged_verify_attention as k5
    from repro_torch.kernels import ref
    lengths = torch.tensor(LENGTHS)
    q_pos = lengths[:, None] - t + torch.arange(t)[None]
    return _check_kernel(
        "paged_verify_attention", k5.paged_verify_attention,
        ref.paged_verify_attention_ref, _library_verify, _verify_inputs(t),
        lambda a, w: _verify_bound(a[0], a[1], a[4], w),
        dead=(lengths[:, None] == 0) | (q_pos < 0), cold=(1, 2), iters=48,
        kv_pos=(1, 2), extra={"T": t}, device_time=True,
        route=_k25_route())


def _lanes_against_k2(inputs, t, scale, label):
    """K5's lane t against K2 at length ``lengths - T + t + 1`` (the same
    keys), without a window, in every mode: equal bit for bit on the SIMT
    kernel (asserted: the same splits, tiles and sums), reported with the
    max abs difference on the tensor cores. Returns the rows."""
    import torch
    from repro_torch.kernels import paged_decode_attention as k2
    from repro_torch.kernels import paged_verify_attention as k5
    rows = []
    for q_name, kv_name, _, _ in MODES:
        q, k_pool, v_pool, table, lens, *sc = inputs(
            getattr(torch, q_name), getattr(torch, kv_name))
        kw = {"k_scale": sc[0], "v_scale": sc[1]} if sc else {}
        got = k5.paged_verify_attention(q, k_pool, v_pool, table, lens,
                                        scale=scale, **kw)
        equal, diff = True, 0.0
        for lane in range(t):
            want = k2.paged_decode_attention(
                q[:, lane].contiguous(), k_pool, v_pool, table,
                (lens - t + lane + 1).clamp(min=0).to(torch.int32),
                scale=scale, **kw)
            equal &= bool(torch.equal(got[:, lane], want))
            diff = max(diff, float((got[:, lane].float()
                                    - want.float()).abs().max()))
        route = k2.route(q.dtype, k_pool.dtype, q.shape[-1])
        if route == "simt" and not equal:
            raise AssertionError(
                f"{label}: K5 at T = {t} differs from K2 at each lane's "
                f"length on the SIMT kernel (q {q_name}, kv {kv_name}): max "
                f"abs diff {diff}")
        rows.append({"T": t, "q": q_name, "kv": kv_name, "route": route,
                     "lanes_equal_k2": equal, "max_abs_diff_k2": diff})
    return rows


def phase_verify_kernel():
    """K5 against its plain version for T = 1, 2 and 5 lanes in every mode
    and window, timed by device time; then each lane t against K2 at its
    length (``_lanes_against_k2``). Returns the main-path rows at T = 5."""
    main = {}
    for t in VERIFY_LANES:
        rows = check_verify_kernel(t)
        if t == max(VERIFY_LANES):
            main = rows
        for row in _lanes_against_k2(_verify_inputs(t), t, D ** -0.5,
                                     "paged_verify_attention"):
            emit({"phase": "kernels", "kernel": "paged_verify_attention",
                  "window": -1, **row})
    return main


def phase_verify_tree_rows():
    """K5 at a tree tick's rows: each of the 8 slots' ``TREE_M`` branch rows
    b * TREE_M + j (T = 5 lanes) over tables that share every page but the
    one holding the slot's last key, which branches 1 and 2 replace with
    pages of their own; the slots' LENGTHS (a dead slot, rows with no
    valid key among them). Every mode and window against the plain
    version, checked and not timed."""
    import torch
    from repro_torch.kernels import paged_verify_attention as k5
    from repro_torch.kernels import ref
    m, t = TREE_M, SPEC_K + 1
    lengths = torch.tensor(LENGTHS, dtype=torch.int32,
                           device="cuda").repeat_interleave(m)
    q_pos = lengths[:, None].cpu() - t + torch.arange(t)[None]
    dead = ((lengths.cpu() == 0)[:, None] | (q_pos < 0)).cuda()
    for q_name, kv_name, atol, rtol in MODES:
        q_dtype, kv_dtype = getattr(torch, q_name), getattr(torch, kv_name)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
        q = _randn(gen, (B * m, t, H, D), q_dtype)
        pages = B * N_BLOCKS + B * (m - 1)
        k_pool = _randn(gen, (pages + 1, PAGE, HKV, D), kv_dtype)
        v_pool = _randn(gen, (pages + 1, PAGE, HKV, D), kv_dtype)
        table = torch.randperm(B * N_BLOCKS, generator=gen, device="cuda").to(
            torch.int32).reshape(B, N_BLOCKS).repeat_interleave(m, dim=0)
        rows = torch.arange(B * m, device="cuda")
        branch = rows % m > 0
        last = ((lengths.long() - 1).clamp(min=0) // PAGE)
        own = (B * N_BLOCKS + (rows // m) * (m - 1) + rows % m - 1).to(
            torch.int32)
        table[rows[branch], last[branch]] = own[branch]
        kw = dict(zip(("k_scale", "v_scale"), _scales(gen, k_pool,
                                                      kv_dtype)))
        for window in WINDOWS:
            got = k5.paged_verify_attention(q, k_pool, v_pool, table,
                                            lengths, scale=D ** -0.5,
                                            window=window, **kw)
            want = ref.paged_verify_attention_ref(
                q, k_pool, v_pool, table, lengths, scale=D ** -0.5,
                window=window, **kw)
            err = (got.float() - want.float()).abs()
            ok = bool((err <= atol + rtol * want.float().abs()).all())
            if not (ok and bool((got[dead] == 0).all())
                    and bool(torch.isfinite(got).all())):
                raise AssertionError(
                    f"paged_verify_attention at the tree's rows disagrees "
                    f"with its plain version: q {q_name}, kv {kv_name}, "
                    f"window {window}: max abs err {float(err.max())}")
            emit({"phase": "kernels", "kernel": "paged_verify_attention",
                  "tree_rows": B * m, "T": t, "q": q_name, "kv": kv_name,
                  "window": window, "max_abs_err": float(err.max()),
                  "atol": atol, "rtol": rtol, "timed": False})


# K1, K2 and K5 at a capacity that is no multiple of the split (125 pages
# of 16: 2000 keys, whose last split is short; 256-key splits without a
# window, 64-key ones in a window of 300), with lengths 0, 1, at a split
# edge and one past it, at the capacity and one below it, and 777, whose
# window of 300 starts inside a split and inside a page; at the main path's
# heads (36 on 4 KV heads of 128), at head dims 64 (the SIMT kernel in
# every mode), 256 (T = 5 lanes take two lane groups there) and every
# other one of the reference's configs (168: gemma3-27b, 112: kimi-k2 and
# zamba2, 24, 16 and 8: the smoke configs), and at granite-34b's MQA group
# of 48 (48 heads on one KV head of 128: one lane a block at T = 5, on both
# kernels); every mode, T = 1, 2 and 5, windows -1 and 300: checked against
# the plain versions, not timed. K1 reads the pool's rows gathered into a
# slot-major cache and must equal K2 bit for bit
RAGGED_BLOCKS = 125
RAGGED_HEADS = ((H, HKV, 128), (H, HKV, 64), (H, HKV, 256), (H, HKV, 168),
                (H, HKV, 112), (H, HKV, 24), (H, HKV, 16), (H, HKV, 8),
                (48, 1, 128))


def _ragged_decode_inputs(heads, t, lengths):
    """inputs(q_dtype, kv_dtype) of K5 (T lanes; K2 takes lane 0) at
    ``heads`` = (H, Hkv, D) over a pool of B * RAGGED_BLOCKS pages and a
    permuted table, with ``lengths``."""
    import torch
    h, hkv, d = heads

    def inputs(q_dtype, kv_dtype):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
        q = _randn(gen, (B, t, h, d), q_dtype)
        pages = B * RAGGED_BLOCKS
        k_pool = _randn(gen, (pages + 1, PAGE, hkv, d), kv_dtype)
        v_pool = _randn(gen, (pages + 1, PAGE, hkv, d), kv_dtype)
        table = torch.randperm(pages, generator=gen, device="cuda").to(
            torch.int32).reshape(B, RAGGED_BLOCKS)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        return (q, k_pool, v_pool, table, lens) + _scales(gen, k_pool,
                                                          kv_dtype)
    return inputs


def phase_decode_ragged():
    """K1, K2 and K5 at the ragged shapes above within MODES' bounds, exact
    zeros for dead slots and rows with no key, each call on the kernel its
    route names (read from the wrappers' counters), K1 equal to K2 bit for
    bit, and K5's lanes equal to K2 bit for bit on the SIMT kernel."""
    import torch
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import paged_decode_attention as k2
    from repro_torch.kernels import paged_verify_attention as k5
    from repro_torch.kernels import ref
    t_start = time.monotonic()
    cap = RAGGED_BLOCKS * PAGE
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split, n_splits = k2.split_plan(cap, PAGE, B * HKV, sms)
    split_w = k2.split_plan(cap, PAGE, B * HKV, sms, RAGGED_WINDOW)[0]
    lengths = (0, 1, split, split + 1, cap, cap - 1, 777, 2 * split + 37)
    lo = 777 - RAGGED_WINDOW
    if (cap % split == 0 or cap % split_w == 0 or lo % split == 0
            or lo % split_w == 0 or lo % PAGE == 0):
        raise AssertionError(f"the ragged case misses its edges: capacity "
                             f"{cap}, splits {split} and {split_w} (window), "
                             f"window start {lo}")
    rows, lanes = [], []
    for heads in RAGGED_HEADS:
        d = heads[2]
        for q_name, kv_name, atol, rtol in MODES:
            for t in (-1, 0) + VERIFY_LANES:        # t = -1: K1, 0: K2
                args = list(_ragged_decode_inputs(heads, max(t, 1), lengths)(
                    getattr(torch, q_name), getattr(torch, kv_name)))
                kw = ({"k_scale": args[5], "v_scale": args[6]}
                      if kv_name == "int8" else {})
                lens = torch.tensor(lengths)
                rule = k2.route(args[0].dtype, args[1].dtype, d)
                if t <= 0:
                    args[0] = args[0][:, 0].contiguous()
                    kernel, plain = (k2.paged_decode_attention,
                                     ref.paged_decode_attention_ref)
                    dead = lens == 0
                else:
                    kernel, plain = (k5.paged_verify_attention,
                                     ref.paged_verify_attention_ref)
                    q_pos = lens[:, None] - t + torch.arange(t)[None]
                    dead = (lens[:, None] == 0) | (q_pos < 0)
                if t == -1:
                    # the pool's rows as K1's slot-major cache (B, cap, ...)
                    dense = [ref.paged_gather(a, args[3]).contiguous()
                             for a in args[1:3]]
                    dkw = {name: ref.paged_gather(sc, args[3]).contiguous()
                           for name, sc in kw.items()}
                for window in (-1, RAGGED_WINDOW):
                    if t == -1:
                        got, ran = _launched(
                            k1.decode_attention, lambda: k1.decode_attention(
                                args[0], *dense, args[4], scale=d ** -0.5,
                                window=window, **dkw))
                        paged = k2.paged_decode_attention(
                            *args[:5], scale=d ** -0.5, window=window, **kw)
                        if not torch.equal(got, paged):
                            raise AssertionError(
                                f"decode_attention differs from "
                                f"paged_decode_attention on the same rows: "
                                f"heads {heads}, q {q_name}, kv {kv_name}, "
                                f"window {window}: max abs diff "
                                f"{float((got.float() - paged.float()).abs().max())}")
                    else:
                        got, ran = _launched(kernel, lambda: kernel(
                            *args[:5], scale=d ** -0.5, window=window, **kw))
                    want = plain(*args[:5], scale=d ** -0.5, window=window,
                                 **kw)
                    err = (got.float() - want.float()).abs()
                    name = ("decode_attention" if t == -1
                            else kernel.__name__)
                    if not (bool((err <= atol + rtol * want.float().abs())
                                 .all())
                            and bool((got[dead.cuda()] == 0).all())
                            and bool(torch.isfinite(got).all())
                            and ran == rule):
                        raise AssertionError(
                            f"{name} disagrees with its plain version at the "
                            f"ragged shapes: heads {heads}, T {t}, q "
                            f"{q_name}, kv {kv_name}, window {window}: max "
                            f"abs err {float(err.max())} (atol {atol}, rtol "
                            f"{rtol}), dead rows zero "
                            f"{bool((got[dead.cuda()] == 0).all())}, ran "
                            f"{ran} (route {rule})")
                    rows.append([list(heads), t, q_name, kv_name, window, ran,
                                 float(err.max())])
        for t in VERIFY_LANES:
            lanes += [[list(heads), r["T"], r["q"], r["kv"], r["route"],
                       r["lanes_equal_k2"], r["max_abs_diff_k2"]]
                      for r in _lanes_against_k2(
                          _ragged_decode_inputs(heads, t, lengths), t,
                          d ** -0.5, f"ragged heads {heads}")]
    emit({"phase": "kernels_ragged",
          "kernel": "decode_attention, paged_decode_attention, "
                    "paged_verify_attention",
          "capacity": cap, "split": split, "splits": n_splits,
          "split_in_window": split_w,
          "lengths": list(lengths), "window": RAGGED_WINDOW,
          "t_minus1_is_k1_0_is_k2": True,
          "rows_heads_t_q_kv_window_ran_err": rows,
          "lanes_heads_t_q_kv_route_equal_diff": lanes,
          "seconds": time.monotonic() - t_start})


# gemma3-27b's attention heads at full width (32 query heads on 16 KV
# heads of 168) and its local layers' window: K1, K2, K5 (T = 5) and K3
# at the main path's lengths, timed in the serve modes (bf16 q over the
# fp32 cache and over the int8 cache) beside their D = 128 rows
G3_HEADS, G3_WINDOW = (32, 16, 168), 1024
G3_MODES = tuple(m for m in MODES if (m[0], m[1]) in (MAIN_FP[:2],
                                                      MAIN_INT8[:2]))
# kimi-k2-1t-a32b's heads at full width (64 query heads on 8 KV heads of
# 112), no window: the same calls
KIMI_HEADS = (64, 8, 112)
# K3 at those heads in every bf16-q mode: its tensor-core kernel over the
# bf16 and the int8 pool (D = 112 and 168 on tiles of 128 and 192
# columns), its SIMT kernel over the fp32 one
K3_WIDE_MODES = tuple(m for m in MODES if m[0] == "bfloat16")


def phase_kernels_d168():
    """K1, K2, K5 (T = 5) and K3 at gemma3-27b's heads, windows -1 and
    1024, in the two serve modes, against their plain versions and timed
    as ``phase_kernels`` times them at D = 128 (K1, K2, K5 by device
    time). Returns each kernel's MAIN_INT8 row."""
    return _kernels_at_heads("kernels_d168", G3_HEADS, (-1, G3_WINDOW))


def phase_kernels_d112():
    """The same at kimi-k2-1t-a32b's heads, without a window."""
    return _kernels_at_heads("kernels_d112", KIMI_HEADS, (-1,))


def _kernels_at_heads(phase, heads, windows):
    """K1, K2, K5 (T = 5) at ``heads`` (H, Hkv, D), in the two serve modes
    and ``windows``, and K3 in every bf16-q mode (its tensor-core kernel
    over bf16 and int8 pools, asserted from its counters), checked and
    timed as at D = 128. Returns each kernel's MAIN_INT8 row."""
    import torch
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import paged_decode_attention as k2
    from repro_torch.kernels import paged_prefill_attention as k3
    from repro_torch.kernels import paged_verify_attention as k5
    from repro_torch.kernels import ref
    t0 = time.monotonic()
    t = SPEC_K + 1
    lengths = torch.tensor(LENGTHS)
    q_pos = lengths[:, None] - t + torch.arange(t)[None]
    kw = dict(iters=48, kv_pos=(1, 2), device_time=True, route=_k25_route(),
              modes=G3_MODES, windows=windows, cold=(1, 2))
    rows = {
        "decode_attention": _check_kernel(
            "decode_attention", k1.decode_attention, ref.decode_attention_ref,
            _library_decode, lambda q, kv: _decode_inputs(q, kv, heads),
            lambda a, w: _decode_bound(a[0], a[1], a[3], w),
            dead=lengths == 0, **kw),
        "paged_decode_attention": _check_kernel(
            "paged_decode_attention", k2.paged_decode_attention,
            ref.paged_decode_attention_ref, _library_paged_decode,
            lambda q, kv: _paged_decode_inputs(q, kv, heads),
            lambda a, w: _decode_bound(a[0], a[1], a[4], w, paged=True),
            dead=lengths == 0, **kw),
        "paged_verify_attention": _check_kernel(
            "paged_verify_attention", k5.paged_verify_attention,
            ref.paged_verify_attention_ref, _library_verify,
            _verify_inputs(t, heads),
            lambda a, w: _verify_bound(a[0], a[1], a[4], w),
            dead=(lengths[:, None] == 0) | (q_pos < 0), extra={"T": t},
            **kw),
        "paged_prefill_attention": _check_kernel(
            "paged_prefill_attention", k3.paged_prefill_attention,
            ref.paged_prefill_attention_ref, _library_prefill,
            lambda q, kv: _prefill_inputs(q, kv, heads),
            lambda a, w: _prefill_bound(a[0], a[1], a[3], a[6], a[7], w),
            dead=_dead_rows(CHUNK_LENS, CHUNK),
            cold=(3, 4), iters=16, kv_pos=(3, 4), modes=K3_WIDE_MODES,
            windows=windows, route=k3.route, kv_arg=3)}
    emit({"phase": phase, "heads": list(heads),
          "seconds": time.monotonic() - t0})
    return {name: r[MAIN_INT8] for name, r in rows.items()}


# (M, K, N, x dtype, output dtype) of K4's checks: a decode tick's
# projections at 8 slots (wq/wo, wk/wv, w_in, w_out: the decode kernel,
# timed by device time), then the same at a speculative tick's 8 slots x 5
# lanes (M = 40, the wgmma kernel), the prefill GEMMs of an extend call (8
# rows x 256-token chunks), fp32 x, and the fp32-output mode of bf16 x that
# int8_matmul_train's forward runs, at a decode and a training batch (4096
# tokens)
K4_DECODE = ((8, 4608, 4608, "bfloat16", "bfloat16"),
             (8, 4608, 512, "bfloat16", "bfloat16"),
             (8, 4608, 18432, "bfloat16", "bfloat16"),
             (8, 18432, 4608, "bfloat16", "bfloat16"))
K4_SHAPES = ((40, 4608, 4608, "bfloat16", "bfloat16"),
             (40, 4608, 512, "bfloat16", "bfloat16"),
             (40, 4608, 18432, "bfloat16", "bfloat16"),
             (40, 18432, 4608, "bfloat16", "bfloat16"),
             (2048, 4608, 18432, "bfloat16", "bfloat16"),
             (2048, 18432, 4608, "bfloat16", "bfloat16"),
             (8, 4608, 18432, "float32", "float32"),
             (8, 4608, 18432, "bfloat16", "float32"),
             (4096, 4608, 18432, "bfloat16", "float32"))
K4_MAIN = (8, 4608, 18432, "bfloat16", "bfloat16")
# fp32 x: 1e-5, absolute and relative to the output (a sum of K = 4608
# products of O(1) outputs differs from cuBLAS's in its last ~5 bits).
# bf16 x: one bf16 rounding of the output (an ulp, 2^-7 relative, where
# the two fp32 sums straddle a rounding boundary), plus 1e-3 absolute for
# outputs near zero: the tensor cores' fp32 accumulation over K = 18432
# differs from cuBLAS's fp32 sum by about 1e-4 there
# bf16 x with fp32 output: the same 1e-3 absolute for the accumulation
# order, and no output rounding (1e-5 relative). Keyed on (x, output).
K4_TOL = {("float32", "float32"): (1e-5, 1e-5),
          ("bfloat16", "bfloat16"): (1e-3, 2.0 ** -7),
          ("bfloat16", "float32"): (1e-3, 1e-5)}
# each timed call reads its own weight copy, these bytes of copies at least
# (twice the 50 MB L2): every layer's weights are cold on a decode tick
K4_COLD_BYTES = 100e6
# (M, K, N, output dtype) of the wgmma kernel checked but not timed: ragged
# M (9, 100, 2047: no multiple of its 64/128/256-row tiles) and N (1008 and
# 4624: multiples of 16 that no 128-column tile divides), both outputs;
# then an N that TMA cannot take (N % 16 != 0), which must raise
K4_RAGGED = ((9, 4608, 1008, "bfloat16"), (9, 4608, 4624, "float32"),
             (100, 4608, 4624, "bfloat16"), (100, 18432, 1008, "float32"),
             (2047, 4608, 1008, "bfloat16"), (2047, 4608, 4624, "float32"))
K4_REFUSED = (40, 4608, 1000)
# the decode kernel's ragged shapes, checked and not timed: M = 1, 3, 7
# and 8 rows over (K, N) of a K below one 128-row round and an N below
# one 128-column tile, N % 16 != 0 (byte loads), an N no tile divides,
# and a K that is no whole number of rounds over a narrow N; both outputs
K4_DECODE_RAGGED_M = (1, 3, 7, 8)
K4_DECODE_RAGGED_KN = ((48, 13), (4608, 1000), (4608, 4624), (18464, 512))


def _k4_inputs(gen, m, k, n, dt):
    """x (m, k) in ``dt``, and a normal (k, n) weight quantized as the
    engine quantizes it: int8 codes and fp32 per-column scales."""
    import torch
    from repro_torch.quant import int8 as int8_lib
    x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
    w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
    leaf = int8_lib.quantize_weight(w)
    return x, leaf["q8"], leaf["s8"].reshape(n).contiguous()


def _check_k4(x, q, sc, odt):
    """K4 on (x, q, sc) against its plain version within K4_TOL; returns
    the kernel's output and the max abs error."""
    import torch
    from repro_torch.kernels import int8_matmul as k4
    from repro_torch.kernels import ref
    got = k4.int8_matmul(x, q, sc, out_dtype=odt)
    torch.cuda.synchronize()
    want = ref.int8_matmul_ref(x, q, sc, out_dtype=odt)
    x_name = str(x.dtype).replace("torch.", "")
    out_name = str(odt).replace("torch.", "")
    atol, rtol = K4_TOL[x_name, out_name]
    err = (got.float() - want.float()).abs()
    max_err = float(err.max())
    excess = err - (atol + rtol * want.float().abs())
    if not (float(excess.max()) <= 0.0 and torch.isfinite(got).all()
            and got.dtype == odt):
        (m, k), n = x.shape, q.shape[1]
        worst = int(excess.argmax())
        raise AssertionError(
            f"int8_matmul disagrees with its plain version at "
            f"{m}x{k}x{n} {x_name} -> {out_name} ({got.dtype}): max abs "
            f"err {max_err} (atol {atol}, "
            f"rtol {rtol}); worst element {divmod(worst, n)}: kernel "
            f"{float(got.flatten()[worst])}, plain "
            f"{float(want.flatten()[worst])}")
    return got, max_err


def _k4_row(gen, m, k, n, x_name, out_name):
    """K4 at one shape held against its plain version, with its time,
    bound, the plain version's time and cuBLAS on the dequantized weight,
    every timed call on its own cold weight copy. The decode kernel's
    times are device time from torch.profiler (a decode call's launch can
    take the host longer than the kernel takes the card), its and the
    library call's CUDA-event times beside them; a second call on the same
    inputs must give the first one's bits."""
    import torch
    from repro_torch.core import flops as fl
    from repro_torch.kernels import int8_matmul as k4
    from repro_torch.kernels import ref
    dt, odt = getattr(torch, x_name), getattr(torch, out_name)
    x, q, sc = _k4_inputs(gen, m, k, n, dt)
    got, max_err = _check_k4(x, q, sc, odt)
    _same_bits(f"K4 {m}x{k}x{n}", (got,), (k4.int8_matmul(
        x, q, sc, out_dtype=odt),))
    atol, rtol = K4_TOL[x_name, out_name]
    decode = k4.regime(m, dt) == "decode"
    timer = device_ms if decode else cuda_ms
    qs = [q] + [q.clone() for _ in range(
        max(3, int(K4_COLD_BYTES // q.numel())))]
    iters = 24 if m <= 2048 else 8

    def kernel(i):
        return k4.int8_matmul(x, qs[i % len(qs)], sc, out_dtype=odt)
    kernel_ms = timer(kernel, iters)
    plain_ms = timer(lambda i: ref.int8_matmul_ref(
        x, qs[i % len(qs)], sc, out_dtype=odt), 6 if m <= 2048 else 3)
    # the yardstick moves 2x (bf16) or 4x (fp32) the weight bytes
    wd = [(c.float() * sc).to(dt) for c in qs[:max(
        2, int(K4_COLD_BYTES // (q.numel() * x.element_size())))]]

    def library(i):
        return x @ wd[i % len(wd)]
    library_ms = timer(library, iters)
    row = {"phase": "int8_matmul", "kernel": k4.regime(m, dt), "m": m,
           "k": k, "n": n, "x": x_name, "out": out_name,
           "max_abs_err": max_err, "atol": atol, "rtol": rtol,
           "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "cuBLAS x @ w, w dequantized once: not the same "
                      "function, it moves 2x (bf16) or 4x (fp32) the "
                      "weight bytes"}
    if decode:
        row.update({"timing": "device", "event_ms": cuda_ms(kernel, iters),
                    "library_event_ms": cuda_ms(library, iters)})
    del qs, wd
    ops, nbytes = fl.matmul_work(x, q, n, got.element_size())
    row["bound_ms"], row["bound_by"] = _bound(nbytes, ops / _peak_coded(x))
    return row


def phase_int8_decode():
    """K4's decode kernel (bf16 x, M <= 8) against its plain version at a
    decode tick's four projections, timed by device time with CUDA events
    beside, two calls equal bit for bit; then at the ragged decode shapes
    (checked, not timed), both outputs. Returns the main row (w_in)."""
    import torch
    from repro_torch.kernels import int8_matmul as k4
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    main = None
    for m, k, n, x_name, out_name in K4_DECODE:
        row = _k4_row(gen, m, k, n, x_name, out_name)
        emit(row)
        if (m, k, n, x_name, out_name) == K4_MAIN:
            main = row
    ragged = []
    for k, n in K4_DECODE_RAGGED_KN:
        for m in K4_DECODE_RAGGED_M:
            x, q, sc = _k4_inputs(gen, m, k, n, torch.bfloat16)
            for odt in (torch.bfloat16, torch.float32):
                got, err = _check_k4(x, q, sc, odt)
                _same_bits(f"K4 {m}x{k}x{n}", (got,), (k4.int8_matmul(
                    x, q, sc, out_dtype=odt),))
                ragged.append([m, k, n, str(odt).split(".")[1], err])
    emit({"phase": "int8_matmul_ragged", "kernel": "decode",
          "rows_m_k_n_out_err": ragged})
    return main


def phase_int8_matmul():
    """K4 against its plain version at the main path's shapes past the
    decode tick's (the decode kernel's are ``phase_int8_decode``'s), with
    its time, bound, the plain version's time and cuBLAS on the
    dequantized weight; then the wgmma kernel's ragged shapes (checked,
    not timed) and the shape it must refuse."""
    import torch
    from repro_torch.kernels import int8_matmul as k4
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    for m, k, n, x_name, out_name in K4_SHAPES:
        emit(_k4_row(gen, m, k, n, x_name, out_name))
    ragged = []
    for m, k, n, out_name in K4_RAGGED:
        x, q, sc = _k4_inputs(gen, m, k, n, torch.bfloat16)
        ragged.append([m, k, n, out_name,
                       _check_k4(x, q, sc, getattr(torch, out_name))[1]])
    m, k, n = K4_REFUSED
    x, q, sc = _k4_inputs(gen, m, k, n, torch.bfloat16)
    try:
        k4.int8_matmul(x, q, sc)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError(f"int8_matmul took N = {n} (N % 16 != 0) at "
                             f"M = {m}: its TMA descriptors cannot")
    emit({"phase": "int8_matmul_ragged", "kernel": "wgmma",
          "rows": ragged, "refused": [m, k, n], "error": refused})


# K4 at the int8 mode's weight shapes of the dense family at full width:
# (K, N) of wq and wo, wk and wv, w_in (and w_gate) and w_out, checked
# against its plain version at a decode tick's M = 8 (the decode kernel)
# and a speculative tick's M = 40 (the wgmma kernel), bf16 x, not timed
K4_FAMILY = {"gemma3-27b": ((5376, 5376), (5376, 2688), (5376, 21504),
                            (21504, 5376)),
             "granite-34b": ((6144, 6144), (6144, 128), (6144, 24576),
                             (24576, 6144)),
             "qwen1.5-110b": ((8192, 8192), (8192, 1024), (8192, 49152),
                              (49152, 8192)),
             "qwen2-vl-72b": ((8192, 8192), (8192, 1024), (8192, 29568),
                              (29568, 8192))}


def phase_int8_family():
    """K4 at every (K, N) of ``K4_FAMILY``, M = 8 and 40, bf16 x and
    output, within K4_TOL, each call on the kernel ``regime`` names."""
    import torch
    from repro_torch.kernels import int8_matmul as k4
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    rows = []
    for arch, shapes in K4_FAMILY.items():
        for k, n in shapes:
            for m in (8, 40):
                x, q, sc = _k4_inputs(gen, m, k, n, torch.bfloat16)
                (_, err), ran = _launched(k4.int8_matmul, lambda: _check_k4(
                    x, q, sc, torch.bfloat16))
                if ran != k4.regime(m, x.dtype):
                    raise AssertionError(f"int8_matmul at {m}x{k}x{n} ran "
                                         f"its {ran} kernel")
                rows.append([arch, m, k, n, ran, err])
                del x, q, sc
    emit({"phase": "int8_matmul_family", "rows_arch_m_k_n_ran_err": rows,
          "seconds": time.monotonic() - t0})


# K9 at the training path's projection shapes of starcoder2-7b, M = 4096
# tokens: (K, N) of wq and wo, wk (and wv), w_in and w_out; dx in fp32 and
# bf16 (x's dtype). Tolerance: fp32 dx within 1e-5 of the plain version's
# max abs (fp32 sums of N up to 18432 products in another order); bf16 dx
# also one bf16 rounding of each element (2^-7 relative, where the two
# fp32 sums straddle a rounding boundary)
K9_M = 4096
K9_SHAPES = ((4608, 4608), (4608, 512), (4608, 18432), (18432, 4608))
K9_MAIN = (4608, 18432, "float32")
K9_TOL = {"float32": (1e-5, 0.0), "bfloat16": (1e-5, 2.0 ** -7)}
# (M, K, N) checked in both outputs, not timed: a contraction of 50 (no
# whole 64-deep stage; rows not 16 bytes apart, so dy and the codes take
# the kernel's element loads), a tiny one, and N = 1000 (dy by TMA, the
# codes in 8-byte loads) at the training batch
K9_RAGGED = ((100, 300, 50), (9, 7, 3), (4096, 4608, 1000))


def _k9_inputs(gen, m, k, n):
    """fp32 dy (m, n), random int8 codes (k, n) and positive scales."""
    import torch
    dy = torch.randn((m, n), generator=gen, device="cuda")
    q = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                      dtype=torch.int8)
    sc = (torch.rand(n, generator=gen, device="cuda") + 0.5) * 1e-3
    return dy, q, sc


def _check_k9(dy, q, sc, odt, label):
    """K9 on (dy, q, sc) against its plain version within K9_TOL, on its
    tensor-core kernel (``launches_by_kernel``), a second call equal bit for
    bit; returns (the kernel's output, its max abs error, the plain
    version's max abs)."""
    import torch
    from repro_torch.kernels import int8_matmul as k4
    from repro_torch.kernels import ref
    before = dict(k4.int8_matmul_dx.launches_by_kernel)
    got = k4.int8_matmul_dx(dy, q, sc, odt)
    torch.cuda.synchronize()
    ran = {n: c - before[n] for n, c in
           k4.int8_matmul_dx.launches_by_kernel.items()}
    if ran != {"tensor_cores": 1}:
        raise AssertionError(f"int8_matmul_dx at {label}: one call "
                             f"launched {ran}")
    want = ref.int8_matmul_dx_ref(dy, q, sc, odt)
    rel_max, rtol = K9_TOL[str(odt).split(".")[1]]
    err = (got.float() - want.float()).abs()
    max_err = float(err.max())
    peak = float(want.float().abs().max())
    excess = err - (rel_max * peak + rtol * want.float().abs())
    if not (float(excess.max()) <= 0.0 and got.dtype == odt
            and got.shape == want.shape and torch.isfinite(got).all()):
        raise AssertionError(
            f"int8_matmul_dx disagrees with its plain version at {label}: "
            f"max abs err {max_err} of max {peak} ({got.dtype})")
    _same_bits(f"K9 {label}", (got,), (k4.int8_matmul_dx(dy, q, sc, odt),))
    return got, max_err, peak


def _one_launch(label, fn, iters=8, attempts=40, per_call=1, names=None):
    """Every call of ``fn`` launches exactly ``per_call`` kernels on the
    card (of those whose name holds one of ``names``, if given), read from
    torch.profiler's kernel records: a profile that lost records is taken
    again after a pause of 0.2 s, up to ``attempts`` times (late in a long
    run the card's profiles have lost the same records of every call for
    ten profiles in a row, the last record inside the window). Returns the
    calls of ``fn`` it made and the counts of the profiles that fell
    short."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0
                and (names is None or any(w in e.key for w in names)))
        if n == per_call * iters:
            return 1 + iters * (len(seen) + 1), seen
        seen.append(n)
        time.sleep(0.2)
    raise AssertionError(f"{label}: {iters} calls made {seen} kernel "
                         f"launches in {attempts} profiles, not {per_call} "
                         f"a call")


def phase_int8_dx():
    """K9 against its plain version at the training projections' shapes,
    on its tensor-core kernel, a second call equal bit for bit, one launch a
    call, with its time, bound, the plain version's time, and cuBLAS ``(dy *
    scale) @ w^T`` with the weight widened to fp32 once (not the same
    function: it reads 4x the weight bytes); then the ragged shapes
    (checked, not timed), both outputs. Returns the main row."""
    import torch
    from repro_torch.core import flops as fl
    from repro_torch.kernels import int8_matmul as k4
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    main = None
    for k, n in K9_SHAPES:
        dy, q, sc = _k9_inputs(gen, K9_M, k, n)
        wf = q.float()
        for out_name, (rel_max, rtol) in K9_TOL.items():
            odt = getattr(torch, out_name)
            label = f"M={K9_M}, K={k}, N={n}, {out_name}"
            got, max_err, peak = _check_k9(dy, q, sc, odt, label)
            _one_launch(f"K9 {label}",
                        lambda: k4.int8_matmul_dx(dy, q, sc, odt), iters=2)
            kernel_ms = cuda_ms(lambda i: k4.int8_matmul_dx(dy, q, sc, odt),
                                6)
            plain_ms = cuda_ms(
                lambda i: ref.int8_matmul_dx_ref(dy, q, sc, odt), 3)
            library_ms = cuda_ms(lambda i: ((dy * sc) @ wf.T).to(odt), 6)
            ops, nbytes = fl.matmul_work(dy, q, k, got.element_size())
            bound_ms, bound_by = _bound(nbytes, ops / _peak_coded(dy))
            row = {"phase": "int8_matmul_dx", "kernel": "tensor_cores",
                   "m": K9_M, "k": k, "n": n,
                   "dy": "float32", "out": out_name, "max_abs_err": max_err,
                   "max_rel_err": max_err / max(peak, 1e-30),
                   "tol_rel_to_max": rel_max, "rtol": rtol, "ms": kernel_ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "library": "cuBLAS (dy * scale) @ w^T, w widened to fp32 "
                              "once: not the same function, it reads 4x "
                              "the weight bytes",
                   "bound_ms": bound_ms, "bound_by": bound_by}
            emit(row)
            if (k, n, out_name) == K9_MAIN:
                main = row
            del got
        del dy, q, sc, wf
    ragged = []
    for m, k, n in K9_RAGGED:
        dy, q, sc = _k9_inputs(gen, m, k, n)
        for out_name in K9_TOL:
            _, max_err, peak = _check_k9(dy, q, sc, getattr(torch, out_name),
                                         f"M={m}, K={k}, N={n}, {out_name}")
            ragged.append([m, k, n, out_name, max_err / max(peak, 1e-30)])
        del dy, q, sc
    emit({"phase": "int8_matmul_dx_ragged", "kernel": "tensor_cores",
          "cases_m_k_n_out_err_over_max": ragged})
    torch.cuda.empty_cache()
    return main


def phase_int8_train_grads():
    """``ops.int8_matmul_train`` (K4 with fp32 output, K9) against autograd
    through ``(x @ q) * scale`` in fp32, cast to x's dtype as the kernel
    route's output is (so both routes round the cotangent alike), at (M,
    K, N) = (4096, 4608, 18432),
    fp32 and bf16 x: dx within 1e-5 (fp32) or 2e-2 (bf16, one bf16
    rounding, tests/test_kernels_grad.py's bound) of its max, dscale within
    1e-4 of its max (recovered from the saved fp32 output, summed over
    4096 rows in another order)."""
    import torch
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    m, k, n = K9_M, 4608, 18432
    q = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                      dtype=torch.int8)
    sc = (torch.rand(n, generator=gen, device="cuda") + 0.5) * 1e-3
    ct = torch.randn((m, n), generator=gen, device="cuda")
    x32 = torch.randn((m, k), generator=gen, device="cuda")
    for x_name, dx_tol in (("float32", 1e-5), ("bfloat16", 2e-2)):
        x = x32.to(getattr(torch, x_name))
        grads = {}
        for route in ("kernels", "plain"):
            xl = x.detach().requires_grad_(True)
            sl = sc.detach().requires_grad_(True)
            with torch.enable_grad():
                y = (ops.int8_matmul_train(xl, q, sl) if route == "kernels"
                     else ((xl.float() @ q.float()) * sl).to(x.dtype))
                grads[route] = torch.autograd.grad(
                    (y.float() * ct).sum(), (xl, sl))
            del y
        (dx, ds), (wdx, wds) = grads["kernels"], grads["plain"]
        dx_err = _rel_err(dx, wdx)
        ds_err = _rel_err(ds, wds)
        row = {"phase": "int8_matmul_train_grads", "m": m, "k": k, "n": n,
               "x": x_name, "dx_dtype": str(dx.dtype).split(".")[-1],
               "dx_max_abs_err": dx_err[0], "dx_rel_to_max": dx_err[1],
               "dscale_max_abs_err": ds_err[0],
               "dscale_rel_to_max": ds_err[1]}
        emit(row)
        if not (dx_err[1] <= dx_tol and ds_err[1] <= 1e-4
                and dx.dtype == x.dtype and ds.dtype == torch.float32):
            raise AssertionError(f"int8_matmul_train gradients disagree "
                                 f"with autograd through the plain math: "
                                 f"{row}")
        del grads, dx, ds, wdx, wds
    del q, sc, ct, x32
    torch.cuda.empty_cache()


# K11 at the CNN workloads' FC shapes (K, N): AlexNet's fc0, fc1 and fc2
# and VGG-16's fc0, at M = 1 (batch-1 inference) and 64, x fp32 (the main
# path's mode) and bf16, the codes from ``ternarize`` of a normal weight;
# one binary case (``binarize``: no zero codes) per shape in the main mode;
# then the kernel bench's 256 x 2048 x 512. Tolerance, (of the plain
# version's max abs output, relative to each element): fp32 1e-5 of the max
# (K up to 25088 fp32 products summed in another order); bf16 also one bf16
# rounding of each element (2^-7 relative)
K11_FC = ((9216, 4096), (4096, 4096), (4096, 1000), (25088, 4096))
K11_CASES = (tuple((m, k, n, x, "ternary") for k, n in K11_FC
                   for m in (1, 64) for x in ("float32", "bfloat16"))
             + tuple((1, k, n, "float32", "binary") for k, n in K11_FC)
             + ((256, 2048, 512, "float32", "ternary"),
                (256, 2048, 512, "bfloat16", "ternary")))
K11_MAIN = (1, 9216, 4096, "float32", "ternary")
K11_TOL = {"float32": (1e-5, 0.0), "bfloat16": (1e-5, 2.0 ** -7)}
# (M, K, N) checked in fp32 and bf16 but not timed: every instantiation of
# the streaming kernel (M = 1, 2, 3-4, 5-8), the tensor-core kernel's
# element loads (K % 8 != 0: x not by TMA; N % 16 != 0: the codes in 8-,
# 4- or 1-byte loads), ragged tiles and split K (the last two), the smoke
# classifier and tests/test_kernels_ternary.py's ragged shape
K11_RAGGED = ((3, 192, 10), (2, 777, 33), (5, 512, 128), (8, 300, 50),
              (9, 301, 50), (100, 300, 50), (64, 7, 3), (1, 1, 1),
              (64, 777, 1000), (130, 2052, 300))


def _check_k11(x, q, sc, label):
    """K11 on (x, q, sc) against its plain version within K11_TOL, on the
    kernel that its rule names (``route``: M > 8 on the tensor cores, read
    from ``launches_by_kernel``), a second call equal bit for bit, or
    raise. Returns (the plain output's max abs, the max abs error)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ternary_matmul as k11
    before = dict(k11.ternary_matmul.launches_by_kernel)
    got = k11.ternary_matmul(x, q, sc)
    torch.cuda.synchronize()
    ran = {n: c - before[n] for n, c in
           k11.ternary_matmul.launches_by_kernel.items() if c != before[n]}
    if ran != {k11.route(x.shape[0]): 1}:
        raise AssertionError(f"ternary_matmul at {label}: one call "
                             f"launched {ran}")
    _same_bits(f"K11 {label}", (got,), (k11.ternary_matmul(x, q, sc),))
    want = ref.ternary_matmul_ref(x, q, sc)
    of_max, rtol = K11_TOL[str(x.dtype).split(".")[1]]
    want_max = float(want.float().abs().max())
    err = (got.float() - want.float()).abs()
    max_err = float(err.max())
    excess = err - (of_max * want_max + rtol * want.float().abs())
    if not (float(excess.max()) <= 0.0 and torch.isfinite(got).all()
            and got.dtype == x.dtype and got.shape == want.shape):
        worst = int(excess.argmax())
        raise AssertionError(
            f"ternary_matmul disagrees with its plain version at {label}: "
            f"max abs err {max_err} (max {want_max}, tolerance {of_max} of "
            f"it + {rtol} relative); worst element "
            f"{divmod(worst, q.shape[1])}: kernel "
            f"{float(got.flatten()[worst])}, plain "
            f"{float(want.flatten()[worst])}")
    return want_max, max_err


def phase_ternary_matmul():
    """K11 against its plain version at the CNN workloads' shapes, each call
    on the kernel its rule names (every M > 8 call on the tensor cores), a
    second call equal bit for bit, one launch a call, with its device time
    (``device_ms``; each timed call reads its own copy of the
    codes, K4_COLD_BYTES of copies at least) and its CUDA-event time, its
    bound, the plain version's device time and that of cuBLAS on the
    weight dequantized once to x's dtype (the reference example's route:
    not the same function, it reads 4x (fp32) or 2x (bf16) the weight
    bytes). Returns the main row (fp32 x, M = 1, AlexNet fc0)."""
    import torch
    from repro_torch.core import flops as fl
    from repro_torch.kernels import ref
    from repro_torch.kernels import ternary_matmul as k11
    from repro_torch.quant import ternary
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    main = None
    for case in K11_CASES:
        m, k, n, x_name, codes = case
        dt = getattr(torch, x_name)
        x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
        w = torch.randn((k, n), generator=gen, device="cuda")
        tw = (ternary.ternarize if codes == "ternary" else ternary.binarize)(w)
        del w
        q, sc = tw.q, tw.scale
        want_max, max_err = _check_k11(x, q, sc, f"{m}x{k}x{n} {x_name} "
                                                 f"{codes}")
        qs = [q] + [q.clone() for _ in range(
            max(3, int(K4_COLD_BYTES // q.numel())))]

        def kernel(i):
            return k11.ternary_matmul(x, qs[i % len(qs)], sc)

        _one_launch(f"K11 {m}x{k}x{n} {x_name}", lambda: kernel(0))
        kernel_ms = device_ms(kernel, 24)
        event_ms = cuda_ms(kernel, 24)
        plain_ms = device_ms(lambda i: ref.ternary_matmul_ref(
            x, qs[i % len(qs)], sc), 6)
        wd = [(c.float() * sc).to(dt) for c in qs[:max(
            2, int(K4_COLD_BYTES // (q.numel() * x.element_size())))]]
        library_ms = device_ms(lambda i: x @ wd[i % len(wd)], 24)
        del qs, wd
        ops, nbytes = fl.matmul_work(x, q, n, x.element_size())
        bound_ms, bound_by = _bound(nbytes, ops / _peak_coded(x))
        row = {"phase": "ternary_matmul", "kernel": k11.route(m),
               "m": m, "k": k, "n": n,
               "x": x_name, "codes": codes,
               "zero_code_share": float((q == 0).float().mean()),
               "max_abs_err": max_err, "plain_max": want_max,
               "err_over_max": max_err / want_max,
               "ms": kernel_ms, "event_ms": event_ms,
               "timing": "ms, plain_ms, library_ms: device time of the "
                         "call's kernels (torch.profiler); event_ms: CUDA "
                         "events around back-to-back calls, host launch "
                         "time included where it is the slower side",
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library": "cuBLAS x @ w, w dequantized once to x's dtype: "
                          "not the same function, it reads 4x (fp32) or "
                          "2x (bf16) the weight bytes",
               "bound_ms": bound_ms, "bound_by": bound_by}
        emit(row)
        if case == K11_MAIN:
            main = row
    ragged = []
    for m, k, n in K11_RAGGED:
        w = torch.randn((k, n), generator=gen, device="cuda")
        tw = ternary.ternarize(w)
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
            want_max, max_err = _check_k11(x, tw.q, tw.scale,
                                           f"{m}x{k}x{n} {dt}")
            ragged.append([m, k, n, str(dt), max_err / max(want_max, 1e-30)])
    emit({"phase": "ternary_matmul_ragged",
          "cases_m_k_n_x_err_over_max": ragged})
    return main


# K6-K8 at the training path's shapes: starcoder2-7b's heads at B = 2,
# S = 2048, causal, each (q dtype, window); the path's mode is fp32 with
# no window. Tolerance, max abs error over the max abs of the plain
# version's output: fp32 1e-4 (fp32 sums in another order over up to
# 2048 keys, or 2048 x 9 query rows for dK/dV: about 1e-6 expected);
# bf16 1e-2 (both round their fp32 results to bf16, 2^-8 relative, and
# may straddle a rounding boundary)
FLASH_B, FLASH_S = 2, 2048
FLASH_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
TRAIN_FLASH = ("flash_attention_fwd", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv")
MAIN_FLASH = ("float32", -1)
TRAIN_LAYERS = 8


def _flash_inputs(dtype):
    """q, k, v and an output cotangent at the training path's shapes."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    q = _randn(gen, (FLASH_B, FLASH_S, H, D), dtype)
    k = _randn(gen, (FLASH_B, FLASH_S, HKV, D), dtype)
    v = _randn(gen, (FLASH_B, FLASH_S, HKV, D), dtype)
    dout = _randn(gen, (FLASH_B, FLASH_S, H, D), dtype)
    return q, k, v, dout


def _flash_ops_s(q, exact, on_p):
    """Least seconds of a flash kernel's FLOPs (``flash_work``): ``exact``
    of products of two input-typed operands (s, dP) and ``on_p`` of
    products with fp32 P or dS. fp32 q: both at ``_peak`` (3xTF32; int8
    K/V too). bf16 q: ``exact`` (bf16 x bf16) at PEAK_BF16 and ``on_p``
    (fp32 P or dS, as the Pallas bodies compute them, against bf16 or
    int8 operands) at PEAK_BF16 / 3, three exact bf16 planes, as
    ``_peak_coded`` counts fp32 x against codes: K6 and K10 8 D a pair
    and head at PEAK_BF16, K7 10 D, K8 16 D."""
    import torch
    if q.dtype == torch.float32:
        return (exact + on_p) / _peak(q)
    return (exact + 3 * on_p) / PEAK_BF16


def _flash_bound(name, q, k, window, extra=()):
    """Least time of the causal flash kernel ``name`` at these inputs:
    its bytes (``flash_work``: each input read once, each output written
    once) over the HBM rate, or its FLOPs at ``_flash_ops_s``, the
    larger."""
    from repro_torch.core import flops as fl
    exact, on_p, nbytes = fl.flash_work(name, q, k, True, window, extra)
    return _bound(nbytes, _flash_ops_s(q, exact, on_p))


def _flash_bounds(q, k, window):
    """Least time of K6, K7 and K8 at these inputs (``_flash_bound``): 4,
    6 and 8 * D FLOPs per valid (query, key) pair and head (K6: s and P
    V; K7 recomputes s and dP and does dS K; K8 recomputes s and dP and
    does P^T dO and dS^T Q)."""
    return {name: _flash_bound(name, q, k, window) for name in TRAIN_FLASH}


# The device kernels one call of a flash forward (K6, K10) launches, by the
# stem of their names: fp32 q the split pre-pass and the 3xTF32 forward;
# bf16 q the bf16 forward alone, no pre-pass
FWD_KERNELS = {"float32": {"flash_fwd_split_kernel": 1,
                           "flash_fwd_tc_kernel": 1},
               "bfloat16": {"flash_fwd_bf16_kernel": 1}}


def _fwd_device_kernels(label, fn, q_name):
    """The device kernels that one call of ``fn`` (K6 or K10 with q in
    ``q_name``) launches, read from torch.profiler's kernel records
    (``_one_launch``): FWD_KERNELS[q_name], each as often as it says, and
    nothing else. Returns {stem: launches a call}."""
    want = FWD_KERNELS[q_name]
    _one_launch(label, fn, iters=4, per_call=sum(want.values()))
    for stem, n in want.items():
        _one_launch(f"{label}, {stem}", fn, iters=4, per_call=n,
                    names=(stem,))
    return dict(want)


def _rel_err(got, want):
    """(max abs error, that over the max abs of ``want``)."""
    got, want = got.detach().float(), want.detach().float()
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def phase_flash_kernels():
    """K6, K7 and K8 against their plain versions in fp32 and bf16, with
    windows -1 and 256, at the training path's shapes; the backward
    kernels and the plain backward get the kernel's own out and lse. A
    second call of K6, K7 and K8 on the same inputs must give the same
    bits. The library yardstick is ``F.scaled_dot_product_attention``
    (causal, K/V repeated to H heads inside the timed call; a boolean mask
    for the window) for K6, and its autograd backward for K7 + K8
    together. The kernels and the library calls are timed by device time
    (torch.profiler; their CUDA-event times beside). Calls only the
    kernels' public wrappers, so an older checkout's kernels can be timed
    through it (``benchmarks/flash_bwd_bench.py``). K6's rows give the
    device kernels each call launched (``_fwd_device_kernels``: bf16 q one
    launch). Returns the main-path rows by kernel and K6's bf16 row
    without a window."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    scale = D ** -0.5
    rep = H // HKV
    main, bf16 = {}, {}
    for q_name, tol in FLASH_TOL.items():
        q, k, v, dout = _flash_inputs(getattr(torch, q_name))
        for window in WINDOWS:
            kw = dict(scale=scale, causal=True, window=window)
            before = _flash_launch_counts()
            out, lse = fa.flash_attention_fwd(q, k, v, **kw)
            delta = (dout.float() * out.float()).sum(-1).transpose(
                1, 2).contiguous()
            dq = fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw)
            dk, dv = fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                                **kw)
            _flash_ran(before, f"{q_name}, window {window}", q.dtype, D)
            torch.cuda.synchronize()
            w_out, w_lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
            w_dq, w_dk, w_dv = ref.flash_attention_bwd_ref(q, k, v, out, lse,
                                                           dout, **kw)
            errs = {"out": _rel_err(out, w_out), "lse": _rel_err(lse, w_lse),
                    "dq": _rel_err(dq, w_dq), "dk": _rel_err(dk, w_dk),
                    "dv": _rel_err(dv, w_dv)}
            finite = all(bool(torch.isfinite(t).all())
                         for t in (out, lse, dq, dk, dv))
            dtypes_ok = (out.dtype, dq.dtype, dk.dtype, dv.dtype) == \
                (q.dtype,) * 4 and lse.dtype == torch.float32
            if not (finite and dtypes_ok
                    and all(r <= tol for _, r in errs.values())):
                raise AssertionError(
                    f"flash kernels disagree with their plain versions: "
                    f"{q_name}, window {window}: {errs} (tolerance {tol} of "
                    f"the max), finite {finite}, dtypes {dtypes_ok}")
            _same_bits(f"{q_name}, window {window}", (out, lse, dq, dk, dv),
                       fa.flash_attention_fwd(q, k, v, **kw)
                       + (fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta,
                                                    **kw),)
                       + fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                                    **kw))
            del w_out, w_lse, w_dq, w_dk, w_dv
            fwd_kernels = _fwd_device_kernels(
                f"K6, {q_name}, window {window}",
                lambda: fa.flash_attention_fwd(q, k, v, **kw), q_name)
            mask = None if window <= 0 else ref.flash_mask(
                FLASH_S, FLASH_S, causal=True, window=window, device="cuda")

            def library(qq, kk, vv):
                return F.scaled_dot_product_attention(
                    qq.transpose(1, 2),
                    kk.repeat_interleave(rep, dim=2).transpose(1, 2),
                    vv.repeat_interleave(rep, dim=2).transpose(1, 2),
                    attn_mask=mask, is_causal=mask is None, scale=scale)

            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            with torch.enable_grad():
                lib_out = library(*leaves)
            lib_dout = dout.transpose(1, 2)
            # the library's own results beside the kernels' (reported): an
            # independent check of the plain versions
            lib_grads = torch.autograd.grad(lib_out, leaves, lib_dout,
                                            retain_graph=True)
            lib_diff = {"out": _rel_err(out, lib_out.transpose(1, 2))[1],
                        **{n: _rel_err(g, w)[1] for n, g, w in zip(
                            ("dq", "dk", "dv"), (dq, dk, dv), lib_grads)}}
            del lib_grads
            times = {
                "flash_attention_fwd": (
                    device_ms(lambda i: fa.flash_attention_fwd(q, k, v, **kw),
                              10),
                    cuda_ms(lambda i: ref.flash_attention_fwd_ref(
                        q, k, v, **kw), 3),
                    device_ms(lambda i: library(q, k, v), 10)),
                "flash_attention_bwd_dq": (
                    device_ms(lambda i: fa.flash_attention_bwd_dq(
                        q, k, v, dout, lse, delta, **kw), 10), None, None),
                "flash_attention_bwd_dkv": (
                    device_ms(lambda i: fa.flash_attention_bwd_dkv(
                        q, k, v, dout, lse, delta, **kw), 10), None, None)}
            event_ms = {
                "flash_attention_fwd": cuda_ms(
                    lambda i: fa.flash_attention_fwd(q, k, v, **kw), 10),
                "library_fwd": cuda_ms(lambda i: library(q, k, v), 10),
                "flash_attention_bwd_dq": cuda_ms(
                    lambda i: fa.flash_attention_bwd_dq(
                        q, k, v, dout, lse, delta, **kw), 10),
                "flash_attention_bwd_dkv": cuda_ms(
                    lambda i: fa.flash_attention_bwd_dkv(
                        q, k, v, dout, lse, delta, **kw), 10)}
            # one plain backward and one library backward compute dq, dk
            # and dv together: each is both K7's and K8's yardstick
            plain_bwd = cuda_ms(lambda i: ref.flash_attention_bwd_ref(
                q, k, v, out, lse, dout, **kw), 3)

            def lib_backward(i):
                return torch.autograd.grad(lib_out, leaves, lib_dout,
                                           retain_graph=True)

            lib_bwd = device_ms(lib_backward, 10)
            event_ms["library_bwd"] = cuda_ms(lib_backward, 10)
            del lib_out, leaves
            bounds = _flash_bounds(q, k, window)
            err_of = {"flash_attention_fwd": ("out", "lse"),
                      "flash_attention_bwd_dq": ("dq",),
                      "flash_attention_bwd_dkv": ("dk", "dv")}
            for name, (ms, plain_ms, library_ms) in times.items():
                row = {"phase": "kernels", "kernel": name, "q": q_name,
                       "window": window, "B": FLASH_B, "S": FLASH_S,
                       "max_abs_err": max(errs[e][0] for e in err_of[name]),
                       "max_rel_err": max(errs[e][1] for e in err_of[name]),
                       "tol_rel_to_max": tol,
                       "library_rel_diff": max(lib_diff.get(e, 0.0)
                                               for e in err_of[name]),
                       "ms": ms,
                       "plain_ms": plain_ms if plain_ms is not None
                       else plain_bwd,
                       "library_ms": library_ms if library_ms is not None
                       else lib_bwd,
                       "bound_ms": bounds[name][0],
                       "bound_by": bounds[name][1]}
                # device time, CUDA events beside
                row["timing"] = "device"
                row["cuda_event_ms"] = event_ms[name]
                row["library_cuda_event_ms"] = event_ms[
                    "library_fwd" if name == "flash_attention_fwd"
                    else "library_bwd"]
                if name == "flash_attention_fwd":
                    row["device_kernels"] = fwd_kernels
                emit(row)
                if (q_name, window) == MAIN_FLASH:
                    main[name] = row
                if (q_name, window, name) == ("bfloat16", -1,
                                              "flash_attention_fwd"):
                    bf16[name] = row
            del out, lse, delta, dq, dk, dv
        del q, k, v, dout
        torch.cuda.empty_cache()
    return main, bf16


def _same_bits(label, first, second):
    """Two calls' outputs must be equal bit for bit (every sum of K1, K4,
    K6-K8 and K10 is taken in a fixed order)."""
    import torch
    torch.cuda.synchronize()
    if len(first) != len(second) or not all(
            torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"two calls on the same inputs differ: "
                             f"{label}")


def _flash_launch_counts():
    """K6's, K7's and K8's per-kernel launch counts now, to diff."""
    return {fn.__name__: dict(fn.launches_by_kernel)
            for fn in _train_flash_counters()}


def _flash_ran(before, label, dtype, d):
    """The kernels K6, K7 and K8 launched since ``before``
    (``_flash_launch_counts``) must be their route's at ``d`` and no
    other: the tensor cores, in every dtype and at every head dim. Returns
    {kernel: [kernels that ran]}."""
    from repro_torch.kernels import flash_attention as fa
    ran = {fn.__name__: [k for k, n in fn.launches_by_kernel.items()
                         if n != before[fn.__name__][k]]
           for fn in _train_flash_counters()}
    want = {fn.__name__: [fa.route(dtype, d)]
            for fn in _train_flash_counters()}
    if ran != want or any(w != ["tensor_cores"] for w in want.values()):
        raise AssertionError(f"flash kernels at {label} ran {ran}, not "
                             f"their route's {want} (the tensor cores)")
    return ran


# (Sq, Sk, H, Hkv, D, causal, window): ragged lengths across the tensor-core
# kernels' 64- and 32-row tiles (1, 63, 65, 1000; Sq < Sk), GQA groups of
# 1, 3 and 9, both head dims, a window of 300 and a non-causal case
FLASH_RAGGED = ((1, 1, 4, 4, 128, True, -1),
                (63, 63, 12, 4, 64, True, -1),
                (65, 65, 36, 4, 128, True, 300),
                (1000, 1000, 12, 4, 64, True, 300),
                (1000, 1000, 36, 4, 128, True, -1),
                (100, 128, 9, 1, 128, True, -1),
                (100, 128, 3, 3, 64, False, 300))


# An absolute floor beside FLASH_TOL's share of the max in the ragged cases:
# with one visible key (Sq = Sk = 1) dq and dk are zero by construction (the
# softmax of one score is 1), so the kernel's and the plain version's values
# are both rounding noise of dP - delta, of no size a share of their max
# can hold; the inputs are N(0, 1), so gradients are O(1) elsewhere
FLASH_ATOL = {"float32": 1e-5, "bfloat16": 1e-3}


def _lse_err(got, want):
    """(max abs error, that over the max abs of ``want``) of an lse over
    the rows that see a key; rows that see none (lse about -1e30 in the
    plain version) must be about -1e30 in ``got`` too."""
    live = want > -1e29
    if not bool((got[~live] <= -1e29).all()):
        raise AssertionError("flash forward: a row with no valid key has a "
                             "finite lse")
    if not bool(live.any()):
        return 0.0, 0.0
    return _rel_err(got[live], want[live])


def _check_flash_case(gen, b, sq, sk, h, hkv, d, causal, window, q_name):
    """K6 (out, lse), K7 and K8 on K6's out and lse, and K10 with K/V in
    q's dtype and as int8 codes with (B, Sk, Hkv) scales, against their
    plain versions on N(0, 1) inputs: each output within FLASH_TOL of its
    plain version's max plus FLASH_ATOL; a second call of each kernel must
    give the same bits. Returns the case's row; raises on a failure."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    tol = FLASH_TOL[q_name]
    dt = getattr(torch, q_name)
    q = _randn(gen, (b, sq, h, d), dt)
    k = _randn(gen, (b, sk, hkv, d), dt)
    v = _randn(gen, (b, sk, hkv, d), dt)
    dout = _randn(gen, (b, sq, h, d), dt)
    kw = dict(scale=d ** -0.5, causal=causal, window=window)
    label = (f"B {b}, Sq {sq}, Sk {sk}, H {h}, Hkv {hkv}, D {d}, causal "
             f"{causal}, window {window}, {q_name}")
    before = _flash_launch_counts()
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, **kw)
    _flash_ran(before, label, dt, d)
    _same_bits(label, (out, lse, dq, dk, dv),
               fa.flash_attention_fwd(q, k, v, **kw)
               + (fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw),)
               + fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, **kw))
    w_out, w_lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    got = {"out": out, "dq": dq, "dk": dk, "dv": dv}
    wants = dict(zip(("out", "dq", "dk", "dv"), (w_out,) + want))
    for kv_name in ("int8", q_name):
        kv_dt = getattr(torch, kv_name)
        kk = k if kv_dt == dt else _randn(gen, k.shape, kv_dt)
        vv = v if kv_dt == dt else _randn(gen, v.shape, kv_dt)
        kvs = dict(zip(("k_scale", "v_scale"), _scales(gen, kk, kv_dt)))
        name = f"k10 kv {kv_name}"
        got[name] = fa.flash_attention(q, kk, vv, **kw, **kvs)
        _same_bits(f"K10, kv {kv_name}, {label}", (got[name],),
                   (fa.flash_attention(q, kk, vv, **kw, **kvs),))
        wants[name] = ref.flash_attention_ref(q, kk, vv, **kw, **kvs)
    errs = {n: _rel_err(got[n], wants[n]) for n in got}
    errs["lse"] = _lse_err(lse, w_lse)
    finite = all(bool(torch.isfinite(t).all()) for t in got.values())
    w_max = {n: float(w.float().abs().max()) for n, w in wants.items()}
    w_max["lse"] = float(w_lse[w_lse > -1e29].abs().max()) \
        if bool((w_lse > -1e29).any()) else 0.0
    ok = all(err <= tol * w_max[n] + FLASH_ATOL[q_name]
             for n, (err, _) in errs.items())
    if not (finite and ok):
        raise AssertionError(f"flash kernels disagree with their plain "
                             f"versions: {label}: (abs, rel) {errs} "
                             f"(tolerance {tol} of the max + "
                             f"{FLASH_ATOL[q_name]}), finite {finite}")
    return {"case": label, "max_abs_err": {n: e[0] for n, e in errs.items()},
            "rel_err": {n: e[1] for n, e in errs.items()},
            "kernel": {"forward": fa.route(dt, d),
                       "backward": fa.route(dt, d)}}


def phase_flash_ragged():
    """K6, K7, K8 and K10 (checked, not timed) against their plain
    versions at the FLASH_RAGGED shapes, B = 2, fp32 and bf16
    (``_check_flash_case``)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    rows = [_check_flash_case(gen, 2, sq, sk, h, hkv, d, causal, window,
                              q_name)
            for sq, sk, h, hkv, d, causal, window in FLASH_RAGGED
            for q_name in FLASH_TOL]
    emit({"phase": "flash_ragged", "cases": rows})


# The smoke configs' head dims (8, 16, 24: the D = 64 kernels on tiles
# zero past D), checked at the training launcher's batch (B 8, S 64) with
# each smoke config's heads and at an odd length, windows -1 and 8; timed
# at the launcher's batch with the heads of SMALL_TIMED's config for each
# dim, the kernels line's d8 / d16 / d24 entries in fp32 (its mode)
SMALL_B, SMALL_S, SMALL_ODD = 8, 64, 67
SMALL_WINDOWS = (-1, 8)
SMALL_TIMED = {8: "kimi-k2-1t-a32b", 16: "starcoder2-7b", 24: "gemma3-27b"}


def _flash_heads(cfg):
    """(H, Hkv, D) of a smoke config whose attention takes the flash route
    in training (causal self-attention over arange positions), else None:
    an SSD-only config has no attention, and M-RoPE takes the masked
    ``sdpa``, as in the reference."""
    from repro_torch.models.encdec import EncDecConfig
    if isinstance(cfg, EncDecConfig):
        return cfg.n_heads, cfg.n_heads, cfg.head_dim
    specs = tuple(cfg.pattern) + tuple(cfg.tail)
    if cfg.pos_emb == "mrope" or all(sp.kind == "ssd" for sp in specs):
        return None
    return cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim


def _smoke_flash_heads():
    """{(H, Hkv, D): [arch]} over the registry's LM and encoder-decoder
    smoke configs whose training attention takes the flash route."""
    from repro_torch.configs import base as cfgbase
    heads = {}
    for arch in cfgbase.arch_ids():
        spec = cfgbase.get(arch)
        if spec.kind in ("lm", "encdec"):
            hd = _flash_heads(spec.make_smoke())
            if hd is not None:
                heads.setdefault(hd, []).append(arch)
    return heads


def _time_flash(b, s, h, hkv, d, q_name, phase="flash_small_dims"):
    """K6, K7, K8 and K10 (K/V in q's dtype) at (B, S, H, Hkv, D), causal,
    no window, N(0, 1) inputs: device ms (torch.profiler), the plain
    versions' ms (CUDA events), the library calls' device ms (causal SDPA
    with K/V repeated to H heads; its autograd backward for K7 and K8),
    the bounds and the max abs errors. Returns the rows by kernel."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    dt = getattr(torch, q_name)
    q = _randn(gen, (b, s, h, d), dt)
    k = _randn(gen, (b, s, hkv, d), dt)
    v = _randn(gen, (b, s, hkv, d), dt)
    dout = _randn(gen, (b, s, h, d), dt)
    kw = dict(scale=d ** -0.5, causal=True, window=-1)
    before = _flash_launch_counts()
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, **kw)
    _flash_ran(before, f"B {b}, S {s}, H {h}, Hkv {hkv}, D {d}, {q_name}",
               dt, d)
    o10 = fa.flash_attention(q, k, v, **kw)
    w_out, _ = ref.flash_attention_fwd_ref(q, k, v, **kw)
    w_dq, w_dk, w_dv = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                                   **kw)
    rep = h // hkv

    def library(qq, kk, vv):
        return F.scaled_dot_product_attention(
            qq.transpose(1, 2),
            kk.repeat_interleave(rep, dim=2).transpose(1, 2),
            vv.repeat_interleave(rep, dim=2).transpose(1, 2),
            is_causal=True, scale=kw["scale"])

    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    with torch.enable_grad():
        lib_out = library(*leaves)
    lib_dout = dout.transpose(1, 2)
    lib_fwd = device_ms(lambda i: library(q, k, v), 10)
    lib_bwd = device_ms(lambda i: torch.autograd.grad(
        lib_out, leaves, lib_dout, retain_graph=True), 10)
    plain_fwd = cuda_ms(lambda i: ref.flash_attention_fwd_ref(q, k, v, **kw),
                        3)
    plain_bwd = cuda_ms(lambda i: ref.flash_attention_bwd_ref(
        q, k, v, out, lse, dout, **kw), 3)
    bounds = _flash_bounds(q, k, -1)
    bounds["flash_attention"] = _flash_bound("flash_attention", q, k, -1)
    calls = {
        "flash_attention_fwd": (lambda i: fa.flash_attention_fwd(q, k, v,
                                                                 **kw),
                                _rel_err(out, w_out)[0], plain_fwd,
                                lib_fwd),
        "flash_attention_bwd_dq": (lambda i: fa.flash_attention_bwd_dq(
            q, k, v, dout, lse, delta, **kw), _rel_err(dq, w_dq)[0],
            plain_bwd, lib_bwd),
        "flash_attention_bwd_dkv": (lambda i: fa.flash_attention_bwd_dkv(
            q, k, v, dout, lse, delta, **kw),
            max(_rel_err(dk, w_dk)[0], _rel_err(dv, w_dv)[0]), plain_bwd,
            lib_bwd),
        "flash_attention": (lambda i: fa.flash_attention(q, k, v, **kw),
                            _rel_err(o10, w_out)[0], plain_fwd, lib_fwd)}
    units = -(-s // fa.DKV_KEYS) * b * hkv
    split = fa.dkv_split(units, rep, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    rows = {}
    for name, (fn, err, plain_ms, library_ms) in calls.items():
        rows[name] = {"phase": phase, "kernel": name,
                      "q": q_name, "B": b, "S": s, "H": h, "Hkv": hkv,
                      "D": d, "kernel_dim": fa.kernel_dim(d),
                      "ms": device_ms(fn, 10), "max_abs_err": err,
                      "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": bounds[name][0],
                      "bound_by": bounds[name][1],
                      "route": fa.route(dt, d),
                      "timing": "device"}
        if name == "flash_attention_bwd_dkv":
            rows[name].update(split=split,
                              blocks=units * (rep if split else 1))
        emit(rows[name])
    return rows


def phase_flash_small_dims():
    """K6, K7, K8 and K10 at head dims 8, 16 and 24, which run the D = 64
    kernels on tiles zero past D: checked (``_check_flash_case``, fp32 and
    bf16, windows -1 and 8) at the training launcher's batch (B 8, S 64)
    with the heads of every smoke config whose training attention takes
    the flash route, and at an odd length (S 67) with the first such
    config's heads of each dim; then timed at the launcher's batch
    (``_time_flash``, SMALL_TIMED's heads, fp32 and bf16). Returns the
    fp32 rows by dim and kernel."""
    import torch
    heads = _smoke_flash_heads()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    first = {}
    for hd in heads:
        first.setdefault(hd[2], hd)
    cases = [(SMALL_S, hd) for hd in heads] + \
        [(SMALL_ODD, first[d]) for d in sorted(SMALL_TIMED)]
    rows = [_check_flash_case(gen, SMALL_B, s, s, h, hkv, d, True, window,
                              q_name)
            for s, (h, hkv, d) in cases for q_name in FLASH_TOL
            for window in SMALL_WINDOWS]
    emit({"phase": "flash_small_dims", "cases": rows,
          "heads": {f"{h}/{hkv}/{d}": archs
                    for (h, hkv, d), archs in heads.items()}})
    timed = {}
    for d, arch in SMALL_TIMED.items():
        h, hkv = next(hd[:2] for hd, archs in heads.items()
                      if arch in archs)
        for q_name in FLASH_TOL:
            r = _time_flash(SMALL_B, SMALL_S, h, hkv, d, q_name)
            if q_name == "float32":
                timed[d] = r
        torch.cuda.empty_cache()
    return timed


# The head dims 112 (kimi-k2's and zamba2's: the D = 128 kernels on tiles
# zero past 112) and 168 (gemma3-27b's: kernels of 192 columns, the
# forward's own D = 168 kernel and the bf16 and fp32 backward's),
# (B, Sq, Sk, H, Hkv, D,
# causal, window): each config's heads at S 2048 (gemma3's without and
# with its window of 1024), then ragged lengths, a group of 9, a
# non-causal case and one key; checked in fp32 and bf16
# (``_check_flash_case``), then timed at WIDE_TIMED's heads
WIDE_FLASH = ((1, 2048, 2048, 32, 16, 168, True, -1),
              (1, 2048, 2048, 32, 16, 168, True, 1024),
              (1, 2048, 2048, 64, 8, 112, True, -1),
              (1, 2048, 2048, 32, 32, 112, True, -1),
              (2, 1000, 1000, 64, 8, 112, True, 300),
              (2, 1000, 1000, 32, 16, 168, True, 300),
              (2, 100, 128, 9, 1, 168, True, -1),
              (2, 65, 65, 3, 3, 112, False, 300),
              (2, 1, 1, 4, 4, 168, True, -1))
WIDE_TIMED = {112: (64, 8), 168: (32, 16)}


def phase_flash_wide_dims():
    """K6, K7, K8 and K10 at head dims 112 and 168: checked at the
    WIDE_FLASH cases in fp32 and bf16, each call on its route's kernel,
    then timed (``_time_flash``) at B 1, S 2048 with kimi-k2's heads (64 on
    8 of 112) and gemma3-27b's (32 on 16 of 168). Returns the fp32 rows by
    dim and kernel."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    rows = []
    for case in WIDE_FLASH:
        for q_name in FLASH_TOL:
            rows.append(_check_flash_case(gen, *case, q_name))
            torch.cuda.empty_cache()
    emit({"phase": "flash_wide_dims", "cases": rows})
    timed = {}
    for d, (h, hkv) in WIDE_TIMED.items():
        for q_name in FLASH_TOL:
            r = _time_flash(1, FLASH_S, h, hkv, d, q_name,
                            "flash_wide_dims")
            if q_name == "float32":
                timed[d] = r
        torch.cuda.empty_cache()
    return timed


# K10 at K6's shapes: (q dtype, K/V storage) with windows -1 and 256; the
# kernels line reports fp32 q and K/V without a window, K6's mode, and
# beside it bf16 q and K/V. Tolerance over the max of the plain version's
# output: K6's (FLASH_TOL)
K10_MODES = (("float32", "float32"), ("float32", "int8"),
             ("bfloat16", "bfloat16"), ("bfloat16", "int8"))
K10_MAIN = ("float32", "float32", -1)
K10_BF16 = ("bfloat16", "bfloat16", -1)


def phase_flash_infer():
    """K10 against its plain version at K6's shapes (B = 2, S = 2048, H =
    36, Hkv = 4, D = 128, causal) with q in fp32 and bf16, K/V in q's dtype
    or int8 with (B, S, Hkv) fp32 scales, windows -1 and 256; a second
    call must give the same bits. The library yardstick is causal
    ``F.scaled_dot_product_attention`` with K/V dequantized (int8) and
    repeated to H heads inside the timed call (a boolean mask for the
    window). K10 and the library call are timed by device time
    (torch.profiler; their CUDA-event times beside), and each mode's
    device kernels a call are read (``_fwd_device_kernels``: bf16 q one
    launch). Returns the main row and the bf16 row (K10_BF16)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    scale = D ** -0.5
    rep = H // HKV
    main = bf16 = None
    for q_name, kv_name in K10_MODES:
        q_dt, kv_dt = getattr(torch, q_name), getattr(torch, kv_name)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
        q = _randn(gen, (FLASH_B, FLASH_S, H, D), q_dt)
        k = _randn(gen, (FLASH_B, FLASH_S, HKV, D), kv_dt)
        v = _randn(gen, (FLASH_B, FLASH_S, HKV, D), kv_dt)
        scales = _scales(gen, k, kv_dt)
        kvs = dict(zip(("k_scale", "v_scale"), scales))
        tol = FLASH_TOL[q_name]
        for window in WINDOWS:
            kw = dict(scale=scale, causal=True, window=window, **kvs)
            got = fa.flash_attention(q, k, v, **kw)
            _same_bits(f"K10, q {q_name}, kv {kv_name}, window {window}",
                       (got,), (fa.flash_attention(q, k, v, **kw),))
            want = ref.flash_attention_ref(q, k, v, **kw)
            err, rel = _rel_err(got, want)
            if not (rel <= tol and got.dtype == q.dtype
                    and torch.isfinite(got).all()):
                raise AssertionError(
                    f"flash_attention disagrees with its plain version: q "
                    f"{q_name}, kv {kv_name}, window {window}: max abs err "
                    f"{err}, {rel} of the max (tolerance {tol})")
            del want
            mask = None if window <= 0 else ref.flash_mask(
                FLASH_S, FLASH_S, causal=True, window=window, device="cuda")

            def library():
                kk, vv = k, v
                if scales:
                    kk = (k.float() * scales[0][..., None]).to(q.dtype)
                    vv = (v.float() * scales[1][..., None]).to(q.dtype)
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2),
                    kk.repeat_interleave(rep, dim=2).transpose(1, 2),
                    vv.repeat_interleave(rep, dim=2).transpose(1, 2),
                    attn_mask=mask, is_causal=mask is None, scale=scale)

            lib_rel = _rel_err(got, library().transpose(1, 2))[1]
            kernels = _fwd_device_kernels(
                f"K10, q {q_name}, kv {kv_name}, window {window}",
                lambda: fa.flash_attention(q, k, v, **kw), q_name)
            ms = device_ms(lambda i: fa.flash_attention(q, k, v, **kw), 10)
            event_ms = cuda_ms(lambda i: fa.flash_attention(q, k, v, **kw),
                               10)
            plain_ms = cuda_ms(lambda i: ref.flash_attention_ref(q, k, v,
                                                                 **kw), 3)
            library_ms = device_ms(lambda i: library(), 10)
            library_event_ms = cuda_ms(lambda i: library(), 10)
            bound_ms, bound_by = _flash_bound("flash_attention", q, k,
                                              window, scales)
            row = {"phase": "kernels", "kernel": "flash_attention",
                   "q": q_name, "kv": kv_name, "window": window,
                   "B": FLASH_B, "S": FLASH_S, "max_abs_err": err,
                   "max_rel_err": rel, "tol_rel_to_max": tol,
                   "library_rel_diff": lib_rel, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "timing": "device", "cuda_event_ms": event_ms,
                   "library_cuda_event_ms": library_event_ms,
                   "device_kernels": kernels}
            emit(row)
            if (q_name, kv_name, window) == K10_MAIN:
                main = row
            if (q_name, kv_name, window) == K10_BF16:
                bf16 = row
            del got
        del q, k, v, scales, kvs
        torch.cuda.empty_cache()
    return main, bf16


def _train_flash_counters():
    from repro_torch.kernels import flash_attention as fa
    return (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
            fa.flash_attention_bwd_dkv)


def _reset_flash_kernels():
    """K6's, K7's and K8's per-kernel counters to 0 (beside
    ``launches``)."""
    for fn in _train_flash_counters():
        for key in fn.launches_by_kernel:
            fn.launches_by_kernel[key] = 0


def _flash_on_route(phase, head_dim=128, dtype="float32"):
    """K6's, K7's and K8's per-kernel counts since
    ``_reset_flash_kernels``: every launch of the training attention in
    ``dtype`` on the kernel ``route`` names at ``head_dim``: the tensor
    cores at every head dim."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    by_kernel = {fn.__name__: dict(fn.launches_by_kernel)
                 for fn in _train_flash_counters()}
    for fn in _train_flash_counters():
        want = fa.route(getattr(torch, dtype), head_dim)
        if fn.launches_by_kernel.get(want) != fn.launches:
            raise AssertionError(f"{phase}: the {dtype} flash attention "
                                 f"ran off its route's {want} kernels at "
                                 f"head_dim {head_dim}: {by_kernel}")
    return by_kernel


def _starcoder2(layers):
    """starcoder2-7b at full width, cut to ``layers`` layers."""
    from repro_torch.configs import starcoder2_7b
    return dataclasses.replace(starcoder2_7b.make_config(), repeats=layers)


# the training parity's tolerances by params dtype: (the loss's relative
# difference, each leaf's max abs gradient difference over that leaf's max
# abs gradient). fp32: the two routes differ only in the order of the
# attention's fp32 sums (about 1e-6 relative), carried through two layers'
# matmuls and the loss. bf16: tests/test_torch_flash.py's bf16 bound (the
# routes round the attention's bf16 output, and the matmuls after it, at
# other places)
TRAIN_PARITY_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-2, 6e-2)}


def phase_train_parity(dtype="float32"):
    """Params in ``dtype`` (fp32 or bf16), full width, 2 layers, B = 2, S
    = 1024, random weights from the seed: the gradients of ``loss_fn``
    through K6-K8 (``positions=None``) against the same call with explicit
    arange positions (masked ``sdpa`` on the card), within
    TRAIN_PARITY_TOL; every flash launch on its route's kernels. Returns
    the flash route's launches."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as tf_lib
    from repro_torch.models.common import flatten
    cfg = _starcoder2(2)
    params = tf_lib.init_lm(cfg, seed=SEED, dtype=getattr(torch, dtype),
                            device="cuda")
    leaves, _ = flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    rng = np.random.default_rng(SEED + 8)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 1025))).cuda()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    pos = torch.arange(1024, device="cuda").expand(2, 1024)
    counters = _counters()
    results = {}
    for route, extra in (("flash", {}), ("sdpa", {"positions": pos})):
        for fn in counters.values():
            fn.launches = 0
        _reset_flash_kernels()
        loss, _ = tf_lib.loss_fn(params, cfg, {**batch, **extra})
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        results[route] = (loss.detach().float(), grads,
                          {n: fn.launches for n, fn in counters.items()})
        if route == "flash":
            by_kernel = _flash_on_route(f"train parity ({dtype})",
                                        cfg.resolved_head_dim, dtype)
    (l_f, g_f, launches), (l_s, g_s, sdpa_launches) = (results["flash"],
                                                       results["sdpa"])
    loss_rel = float((l_f - l_s).abs() / l_s.abs())
    leaf_rel = max(float((a.float() - b.float()).abs().max()
                         / b.float().abs().max().clamp_min(1e-30))
                   for a, b in zip(g_f, g_s))
    want = {n: (2 if n in TRAIN_FLASH else 0) for n in counters}
    finite = bool(torch.isfinite(l_f)) and all(
        bool(torch.isfinite(g).all()) for g in g_f)
    loss_tol, leaf_tol = TRAIN_PARITY_TOL[dtype]
    row = {"phase": "train_parity", "dtype": dtype, "layers": 2,
           "batch": 2, "seq": 1024,
           "loss_flash": float(l_f), "loss_sdpa": float(l_s),
           "loss_rel_diff": loss_rel, "max_leaf_rel_diff": leaf_rel,
           "tolerance": {"loss_rel": loss_tol, "leaf_rel": leaf_tol},
           "leaves": len(leaves), "launches": launches,
           "flash_launches_by_kernel": by_kernel,
           "sdpa_launches": sdpa_launches}
    emit(row)
    if not (finite and loss_rel <= loss_tol and leaf_rel <= leaf_tol):
        raise AssertionError(f"train parity: flash route against sdpa: {row}")
    if launches != want or any(sdpa_launches.values()):
        raise AssertionError(f"train parity launches: flash {launches} != "
                             f"{want}, sdpa {sdpa_launches}")
    _add_flash_dims(launches, cfg.resolved_head_dim)
    return launches


def _profile_tick(eng, k, top=10):
    """``eng.run(k)`` (a TrainEngine tick, or k Trainer steps) under
    torch.profiler, after the measured run: device time by kernel (ms per
    step, largest first), the flash kernels' share of it (and the
    forward's, K6), the device's busy share of the tick's wall time and
    the kernel launches per step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        eng.run(k)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    kernels = sorted(((e.key[:80], e.self_device_time_total / 1e3 / k)
                      for e in events), key=lambda kv: -kv[1])
    busy = sum(ms for _, ms in kernels)
    flash = sum(ms for name, ms in kernels if "flash_" in name)
    flash_fwd = sum(ms for name, ms in kernels if "flash_fwd" in name)
    gemm = sum(ms for name, ms in kernels if "gemm" in name.lower())
    return {"steps": k, "wall_ms_per_step": wall_ms / k,
            "device_busy_ms_per_step": busy,
            "device_busy_share": busy * k / wall_ms,
            "gemm_ms_per_step": gemm, "flash_kernels_ms_per_step": flash,
            "flash_fwd_ms_per_step": flash_fwd,
            "launches_per_step": sum(e.count for e in events) / k,
            "top_kernels_ms_per_step": dict(kernels[:top])}


def phase_train(dtype="float32"):
    """The fused TrainEngine on starcoder2-7b at full width and 8 layers,
    synthetic tokens, global batch 2 x 2048, two ticks of two steps,
    billed to h100_sxm. fp32: fp32 params and AdamW state, a warmup-cosine
    lr. bf16: bf16 params and AdamW as the reference's fleet cells train
    (``repro/launch/cells.py::_adamw_for``: bf16 moments, no fp32 master,
    grad_clip 1.0, lr 3e-4). Every counter is set to 0 just before the run
    and read just after: K6, K7 and K8 each launch steps x layers times,
    every launch on its route's kernels (bf16: the tensor cores); one
    readback per tick; every loss and grad norm finite. Then one profiled
    tick: K6-K8's device ms a step, and K6's apart. Returns the
    launches."""
    import numpy as np
    import torch
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.models import transformer as tf_lib
    from repro_torch.models.common import flatten
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train import TrainEngine, TrainEngineConfig
    cfg = _starcoder2(TRAIN_LAYERS)
    steps, k = 4, 2
    params = tf_lib.init_lm(cfg, seed=SEED, dtype=getattr(torch, dtype),
                            device="cuda")
    opt_cfg = (AdamWConfig(lr=warmup_cosine(3e-4, 1, steps))
               if dtype == "float32" else
               AdamWConfig(lr=3e-4, state_dtype="bf16", use_master=False,
                           grad_clip=1.0))
    pipeline = make_pipeline(DataConfig(vocab=cfg.vocab, seq_len=FLASH_S,
                                        global_batch=FLASH_B, seed=SEED,
                                        source="synthetic"))
    acct = _accountant()
    eng = TrainEngine.for_lm(
        params, cfg, opt_cfg=opt_cfg, pipeline=pipeline,
        engine_cfg=TrainEngineConfig(steps_per_tick=k), accountant=acct)
    n_params = sum(p.numel() for p in flatten(params)[0])
    torch.cuda.synchronize()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    _reset_flash_kernels()
    eng.run(steps)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    by_kernel = _flash_on_route(f"train ({dtype})", cfg.resolved_head_dim,
                                dtype)
    want = {n: (steps * TRAIN_LAYERS if n in TRAIN_FLASH else 0)
            for n in counters}
    log = np.concatenate(eng.step_log)
    s = eng.summary()
    cost = eng.cost
    walls = [m.wall_s for m in eng.metrics_log]
    train = acct.report()["train"]
    peak = PEAK_FP32 if dtype == "float32" else PEAK_BF16
    row = {"phase": "train", "dtype": dtype, "layers": TRAIN_LAYERS,
           "d_model": cfg.d_model, "params": n_params, "batch": FLASH_B,
           "seq": FLASH_S, "steps": steps, "steps_per_tick": k,
           "optimizer": {"state_dtype": opt_cfg.state_dtype,
                         "use_master": opt_cfg.use_master,
                         "grad_clip": opt_cfg.grad_clip},
           "ticks": s["ticks"], "host_readbacks": eng.host_readbacks,
           "losses": log[:, 0].tolist(), "grad_norms": log[:, 1].tolist(),
           "lrs": log[:, 2].tolist(), "tick_wall_s": walls,
           "s_per_step": s["s_per_step"],
           # the first tick holds the first step (its allocations and
           # first calls), apart from the last
           "s_per_step_first_tick": walls[0] / k,
           "s_per_step_last_tick": walls[-1] / k,
           "tokens_per_s": s["tokens"] / s["wall_s"],
           "resident_gb_before_run": resident_gb,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "model_flops_per_step": cost.fwd_flops + cost.bwd_flops,
           "model_flops_per_s_last_tick": (cost.fwd_flops + cost.bwd_flops)
           * k / walls[-1],
           f"{'fp32' if dtype == 'float32' else 'bf16'}_peak_share_last_tick":
           (cost.fwd_flops + cost.bwd_flops) * k / walls[-1] / peak,
           "launches": launches, "flash_launches_by_kernel": by_kernel,
           "train": {key: train[key] for key in (
               "steps", "bwd_fwd_ratio", "fwd_j", "bwd_j", "opt_j",
               "total_j", "j_per_step", "j_per_sample")}}
    # after the measured run and its counts
    row["profile"] = _profile_tick(eng, k)
    emit(row)
    if not np.isfinite(log[:, :2]).all():
        raise AssertionError(f"train ({dtype}): a loss or grad norm is not "
                             f"finite: {log.tolist()}")
    if row["host_readbacks"] != row["ticks"] or row["ticks"] != steps // k:
        raise AssertionError(f"train ({dtype}): {row['host_readbacks']} "
                             f"readbacks for {row['ticks']} ticks")
    if launches != want:
        raise AssertionError(f"train ({dtype}): launches {launches} != "
                             f"{want}")
    _add_flash_dims(launches, cfg.resolved_head_dim)
    return launches


# the Trainer at the full size of examples/train_e2e.py's model_100m: fp32,
# batch 8 x 128 tokens, N steps per leg of the resume check
TRAINER_N = 10
TRAINER_BATCH, TRAINER_SEQ = 8, 128


def _trainer(cfg, seed, ckpt_dir=None):
    """A Trainer on ``cfg`` with fp32 random weights from ``seed``, billed
    to h100_sxm, checkpointing (keep 2, no periodic saves) into
    ``ckpt_dir``. Synthetic tokens: the Markov source's vocab x vocab
    table would take 17 GB of host memory and about a minute to draw at
    vocab 32768, and the stream's content does not change the work."""
    import torch
    from repro_torch.checkpoint import CheckpointConfig
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.models import transformer as tf_lib
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train import TrainConfig, Trainer
    steps = 2 * TRAINER_N
    params = tf_lib.init_lm(cfg, seed=seed, dtype=torch.float32,
                            device="cuda")
    return Trainer(
        loss_fn=lambda p, b: tf_lib.loss_fn(p, cfg, b), params=params,
        opt_cfg=AdamWConfig(lr=warmup_cosine(3e-3, steps // 10, steps)),
        train_cfg=TrainConfig(num_steps=steps, log_every=TRAINER_N,
                              checkpoint_every=10 ** 9),
        pipeline=make_pipeline(DataConfig(
            vocab=cfg.vocab, seq_len=TRAINER_SEQ,
            global_batch=TRAINER_BATCH, seed=SEED, source="synthetic")),
        ckpt_cfg=(CheckpointConfig(directory=str(ckpt_dir), keep_last=2)
                  if ckpt_dir else None),
        accountant=_accountant())


def _tree_diff(got, want):
    """(every leaf equal bit for bit, max abs difference, max of that over
    the leaf's max abs) over two trees of tensors of one structure."""
    from repro_torch.models.common import flatten
    same, diff, rel = True, 0.0, 0.0
    for a, b in zip(flatten(got)[0], flatten(want)[0]):
        a, b = a.detach(), b.detach()
        same &= bool(_equal(a, b))
        d = float((a.double() - b.double()).abs().max())
        diff = max(diff, d)
        rel = max(rel, d / max(float(b.double().abs().max()), 1e-30))
    return same, diff, rel


def _equal(a, b):
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def _dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def phase_trainer():
    """The checkpointing Trainer on examples/train_e2e.py's model_100m at
    full size (12 layers, d_model 768, 12/4 heads of 64, vocab 32768, five
    256-token-window layers per global one), fp32, batch 8 x 128: (a) 2N
    steps straight; (b) N steps, ``save(wait=True)``, then a fresh Trainer
    from another seed ``maybe_restore``s and runs N more steps. (b)'s
    params and optimizer state must equal (a)'s: bit for bit, else each
    leaf within 1e-6 of its max. Then a preempted run saves synchronously
    at its step, and a flipped byte in arrays.npz makes restore raise.
    Every counter is set to 0 just before (a) and read just after: K6, K7
    and K8 each launch 2N x 12 times. Returns (a)'s launches."""
    import shutil
    import tempfile
    import torch
    from repro_torch.examples.train_e2e import model_100m
    from repro_torch.models.common import flatten
    cfg = model_100m()
    n = TRAINER_N
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_",
                                 dir=ROOT / "build"))
    try:
        tr_a = _trainer(cfg, SEED)
        n_params = sum(p.numel() for p in flatten(tr_a.params)[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters = _counters()
        for fn in counters.values():
            fn.launches = 0
        _reset_flash_kernels()
        t0 = time.monotonic()
        tr_a.run(2 * n)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        by_kernel = _flash_on_route("trainer")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = {name: (2 * n * cfg.n_layers if name in TRAIN_FLASH else 0)
                for name in counters}
        losses = [e["loss"] for e in tr_a.metrics_log]

        tr_b = _trainer(cfg, SEED, root / "resume")
        tr_b.run(n)
        t0 = time.monotonic()
        tr_b.save(wait=True)
        save_s = time.monotonic() - t0
        save_bytes = _dir_bytes(root / "resume" / f"ckpt_{n:08d}")
        del tr_b
        tr_c = _trainer(cfg, SEED + 1, root / "resume")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        restored = tr_c.maybe_restore()
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
        step_after_restore = tr_c.step_num
        tr_c.run(n)
        same_p, diff_p, rel_p = _tree_diff(tr_c.params, tr_a.params)
        same_o, diff_o, rel_o = _tree_diff(tr_c.opt_state, tr_a.opt_state)
        # after the measured run, its counts and the comparison
        profile = _profile_tick(tr_a, 2)
        del tr_a

        # preemption after the third step: a synchronous save at that step
        orig = tr_c._step_fn
        calls = []

        def step_then_preempt(*args):
            out = orig(*args)
            calls.append(1)
            if len(calls) == 3:
                tr_c._preempted = True
            return out

        tr_c._step_fn = step_then_preempt
        tr_c.run(2 * n)
        preempt_step = tr_c.step_num
        preempt_saved = tr_c.ckpt.latest_step()
        # a flipped byte in the latest arrays.npz, inside its first array
        # (the first one restore reads, so it stops there)
        npz = root / "resume" / f"ckpt_{preempt_saved:08d}" / "arrays.npz"
        with open(npz, "r+b") as f:
            f.seek(4096)
            b = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([b[0] ^ 0xFF]))
        try:
            tr_c.ckpt.restore(target={"params": tr_c.params,
                                      "opt": tr_c.opt_state})
            refused = None
        except Exception as e:              # any refusal counts; reported
            refused = f"{type(e).__name__}: {str(e)[:120]}"
        del tr_c
        row = {"phase": "trainer", "model": cfg.name,
               "layers": cfg.n_layers, "d_model": cfg.d_model,
               "params": n_params, "batch": TRAINER_BATCH,
               "seq": TRAINER_SEQ, "steps": 2 * n,
               "s_per_step": wall / (2 * n),
               "tokens_per_s": 2 * n * TRAINER_BATCH * TRAINER_SEQ / wall,
               "peak_mem_gb": peak_gb, "losses": losses,
               "resume": {"restored": restored,
                          "step_after_restore": step_after_restore,
                          "params_identical": same_p,
                          "opt_identical": same_o,
                          "params_max_abs_diff": diff_p,
                          "opt_max_abs_diff": diff_o,
                          "max_leaf_rel_diff": max(rel_p, rel_o)},
               "save_s": save_s, "save_bytes": save_bytes,
               "restore_s": restore_s,
               "preempt_step": preempt_step,
               "preempt_saved_step": preempt_saved,
               "corrupt_restore_refused": refused, "launches": launches,
               "flash_launches_by_kernel": by_kernel,
               "profile": profile}
        emit(row)
        if not (restored and step_after_restore == n
                and (same_p and same_o or max(rel_p, rel_o) <= 1e-6)):
            raise AssertionError(f"trainer: the resumed run differs from "
                                 f"the straight one: {row['resume']}")
        if not (preempt_step == 2 * n + 3 and preempt_saved == preempt_step):
            raise AssertionError(f"trainer: preempted at step "
                                 f"{preempt_step}, saved {preempt_saved}")
        if refused is None:
            raise AssertionError("trainer: a corrupt checkpoint restored")
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"trainer: losses {losses}")
        if launches != want:
            raise AssertionError(f"trainer: launches {launches} != {want}")
        _add_flash_dims(launches, cfg.resolved_head_dim)
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_train_bench():
    """The port's train bench (``repro_torch.benchmarks.train_bench``) into
    build/bench/: both arms, the update parity and the kernel-grad parity,
    whose int8 case launches K4 (fp32 output) and K9 once each. Counters
    set to 0 just before and read just after. Returns the launches."""
    from repro_torch.benchmarks import train_bench
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    before = _routes()
    res = train_bench.bench(out=ROOT / "build" / "bench"
                            / "BENCH_torch_train.json", device="cuda")
    launches = {name: fn.launches for name, fn in counters.items()}
    _add_routes(before)
    g = res["grad_parity_vs_ref"]
    row = {"phase": "train_bench",
           "loop_s_per_step": res["reference"]["s_per_step"],
           "fused_s_per_step": res["fused"]["s_per_step"],
           "fused_speedup_s_per_step": res["speedup_s_per_step"],
           "update_parity_max_abs_diff": res["update_parity_max_abs_diff"],
           "grad_parity_vs_ref": g, "launches": launches}
    emit(row)
    # fp32 gradients through the kernels against autograd through the
    # plain math at tiny shapes: 1e-4 absolute for dq, dk, dv and dx
    # (values O(1)-O(10)), 1e-5 of its max for dscale (values O(1e3))
    if not (max(g.values()) <= 1e-4
            and g["int8_matmul_dscale_rel_err"] <= 1e-5
            and res["update_parity_max_abs_diff"] <= 1e-6):
        raise AssertionError(f"train bench parity: {row}")
    if launches["int8_matmul_dx"] != 1 or launches["int8_matmul"] != 1 \
            or not all(launches[n] for n in TRAIN_FLASH):
        raise AssertionError(f"train bench launches: {launches}")
    _add_flash_dims(launches, train_bench.HEAD_DIM)
    return launches


def phase_kernel_bench():
    """The port's kernel bench (``repro_torch.benchmarks.kernel_bench``):
    K11 and K10 against their plain versions at the reference bench's
    shapes, timed. Counters set to 0 just before and read just after.
    Returns the launches."""
    from repro_torch.benchmarks import kernel_bench
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    before = _routes()
    rows = kernel_bench.run("cuda")
    launches = {name: fn.launches for name, fn in counters.items()}
    _add_routes(before)
    emit({"phase": "kernel_bench", "rows": [list(r) for r in rows],
          "launches": launches})
    derived = {r[0]: dict(kv.split("=") for kv in r[2].split(";"))
               for r in rows}
    t_err = derived["kernel/ternary_matmul_vs_oracle"]
    f_err = float(derived["kernel/flash_attention_vs_oracle"]["max_err"])
    # K11 fp32 at K = 2048: 1e-5 of the plain version's max (as phase 4c)
    bench = ("flash_attention", "ternary_matmul")
    if f_err > 1e-5 \
            or float(t_err["max_err"]) > 1e-5 * float(t_err["ref_max"]) \
            or not all(launches[n] > 0 for n in bench) \
            or sum(launches.values()) != sum(launches[n] for n in bench):
        raise AssertionError(f"kernel bench: max errs {f_err}, {t_err}, "
                             f"launches {launches}")
    # the bench's flash attention runs at head dim 64 (kernel_bench.run)
    _add_flash_dims(launches, 64)
    return launches


# the paper's CNN workloads at full size (224 x 224 x 3 images, 1000
# classes), fp32, random weights from SEED and synthetic normal images:
# ternary inference (the FC layers' codes through K11) at these batches,
# and CNN_TRAIN_STEPS fp32 training steps at CNN_TRAIN_BATCH. The K11 route
# must agree with the dequantized forward (cuBLAS on q * scale, the
# reference example's route) within CNN_TOL of its max |logit|: the two
# round (x . q) * s and x . (q * s) apart, over three layers
CNN_BATCHES = (1, 64)
# K11's kernels by name (the streaming kernel at M <= 8, the tensor-core
# kernel above), as torch.profiler lists them
K11_KERNELS = ("ternary_gemv_kernel", "coded_gemm_kernel")
CNN_TRAIN_BATCH = 32
CNN_TRAIN_STEPS = 3
CNN_TOL = 1e-4


def _profile_device(fn, k, top=8):
    """``fn()`` k times under torch.profiler after the measured run:
    device ms per call by kernel (largest first), the K11 kernels',
    convolutions' and GEMMs' ms per call, and the device's busy share of
    the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(k):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    kernels = sorted(((e.key[:80], e.self_device_time_total / 1e3 / k)
                      for e in events), key=lambda kv: -kv[1])
    busy = sum(ms for _, ms in kernels)

    def share(*words):
        return sum(ms for name, ms in kernels
                   if any(w in name.lower() for w in words))

    k11 = share(*K11_KERNELS)
    return {"calls": k, "wall_ms_per_call": wall_ms / k,
            "device_busy_ms_per_call": busy,
            "device_busy_share": busy * k / wall_ms,
            "k11_ms_per_call": k11, "k11_share_of_device": k11 / busy,
            "conv_ms_per_call": share("conv", "fprop", "dgrad", "wgrad"),
            "gemm_ms_per_call": share("gemm", "gemv") - k11,
            "launches_per_call": sum(e.count for e in events) / k,
            "top_kernels_ms_per_call": dict(kernels[:top])}


def phase_cnn(cfg):
    """The paper's CNN ``cfg`` (AlexNet or VGG-16) at full size. Inference:
    the FC weights ternarized as the reference example does
    (``quantize_tree`` with its FC predicate); at each batch of
    CNN_BATCHES the K11 route (``forward(matmul_fn=ternary_mm)``) against
    the dequantized forward: logits within CNN_TOL of its max |logit|, the
    same top-1 unless its top two are closer than that; ms per forward
    (CUDA events) of both routes, images/s, K11's share of the device time
    (one profiled forward), peak memory, and top-1 agreement with the fp32
    forward (reported, not asserted). Training: CNN_TRAIN_STEPS steps of
    ``loss_fn`` (dropout on, from a seeded generator), autograd and AdamW
    at CNN_TRAIN_BATCH, every loss and grad norm finite; s/step without the
    first step, images/s, model FLOP/s over the fp32 peak, peak memory,
    then one profiled step. Every counter is set to 0 just before the
    inference runs and read after the training: K11 launches 3 times a
    K11-route forward, one kernel launch each (torch.profiler's records),
    on the streaming kernel at batch 1 and the tensor-core kernel at 64
    (``launches_by_kernel``); nothing else launches. Returns the
    launches."""
    import torch
    from repro_torch.examples.edge_cnn_repro import fc_predicate, ternary_mm
    from repro_torch.kernels import ternary_matmul as k11_lib
    from repro_torch.models import cnn
    from repro_torch.models.common import flatten
    from repro_torch.optim.adamw import (AdamWConfig, apply_updates,
                                         init_opt_state)
    from repro_torch.quant import ternary
    params = cnn.init_cnn(cfg, seed=SEED, device="cuda")
    leaves, rebuild = flatten(params)
    qparams = ternary.quantize_tree(params, predicate=fc_predicate)
    deq = ternary.dequantize_tree(qparams)
    n_fc = len(cfg.fcs) + 1
    code_bytes = sum(qparams[f"fc{i}"]["w"].q.numel() for i in range(n_fc))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    shape = (cfg.image_size, cfg.image_size, cfg.in_channels)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    k11 = counters["ternary_matmul"]
    before = _routes()
    forwards = 0
    for batch in CNN_BATCHES:
        routes_before = dict(k11.launches_by_kernel)
        imgs = torch.randn((batch,) + shape, generator=gen, device="cuda")
        iters = 20 if batch == 1 else 5
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            def k11_route(i=0):
                return cnn.forward(qparams, cfg, imgs, matmul_fn=ternary_mm)

            got = k11_route()
            want = cnn.forward(deq, cfg, imgs)
            fp32 = cnn.forward(params, cfg, imgs)
            ms = cuda_ms(k11_route, iters)
            deq_ms = cuda_ms(lambda i: cnn.forward(deq, cfg, imgs), iters)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            prof = _profile_device(k11_route, 2)
            checked, short = _one_launch(
                f"cnn {cfg.name} batch {batch}: K11", k11_route, iters=2,
                per_call=n_fc, names=K11_KERNELS)
        batch_forwards = 1 + (iters + 1) + 2 + checked
        forwards += batch_forwards
        routes = {r: c - routes_before[r]
                  for r, c in k11.launches_by_kernel.items()
                  if c != routes_before[r]}
        want_max = float(want.abs().max())
        diff = float((got - want).abs().max())
        top2 = want.topk(2, dim=-1).values
        close = (top2[:, 0] - top2[:, 1]) <= CNN_TOL * want_max
        same = got.argmax(-1) == want.argmax(-1)
        row = {"phase": "cnn_infer", "model": cfg.name, "batch": batch,
               "image": list(shape), "classes": cfg.num_classes,
               "params": sum(p.numel() for p in leaves),
               "ternary_code_bytes": code_bytes,
               "max_abs_diff_vs_dequantized": diff, "max_logit": want_max,
               "diff_over_max": diff / want_max,
               "top1_same_as_dequantized": float(same.float().mean()),
               "top1_agreement_with_fp32": float(
                   (got.argmax(-1) == fp32.argmax(-1)).float().mean()),
               "ms_per_forward": ms, "images_per_s": batch / ms * 1e3,
               "dequantized_ms_per_forward": deq_ms,
               "peak_mem_gb": peak_gb, "k11_routes": routes,
               "profile": prof, "k11_launch_check_short_profiles": short}
        emit(row)
        if routes != {k11_lib.route(batch): batch_forwards * n_fc}:
            raise AssertionError(f"cnn {cfg.name} batch {batch}: K11's "
                                 f"calls ran {routes}")
        if not (diff <= CNN_TOL * want_max and bool((same | close).all())
                and bool(torch.isfinite(got).all())
                and got.shape == (batch, cfg.num_classes)):
            raise AssertionError(f"cnn {cfg.name} batch {batch}: the K11 "
                                 f"route disagrees with the dequantized "
                                 f"forward: {row}")
    del qparams, deq, got, want, fp32, imgs

    for p in leaves:
        p.requires_grad_(True)
    opt_cfg = AdamWConfig(lr=1e-4)
    state = init_opt_state(params, opt_cfg)
    tgen = torch.Generator(device="cuda").manual_seed(SEED + 29)
    batch = {"images": torch.randn((CNN_TRAIN_BATCH,) + shape, generator=tgen,
                                   device="cuda"),
             "labels": torch.randint(0, cfg.num_classes, (CNN_TRAIN_BATCH,),
                                     generator=tgen, device="cuda")}
    dropout = torch.Generator(device="cuda").manual_seed(SEED + 31)

    def step():
        loss, _ = cnn.loss_fn(params, cfg, batch, generator=dropout)
        grads = torch.autograd.grad(loss, leaves)
        _, _, m = apply_updates(params, rebuild(list(grads)), state, opt_cfg)
        return loss.detach(), m["grad_norm"]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, walls = [], [], []
    for _ in range(CNN_TRAIN_STEPS):
        t0 = time.monotonic()
        loss, gnorm = step()
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        losses.append(float(loss))
        gnorms.append(float(gnorm))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {name: fn.launches for name, fn in counters.items()}
    _add_routes(before)
    s_per_step = sum(walls[1:]) / len(walls[1:])
    flops = 3 * cnn.flops_per_image(cfg) * CNN_TRAIN_BATCH
    row = {"phase": "cnn_train", "model": cfg.name,
           "batch": CNN_TRAIN_BATCH, "steps": CNN_TRAIN_STEPS,
           "dropout": cfg.dropout, "losses": losses, "grad_norms": gnorms,
           "step_wall_s": walls, "s_per_step": s_per_step,
           "images_per_s": CNN_TRAIN_BATCH / s_per_step,
           "flops_per_image": cnn.flops_per_image(cfg),
           "model_flops_per_s": flops / s_per_step,
           "fp32_peak_share": flops / s_per_step / PEAK_FP32,
           "peak_mem_gb": peak_gb, "k11_forwards": forwards,
           "launches": launches}
    # after the measured steps and the counts
    row["profile"] = _profile_device(step, 1)
    emit(row)
    want_l = {n: (forwards * n_fc if n == "ternary_matmul" else 0)
              for n in counters}
    if not all(math.isfinite(v) for v in losses + gnorms):
        raise AssertionError(f"cnn {cfg.name} train: a loss or grad norm is "
                             f"not finite: {losses}, {gnorms}")
    if launches != want_l:
        raise AssertionError(f"cnn {cfg.name}: launches {launches} != "
                             f"{want_l}")
    return launches


def _shared_prefix_prompts(rng, vocab, prefix, tails):
    import numpy as np
    head = rng.integers(0, vocab, prefix)
    return [np.concatenate([head, rng.integers(0, vocab, n)]) for n in tails]


def phase_streams():
    """fp32 full width: the dense engine through K1 vs the host-loop
    reference through masked sdpa, and the paged engine through K2 and K3
    vs the dense engine, token for token; then a prefix-cache run."""
    import numpy as np
    import torch
    from repro_torch.models import costing
    from repro_torch.models import transformer as tf_lib
    from repro_torch.serve import (ReferenceEngine, ServeConfig, ServeEngine,
                                   generation_agreement, run_workload)
    cfg = _starcoder2(SERVE_LAYERS)
    t0 = time.monotonic()
    params = tf_lib.init_lm(cfg, seed=SEED, dtype=torch.float32,
                            device="cuda")
    init_s = time.monotonic() - t0
    scfg = ServeConfig(max_slots=4, max_len=512, device="cuda")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (17, 64, 130, 250)]
    got = run_workload(ServeEngine(params, cfg, scfg), prompts, 16)
    want = run_workload(ReferenceEngine(params, cfg, scfg), prompts, 16)
    if got != want or any(len(s) != 16 for s in got.values()):
        raise AssertionError(f"fp32 streams differ: engine {got}, "
                             f"reference {want}")
    paged_cfg = dataclasses.replace(scfg, paged=True, page_size=PAGE,
                                    prefill_chunk=64, prefix_cache=False)
    paged = run_workload(ServeEngine(params, cfg, paged_cfg), prompts, 16)
    if paged != got:
        raise AssertionError(f"fp32 paged streams differ from the dense "
                             f"engine's: paged {paged}, dense {got}")
    # two slots, so the later requests find the first ones' published
    # prefix blocks
    shared = _shared_prefix_prompts(rng, cfg.vocab, 128, (9, 40, 77, 130))
    dense_shared = run_workload(ServeEngine(params, cfg, scfg), shared, 16)
    eng = ServeEngine(params, cfg, dataclasses.replace(
        paged_cfg, max_slots=2, prefix_cache=True))
    hit_streams = run_workload(eng, shared, 16)
    hits = eng.summary()["prefix_hit_tokens"]
    if hits <= 0:
        raise AssertionError("the prefix-cache run hit no prefix block")
    emit({"phase": "streams", "dtype": "float32", "requests": len(prompts),
          "tokens_each": 16, "identical": True, "paged_identical": True,
          "prefix_hit_tokens": hits,
          "prefix_run_agreement": generation_agreement(
              hit_streams, dense_shared)["agreement"],
          "init_s": init_s, "param_gb": costing.tree_bytes(params) / 1e9})
    del eng
    # speculative decode: the same streams as the plain paged engine's
    for k, drafter in ((1, "ngram"), (2, "ngram"), (2, "oracle")):
        _spec_streams(params, cfg, dataclasses.replace(
            paged_cfg, spec_k=k, spec_drafter=drafter), prompts, paged)
    spec_hits = _spec_streams(params, cfg, dataclasses.replace(
        paged_cfg, max_slots=2, prefix_cache=True, spec_k=SPEC_K), shared,
        hit_streams)["prefix_hit_tokens"]
    if spec_hits <= 0:
        raise AssertionError("the speculative prefix-cache run hit no "
                             "prefix block")
    # tree speculation, n-best forks and a quarantined slot's retry: the
    # same streams
    _tree_streams(params, cfg, paged_cfg, prompts, paged)
    _nbest_streams(params, cfg, paged_cfg, prompts, paged)
    _quarantine_streams(params, cfg, paged_cfg, prompts, paged)
    phase_chaos_streams(params, cfg, paged_cfg, prompts, paged)
    phase_durability_streams(params, cfg, {
        "paged": paged_cfg,
        "spec": dataclasses.replace(paged_cfg, spec_k=SPEC_K),
        "dense": scfg}, prompts, paged, "none")
    # int8: the engine quantizes at construction; the reference and the
    # paged engine take its quantized params and INT8_QUANT cfg
    int8_cfg = dataclasses.replace(scfg, quant="int8")
    t0 = time.monotonic()
    eng = ServeEngine(params, cfg, int8_cfg)
    quant_s = time.monotonic() - t0
    qparams, qcfg = eng.params, eng.cfg
    got = run_workload(eng, prompts, 16)
    want = run_workload(ReferenceEngine(qparams, qcfg, int8_cfg), prompts,
                        16)
    if got != want or any(len(s) != 16 for s in got.values()):
        raise AssertionError(f"fp32 int8 streams differ: engine {got}, "
                             f"reference {want}")
    paged = run_workload(ServeEngine(qparams, qcfg, dataclasses.replace(
        paged_cfg, quant="int8")), prompts, 16)
    if paged != got:
        raise AssertionError(f"fp32 int8 paged streams differ from the "
                             f"dense int8 engine's: paged {paged}, dense "
                             f"{got}")
    # phase 5c's int8 engines are built from the fp32 params (their fp
    # oracle, which the forced fallback rebuilds from)
    phase_durability_streams(params, cfg, {
        "paged": dataclasses.replace(paged_cfg, quant="int8")}, prompts,
        paged, "int8")
    del params
    _tree_streams(qparams, qcfg, dataclasses.replace(paged_cfg,
                                                     quant="int8"),
                  prompts, paged)
    _nbest_streams(qparams, qcfg, dataclasses.replace(paged_cfg,
                                                      quant="int8"),
                   prompts, paged)
    _nan_on_spec_and_tree(qparams, qcfg, dataclasses.replace(
        paged_cfg, quant="int8"), prompts, paged)
    emit({"phase": "streams", "dtype": "float32", "quant": "int8",
          "requests": len(prompts), "tokens_each": 16, "identical": True,
          "paged_identical": True, "quantize_s": quant_s,
          "weight_gb": eng.weight_bytes / 1e9,
          "kv_cache_gb": eng.kv_cache_bytes / 1e9})
    del eng, qparams


def _spec_streams(params, cfg, scfg, prompts, want):
    """The speculative engine's fp32 streams on ``prompts`` must be
    ``want``, the plain paged engine's; the oracle drafter must accept.
    Emits and returns the run's summary."""
    from repro_torch.serve import ServeEngine, run_workload
    eng = ServeEngine(params, cfg, scfg)
    got = run_workload(eng, prompts, 16)
    s = eng.summary()
    if got != want:
        first = next((uid, i, a, b) for uid in sorted(want)
                     for i, (a, b) in enumerate(zip(got[uid], want[uid]))
                     if a != b)
        raise AssertionError(
            f"fp32 speculative streams (k={scfg.spec_k}, "
            f"{scfg.spec_drafter}, quant {scfg.quant}) differ from the plain "
            f"paged engine's; first at (uid, index, spec, plain) {first}: "
            f"spec {got}, plain {want}")
    if scfg.spec_drafter == "oracle" and s["spec_accepted_tokens"] <= 0:
        raise AssertionError("the oracle drafter's run accepted no draft")
    emit({"phase": "streams", "dtype": "float32", "quant": scfg.quant,
          "spec_k": scfg.spec_k, "spec_tree_m": scfg.spec_tree_m,
          "drafter": scfg.spec_drafter,
          "prefix_cache": scfg.prefix_cache, "requests": len(prompts),
          "tokens_each": 16, "identical_to_plain_paged": True,
          "accept_rate": s["accept_rate"],
          "accepted_tokens_per_tick": s["accepted_tokens_per_tick"],
          "prefix_hit_tokens": s["prefix_hit_tokens"]})
    return s


def _tree_streams(params, cfg, scfg, prompts, want):
    """Linear (k = 4) and tree (k = 4, ``spec_tree_m=3``) speculation on
    fp32 streams: both must be ``want``, the plain paged engine's, and the
    tree must accept at least as many tokens a tick as linear."""
    rates = [_spec_streams(params, cfg, dataclasses.replace(
        scfg, spec_k=SPEC_K, spec_tree_m=m), prompts, want)[
            "accepted_tokens_per_tick"] for m in (1, TREE_M)]
    if rates[1] < rates[0]:
        raise AssertionError(f"fp32 tree speculation (quant {scfg.quant}) "
                             f"accepted {rates[1]} tokens a tick, linear "
                             f"{rates[0]}")


def _nbest_streams(params, cfg, scfg, prompts, want):
    """The fp32 streams of every request forked 2 ways must both be
    ``want``'s for its uid, the plain paged engine's, with a fork each and a
    clean drain."""
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(params, cfg, scfg)
    for p in prompts:
        eng.submit(p, max_tokens=16, n_best=2)
    got = {r.uid: r.nbest for r in eng.run_until_drained()}
    s = eng.summary()
    expect = {uid: [w, w] for uid, w in want.items()}
    if got != expect or s["forks"] != len(prompts) or eng.pool.audit():
        raise AssertionError(
            f"fp32 n-best streams (quant {scfg.quant}) differ from the plain "
            f"paged engine's, or forks {s['forks']} != {len(prompts)}; first "
            f"at (uid, index, (fork, plain)) {_first_diff(got, expect)}")
    emit({"phase": "streams", "dtype": "float32", "quant": scfg.quant,
          "n_best": 2, "requests": len(prompts), "tokens_each": 16,
          "identical_to_plain_paged": True, "forks": s["forks"],
          "cow_copies": s["cow_copies"], "pool_pages_live": s[
              "pool_pages_live"]})


# the tick at which a decoding slot's private KV page is poisoned, and the
# slot (decoding then: prompt 17, 7 tokens committed)
POISON_TICK, POISON_SLOT = 6, 0


def _quarantine_streams(params, cfg, scfg, prompts, want):
    """One private K page of a decoding slot set to NaN before tick
    ``POISON_TICK``, as the reference's ``kv_bitflip`` fault does: the
    numerics sentinel must quarantine that slot exactly once, at that tick,
    and its retry leave every fp32 stream ``want``'s (the unpoisoned paged
    run's), with a clean pool."""
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(params, cfg, scfg)
    for p in prompts:
        eng.submit(p, max_tokens=16)
    got, page = {}, None
    for tick in range(1000):
        if tick == POISON_TICK:
            slot = POISON_SLOT
            pages = eng._slot_pages[slot]
            live = -(-(len(eng.slot_req[slot].prompt)
                       + eng._host_gen[slot]) // scfg.page_size)
            page = pages[eng.pool.movable_suffix(pages):live][0]
            for key, entry in eng.state.caches.items():
                entry["kv"].k[(slice(None), page) if key.startswith("pat")
                              else page] = float("nan")
        got.update({r.uid: r.generated for r in eng.step()})
        if len(got) == len(prompts):
            break
    s = eng.summary()
    flagged = [t for t, m in enumerate(eng.metrics_log) if m.quarantined]
    if (got != want or s["quarantined"] != 1 or flagged != [POISON_TICK]
            or eng.pool.live or eng.pool.audit()):
        raise AssertionError(
            f"quarantine: {s['quarantined']} quarantined at ticks {flagged} "
            f"(one at {POISON_TICK} expected), streams equal to the "
            f"unpoisoned run's: {got == want} (first difference "
            f"{_first_diff(got, want)}), {eng.pool.live} pages live")
    emit({"phase": "streams", "dtype": "float32", "quarantine": True,
          "poisoned_page": page, "tick": POISON_TICK,
          "quarantined": s["quarantined"],
          "recovery_tokens": s["recovery_tokens"],
          "recovery_j": s["recovery_j"], "identical_to_unpoisoned": True})


# phase 5b: the chaos tier on phase 5's fp32 paged engine. Each transient
# fault kind fires at tick 2 in slot 1 (seed 11), as in the CPU tests'
# chaos matrix; a stall there sleeps STALL_MAG x 0.02 s, since one unit is
# lost in an eager tick's 60-110 ms of host time
CHAOS_TICK, CHAOS_SEED, CHAOS_SLOT, STALL_MAG = 2, 11, 1, 10
# the drift rung's guard and plan of the reference's int8 test
DRIFT_GUARD = dict(drift_check_interval=1, drift_min_checks=1,
                   drift_threshold=0.0, ewma_alpha=0.5)


def _chaos_run(params, cfg, scfg, prompts, n_new, deadline=None):
    """Drain ``prompts`` through a fresh engine of ``scfg``. Returns the
    engine, the streams by uid, the summary and the host seconds."""
    import torch
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(params, cfg, scfg)
    for p in prompts:
        eng.submit(p, max_tokens=n_new, deadline_ticks=deadline)
    t0 = time.monotonic()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    return (eng, {r.uid: list(r.generated) for r in done}, eng.summary(),
            time.monotonic() - t0)


def _pool_state(eng):
    """(live pages, audit violations, every float K/V value finite)."""
    import torch
    finite = all(bool(torch.isfinite(t).all())
                 for e in eng.state.caches.values()
                 for t in (e["kv"].k, e["kv"].v)
                 if t.dtype.is_floating_point)
    return eng.pool.live, eng.pool.audit(), finite


def _split_counters_zero():
    """Whether every per-stream counter of the split kernels (K1, K2, K5)
    is back at zero, as each launch's last block leaves it."""
    import torch
    from repro_torch.kernels import paged_decode_attention as k2
    torch.cuda.synchronize()
    return all(bool((c == 0).all()) for c, _ in k2._scratch.values())


def _nan_on_spec_and_tree(params, cfg, scfg, prompts, want):
    """``nan_logits`` at tick 2 in slot 1 on the speculative (k = 4) and the
    tree (k = 4, m = 3) engine: one quarantine, at that tick, the streams
    ``want`` (the plain paged engine's), a clean pool, the split kernels'
    counters at zero."""
    from repro_torch.serve import FaultPlan, GuardrailConfig
    plan = FaultPlan.single("nan_logits", tick=CHAOS_TICK, seed=CHAOS_SEED,
                            slot=CHAOS_SLOT)
    rows = []
    for m in (1, TREE_M):
        eng, got, s, wall = _chaos_run(params, cfg, dataclasses.replace(
            scfg, spec_k=SPEC_K, spec_tree_m=m, faults=plan,
            guard=GuardrailConfig(audit_interval=1)), prompts, 16)
        flagged = [t for t, x in enumerate(eng.metrics_log) if x.quarantined]
        live, audit, finite = _pool_state(eng)
        if (got != want or s["quarantined"] != 1 or flagged != [CHAOS_TICK]
                or live or audit or not finite or s["audit_failures"]
                or not _split_counters_zero()):
            raise AssertionError(
                f"chaos: nan_logits on the spec tick (k {SPEC_K}, m {m}, "
                f"quant {scfg.quant}): quarantined at {flagged}, streams "
                f"equal {got == want} (first difference "
                f"{_first_diff(got, want)}), {live} pages live, audit "
                f"{audit}, finite {finite}")
        rows.append({"spec_k": SPEC_K, "spec_tree_m": m,
                     "quarantined": s["quarantined"], "ticks": s["ticks"],
                     "recovery_tokens": s["recovery_tokens"], "seconds": wall})
    emit({"phase": "chaos_streams", "dtype": "float32", "quant": scfg.quant,
          "fault": "nan_logits", "runs": rows,
          "identical_to_plain_paged": True})


def _xor_pool_kernels():
    """K2, K5 (T = 5) and K3 in their int8-KV modes against their plain
    versions on pools whose K codes were XORed with 0x55, as ``kv_bitflip``
    corrupts an int8 page: the codes span -128..127, and -128 is a code the
    quantizer never writes. Every window, MODES' bounds."""
    import torch
    from repro_torch.kernels import paged_decode_attention as k2
    from repro_torch.kernels import paged_prefill_attention as k3
    from repro_torch.kernels import paged_verify_attention as k5
    from repro_torch.kernels import ref
    rows = []
    for q_name, kv_name, atol, rtol in MODES:
        if kv_name != "int8":
            continue
        q_dtype = getattr(torch, q_name)
        cases = (("paged_decode_attention", k2.paged_decode_attention,
                  ref.paged_decode_attention_ref,
                  _paged_decode_inputs(q_dtype, torch.int8), 1),
                 ("paged_verify_attention", k5.paged_verify_attention,
                  ref.paged_verify_attention_ref,
                  _verify_inputs(SPEC_K + 1)(q_dtype, torch.int8), 1),
                 ("paged_prefill_attention", k3.paged_prefill_attention,
                  ref.paged_prefill_attention_ref,
                  _prefill_inputs(q_dtype, torch.int8), 3))
        for name, kernel, plain, args, k_pos in cases:
            args = list(args)
            args[k_pos] = args[k_pos] ^ 0x55
            if not bool((args[k_pos] == -128).any()):
                raise AssertionError(f"{name}: the XORed pool holds no -128")
            kw = {"k_scale": args[-2], "v_scale": args[-1]}
            for window in WINDOWS:
                got = kernel(*args[:-2], scale=D ** -0.5, window=window,
                             **kw)
                torch.cuda.synchronize()
                want = plain(*args[:-2], scale=D ** -0.5, window=window, **kw)
                err = (got.float() - want.float()).abs()
                if not (bool((err <= atol + rtol * want.float().abs()).all())
                        and bool(torch.isfinite(got).all())):
                    raise AssertionError(
                        f"{name} on an XORed int8 pool disagrees with its "
                        f"plain version: q {q_name}, window {window}: max "
                        f"abs err {float(err.max())} (atol {atol}, rtol "
                        f"{rtol})")
                rows.append([name, q_name, window, float(err.max())])
    emit({"phase": "kernels_xor_pool", "rows": rows, "timed": False})


def phase_chaos_streams(params, cfg, paged_cfg, prompts, want):
    """Phase 5b on phase 5's fp32 params, prompts and paged streams: every
    transient fault kind on the paged engine, nan_logits on the spec and
    tree ticks, a process kill, deadline shedding, the int8 drift rung
    built from the fp32 params, and K2, K3 and K5 on an XORed int8 pool."""
    import numpy as np
    from repro_torch.serve import (TRANSIENT_FAULT_KINDS, FaultPlan,
                                   GuardrailConfig, ProcessKilled,
                                   ServeEngine, generation_agreement)
    t_phase = time.monotonic()
    rows = []
    for kind in TRANSIENT_FAULT_KINDS:
        plan = FaultPlan.single(kind, tick=CHAOS_TICK, seed=CHAOS_SEED,
                                slot=CHAOS_SLOT,
                                magnitude=STALL_MAG if kind == "stall"
                                else 1.0)
        eng, got, s, wall = _chaos_run(params, cfg, dataclasses.replace(
            paged_cfg, faults=plan, guard=GuardrailConfig(
                audit_interval=1)), prompts, 16)
        live, audit, finite = _pool_state(eng)
        numerics = kind in ("nan_logits", "inf_logits", "kv_bitflip")
        readback = kind.startswith("readback")
        ok = (got == want and s["faults_injected"] >= 1 and not live
              and not audit and finite and s["audit_failures"] == 0
              and s["quarantined"] == (1 if numerics else 0)
              and (not readback or s["readback_retries"] >= 1)
              and _split_counters_zero())
        if not ok:
            raise AssertionError(
                f"chaos: {kind} at tick {CHAOS_TICK}: streams equal "
                f"{got == want} (first difference {_first_diff(got, want)}), "
                f"injected {s['faults_injected']}, quarantined "
                f"{s['quarantined']}, readback retries "
                f"{s['readback_retries']}, {live} pages live, audit {audit}, "
                f"finite {finite}, audit failures {s['audit_failures']}")
        rows.append({"kind": kind, "injected": s["faults_injected"],
                     "quarantined": s["quarantined"],
                     "readback_retries": s["readback_retries"],
                     "recovery_tokens": s["recovery_tokens"],
                     "recovery_j": s["recovery_j"], "ticks": s["ticks"],
                     "host_readbacks": eng.host_readbacks,
                     "compaction_pauses": s["compaction_pauses"],
                     "seconds": wall})
    emit({"phase": "chaos_streams", "dtype": "float32", "quant": "none",
          "tick": CHAOS_TICK, "slot": CHAOS_SLOT, "seed": CHAOS_SEED,
          "stall_magnitude": STALL_MAG, "kinds": rows,
          "identical_to_fault_free": True})
    _nan_on_spec_and_tree(params, cfg, paged_cfg, prompts, want)
    # a process kill leaves step() at its tick
    eng = ServeEngine(params, cfg, dataclasses.replace(
        paged_cfg, faults=FaultPlan.single("process_kill", tick=CHAOS_TICK)))
    for p in prompts:
        eng.submit(p, max_tokens=16)
    try:
        for _ in range(CHAOS_TICK + 1):
            eng.step()
        raise AssertionError("chaos: process_kill did not raise")
    except ProcessKilled:
        if eng._tick_idx != CHAOS_TICK:
            raise AssertionError(f"chaos: process_kill raised at tick "
                                 f"{eng._tick_idx}, not {CHAOS_TICK}")
    del eng
    # deadline 1 on 16 requests over 4 slots: the queue past its deadline
    # is shed, and shed + finished partition the workload
    rng = np.random.default_rng(SEED + 9)
    many = [rng.integers(0, cfg.vocab, int(n))
            for n in rng.integers(8, 65, 16)]
    eng, got, s, wall = _chaos_run(params, cfg, paged_cfg, many, 16,
                                   deadline=1)
    if not (s["shed"] > 0 and eng.n_shed + eng.n_finished_ok == len(many)
            and len(got) == len(many) and not eng.pool.live):
        raise AssertionError(f"chaos: deadline 1 shed {s['shed']}, finished "
                             f"{eng.n_finished_ok} of {len(many)}")
    emit({"phase": "chaos_deadline", "requests": len(many),
          "slots": paged_cfg.max_slots, "deadline_ticks": 1,
          "shed": s["shed"], "finished": eng.n_finished_ok,
          "shed_rate": s["shed_rate"], "ticks": s["ticks"], "seconds": wall})
    del eng
    # the int8 drift rung: an int8 engine built from the fp32 params (the
    # pair it keeps as its fp oracle), the reference's guard and a
    # kv_bitflip of an int8 K page (finite garbage the sentinel cannot see)
    eng, got, s, wall = _chaos_run(params, cfg, dataclasses.replace(
        paged_cfg, quant="int8",
        faults=FaultPlan.single("kv_bitflip", tick=CHAOS_TICK, seed=3),
        guard=GuardrailConfig(**DRIFT_GUARD)), prompts, 16)
    live, audit, _ = _pool_state(eng)
    if (len(got) != len(prompts) or any(len(g) != 16 for g in got.values())
            or live or audit or s["fp_fallbacks"] > 1
            or s["faults_injected"] != 1):
        raise AssertionError(
            f"chaos: the drift rung's run: {len(got)} requests, lengths "
            f"{[len(g) for g in got.values()]}, {live} pages live, audit "
            f"{audit}, fp fallbacks {s['fp_fallbacks']}, injected "
            f"{s['faults_injected']}")
    emit({"phase": "chaos_drift", "dtype": "float32", "quant": "int8",
          "fp_fallbacks": s["fp_fallbacks"], "drift_checks": eng.drift_checks,
          "degraded_ticks": s["degraded_ticks"], "ticks": s["ticks"],
          "recovery_tokens": s["recovery_tokens"],
          "agreement_with_fp32_paged": generation_agreement(
              got, want)["agreement"],
          "seconds": wall})
    del eng
    _xor_pool_kernels()
    emit({"phase": "chaos_streams_total",
          "seconds": time.monotonic() - t_phase})


# phase 5c: the process_kill tick and the snapshot interval of the fp32
# kill-and-restore runs (a snapshot at tick 4, ticks 4-6 replayed), and the
# tick before which one int8 run forces its fp fallback
KILL_TICK, KILL_INTERVAL, FALLBACK_TICK = 7, 4, 3


def _timed_restore(eng):
    """``eng.restore()`` with its host seconds split into loading (the
    manifest, the checksum, the arrays, the host state, the audit) and the
    replayed ticks. Returns (recovered requests, report)."""
    import torch
    steps = _host_timed(eng, "step")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    recovered = eng.restore()
    torch.cuda.synchronize()
    total = time.monotonic() - t0
    del eng.step
    replay = sum(sec for sec, _ in steps)
    return recovered, {"restore_s": total, "load_s": total - replay,
                       "replay_s": replay}


def _free_device():
    """After the caller dropped its last reference to an engine (the
    simulated crash): its tensors freed before the next engine allocates
    its own."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _kill_and_restore(params, cfg, scfg, prompts, n_new, prepare=None):
    """A durable engine of ``scfg`` (snapshots every KILL_INTERVAL ticks
    into a temporary directory) killed at KILL_TICK, dropped, and a fresh
    engine restored from the directory and drained (journal only: the
    snapshots after a restore are cut to keep the phase short).
    ``prepare(eng, t)`` runs before each of the dead engine's ticks.
    Returns the restored engine, the streams by uid and a report."""
    import shutil
    import tempfile
    from repro_torch.serve import FaultPlan, ProcessKilled, ServeEngine
    d = tempfile.mkdtemp(prefix="chip_smoke_durable.")
    try:
        scfg = dataclasses.replace(
            scfg, checkpoint_dir=d, checkpoint_interval=KILL_INTERVAL,
            faults=FaultPlan.single("process_kill", tick=KILL_TICK))
        eng = ServeEngine(params, cfg, scfg)
        writes = _host_timed(eng, "_write_snapshot")
        for p in prompts:
            eng.submit(p, max_tokens=n_new)
        killed = False
        for t in range(10000):
            if prepare is not None:
                prepare(eng, t)
            try:
                eng.step()
            except ProcessKilled:
                killed = True
                break
        if not killed or eng._tick_idx != KILL_TICK:
            raise AssertionError(f"durability: the kill at tick {KILL_TICK} "
                                 f"did not fire (engine at tick "
                                 f"{eng._tick_idx})")
        eng = None
        _free_device()
        eng = ServeEngine(params, cfg, dataclasses.replace(
            scfg, checkpoint_interval=0))
        recovered, rep = _timed_restore(eng)
        got = {r.uid: list(r.generated) for r in recovered}
        got.update({r.uid: list(r.generated)
                    for r in eng.run_until_drained()})
        want_replay = KILL_TICK - KILL_TICK // KILL_INTERVAL * KILL_INTERVAL
        s = eng.summary()
        if s["replayed_ticks"] != want_replay or s["restore_j"] <= 0:
            raise AssertionError(
                f"durability: replayed {s['replayed_ticks']} ticks (want "
                f"{want_replay}), restore_j {s['restore_j']}")
        rep.update({"replayed_ticks": s["replayed_ticks"],
                    "snapshot_s": [sec for sec, _ in writes],
                    "snapshot_gb": [nbytes / 1e9 for _, nbytes in writes],
                    "journal_bytes": s["journal_bytes"],
                    "restore_j": s["restore_j"]})
        return eng, got, rep
    finally:
        shutil.rmtree(d, ignore_errors=True)


def phase_durability_streams(params, cfg, scfgs, prompts, want, quant):
    """Phase 5c on phase 5's fp32 params and prompts: a process kill at
    KILL_TICK, a restore from the tick-4 snapshot and the journal, and a
    drain, on each engine of ``scfgs`` (name -> ServeConfig): the streams
    ``want`` (phase 5's), a clean pool and audit, the split kernels'
    counters at zero. In the int8 mode (engines built from the fp32
    params, their fp oracle) one more run forces ``_fallback_to_fp()``
    before tick FALLBACK_TICK, so its snapshot holds the fp runtime: the
    restored engine must have rebuilt it (``_fell_back``, an fp32 pool) and
    give the streams of the same forced run without a crash."""
    import torch
    from repro_torch.serve import ServeEngine, generation_agreement
    t_phase = time.monotonic()
    rows = []

    def check(name, eng, got, want_streams, rep):
        live, audit, finite = (_pool_state(eng) if eng.pool is not None
                               else (0, [], True))
        if (got != want_streams or live or audit or not finite
                or not _split_counters_zero()):
            raise AssertionError(
                f"durability ({name}, {quant}): streams equal "
                f"{got == want_streams} (first difference "
                f"{_first_diff(got, want_streams)}), {live} pages live, "
                f"audit {audit}, finite {finite}")
        rows.append({"engine": name, **rep})

    for name, scfg in scfgs.items():
        eng, got, rep = _kill_and_restore(params, cfg, scfg, prompts, 16)
        check(name, eng, got, want, rep)
        eng = None
        _free_device()
    if quant == "int8":
        def force(eng, t):
            if t == FALLBACK_TICK:
                eng._fallback_to_fp()

        scfg = scfgs["paged"]
        eng = ServeEngine(params, cfg, scfg)
        for p in prompts:
            eng.submit(p, max_tokens=16)
        done = []
        for t in range(10000):
            force(eng, t)
            done += eng.step()
            if not len(eng.scheduler) and all(r is None
                                              for r in eng.slot_req):
                break
        forced = {r.uid: list(r.generated) for r in done}
        eng = None
        _free_device()
        eng, got, rep = _kill_and_restore(params, cfg, scfg, prompts, 16,
                                          prepare=force)
        pool_dtype = eng.state.caches["pat0"]["kv"].k.dtype
        if not (eng._fell_back and pool_dtype == torch.float32):
            raise AssertionError(f"durability: the fell-back snapshot "
                                 f"restored fell_back {eng._fell_back}, "
                                 f"a {pool_dtype} pool")
        check("paged_fp_fallback", eng, got, forced, rep)
        rows[-1]["agreement_with_int8_paged"] = generation_agreement(
            forced, want)["agreement"]
        eng = None
        _free_device()
    emit({"phase": "durability_streams", "dtype": "float32", "quant": quant,
          "kill_tick": KILL_TICK, "checkpoint_interval": KILL_INTERVAL,
          "runs": rows, "identical": True,
          "seconds": time.monotonic() - t_phase})


# K9's and K11's launches of each of their kernels in the main-path runs
# (the train bench, the kernel bench, the CNN phases), for the kernels line
MAIN_ROUTES = {"int8_matmul_dx": {}, "ternary_matmul": {}}
# the head dims of the serve runs that launched each attention kernel
ATTENTION_KERNELS = ("decode_attention", "paged_decode_attention",
                     "paged_prefill_attention", "paged_verify_attention")
MAIN_HEAD_DIMS = {}


def _routes():
    """K9's and K11's per-kernel launch counts now."""
    counters = _counters()
    return {name: dict(counters[name].launches_by_kernel)
            for name in MAIN_ROUTES}


def _add_routes(before):
    """Adds K9's and K11's per-kernel launches since ``before`` (a
    ``_routes()``) to MAIN_ROUTES."""
    for name, now in _routes().items():
        for kernel, count in now.items():
            MAIN_ROUTES[name][kernel] = (MAIN_ROUTES[name].get(kernel, 0)
                                         + count - before[name][kernel])


def _counters():
    """Every kernel's launch counter, by kernel name."""
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import flash_attention as k678
    from repro_torch.kernels import int8_matmul as k4
    from repro_torch.kernels import paged_decode_attention as k2
    from repro_torch.kernels import paged_prefill_attention as k3
    from repro_torch.kernels import paged_verify_attention as k5
    from repro_torch.kernels import ternary_matmul as k11
    return {"decode_attention": k1.decode_attention,
            "paged_decode_attention": k2.paged_decode_attention,
            "paged_prefill_attention": k3.paged_prefill_attention,
            "paged_verify_attention": k5.paged_verify_attention,
            "int8_matmul": k4.int8_matmul,
            "flash_attention_fwd": k678.flash_attention_fwd,
            "flash_attention_bwd_dq": k678.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": k678.flash_attention_bwd_dkv,
            "int8_matmul_dx": k4.int8_matmul_dx,
            "flash_attention": k678.flash_attention,
            "ternary_matmul": k11.ternary_matmul}


def _serve_run(phase, eng, acct, prompts, n_new, n_best=1, hits=True):
    """Submit (each request forked ``n_best`` ways), set every launch
    counter to 0, drain, read the counters; check that every request
    finished with every stream (or, under an armed guard, was shed: the
    chaos tier's backpressure), that each kernel launched as many times as
    the path's decode ticks and admission (dense) or extend (paged) calls
    demand, and on the paged path that the pool drained clean (and, with
    ``hits``, that the prefix cache hit). Returns the launches, the streams
    by uid (each request's ``nbest`` list when forked) and the summary."""
    import torch
    for p in prompts:
        eng.submit(p, max_tokens=n_new, n_best=n_best)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _counters()
    by_kernel = {name: fn.launches_by_kernel for name, fn in counters.items()
                 if hasattr(fn, "launches_by_kernel")}
    for fn in counters.values():
        fn.launches = 0
    for counts in by_kernel.values():
        for kernel in counts:
            counts[kernel] = 0
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    by_kernel = {name: dict(counts) for name, counts in by_kernel.items()}
    s = eng.summary()
    rep = acct.report()
    decode_ticks = sum(1 for m in eng.metrics_log if m.active_slots > 0)
    admissions = sum(1 for m in eng.metrics_log if m.prefill_tokens > 0)
    streams = {r.uid: r.nbest if n_best > 1 else r.generated for r in done}
    short = sum(1 for r in done if len(r.generated) != n_new or (
        n_best > 1 and [len(x) for x in r.nbest] != [n_new] * n_best))
    if len(done) != len(prompts) or short != s["shed"]:
        raise AssertionError(f"{phase}: the run did not finish every "
                             f"request ({len(done)} of {len(prompts)} "
                             f"back, {short} short, {s['shed']} shed)")
    paged = eng.pool is not None
    int8 = eng.scfg.quant == "int8"
    spec = eng.scfg.spec_k > 0                  # the ngram drafter: no K2
    # every attention layer attends; K4 takes each one's wq, wk, wv, wo
    # and, in a dense FFN, w_in, w_out and (a gated MLP: zamba2's shared
    # block always) w_gate; an MoE block's experts dequantize through
    # layers.wl, as the reference's do, and an SSD block launches neither
    # (its projections stay full precision in the int8 mode, as the
    # reference's do)
    specs = [sp for sp in ([sp for _ in range(eng.cfg.repeats)
                            for sp in eng.cfg.pattern] + list(eng.cfg.tail))
             if sp.kind == "attn"]
    layers = len(specs)
    k4_per_step = sum(4 + (0 if sp.moe or not (sp.has_ffn or sp.shared_attn)
                           else 2 + int(eng.cfg.mlp_gated or sp.shared_attn))
                      for sp in specs)
    want = {"decode_attention": 0 if paged else decode_ticks * layers,
            "paged_decode_attention": decode_ticks * layers
            if paged and not spec else 0,
            "paged_prefill_attention": admissions * layers if paged
            else 0,
            "paged_verify_attention": decode_ticks * layers if spec else 0,
            "int8_matmul": (decode_ticks + admissions) * k4_per_step
            if int8 else 0,
            "flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "int8_matmul_dx": 0,
            "flash_attention": 0, "ternary_matmul": 0}
    if launches != want:
        raise AssertionError(f"{phase}: launches {launches} != {want} "
                             f"(decode ticks {decode_ticks}, admission or "
                             f"extend calls {admissions})")
    # which of K1's, K2's, K3's, K4's and K5's kernels ran: the one their
    # route names for the activations' dtype, the cache's and the head dim
    # (bf16 q over the int8 cache at D = 128 on K1's, K2's, K3's and K5's
    # tensor cores, and at 112 and 168 on K3's; over the fp32 cache, fp32 q
    # or another head dim on their SIMT kernels); bf16 x on
    # K4's wgmma kernel (M > 8: admission and extend calls, the spec ticks'
    # 40 rows) and its decode kernel (M <= 8: the 8 slots of a decode tick,
    # an extend call of a few tokens), never its SIMT one
    from repro_torch.kernels import paged_decode_attention as k2
    from repro_torch.kernels import paged_prefill_attention as k3
    k3_by = by_kernel["paged_prefill_attention"]
    k4_by = by_kernel["int8_matmul"]
    q_dtype = eng.params["embed"]["w"].dtype
    kv_dtype = torch.int8 if int8 else eng.scfg.cache_dtype
    head_dim = eng.cfg.resolved_head_dim
    attn_kernel = k2.route(q_dtype, kv_dtype, head_dim)
    k3_kernel = k3.route(q_dtype, kv_dtype, head_dim)
    for name in ATTENTION_KERNELS:
        if launches[name]:
            MAIN_HEAD_DIMS.setdefault(name, set()).add(head_dim)
    if any(by_kernel[name][k3_kernel if name == "paged_prefill_attention"
                           else attn_kernel] != launches[name]
           for name in ("decode_attention", "paged_decode_attention",
                        "paged_prefill_attention",
                        "paged_verify_attention")) or (
            int8 and not (k4_by["simt"] == 0 and k4_by["wgmma"] > 0
                          and (spec or k4_by["decode"] > 0))):
        raise AssertionError(
            f"{phase}: K1 ran {by_kernel['decode_attention']}, K2 ran "
            f"{by_kernel['paged_decode_attention']}, K3 "
            f"{k3_by}, K5 {by_kernel['paged_verify_attention']} (all on "
            f"{attn_kernel} expected, K3 on {k3_kernel}), K4 ran {k4_by}")
    row = {"phase": phase, "arch": eng.cfg.name,
           "layers": eng.cfg.n_layers, "attention_layers": layers,
           "head_dim": head_dim,
           "dtype": str(q_dtype).replace("torch.", ""),
           "quant": eng.scfg.quant,
           "cache": str(kv_dtype).replace("torch.", ""),
           "requests": len(prompts), "new_tokens_each": n_new,
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
           "weight_bytes": eng.weight_bytes,
           "kv_cache_bytes": eng.kv_cache_bytes,
           "host_readbacks": eng.host_readbacks,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "launches_by_kernel": by_kernel,
           "k4_launches_per_step": launches["int8_matmul"]
           / max(decode_ticks + admissions, 1),
           "port_kernel_launches_per_decode_tick": sum(launches.values())
           / max(decode_ticks, 1)}
    if paged:
        audit = eng.pool.audit()
        row.update({"page_size": PAGE,
                    "prefill_chunk": eng.scfg.prefill_chunk,
                    "pool_pages": s["pool_pages"],
                    "prefix_hit_tokens": s["prefix_hit_tokens"],
                    "prefix_hit_rate": s["prefix_hit_rate"],
                    "prefill_gather_bytes": s["prefill_gather_bytes"],
                    "n_best": n_best,
                    **{key: s[key] for key in (
                        "forks", "cow_copies", "cow_bytes",
                        "fork_saved_bytes", "fork_saved_flops",
                        "pool_pages_live")}})
        if hits and s["prefix_hit_tokens"] <= 0:
            raise AssertionError(f"{phase}: the run hit no prefix block")
        if s["pool_pages_live"] or audit:
            raise AssertionError(f"{phase}: the pool did not drain clean: "
                                 f"{s['pool_pages_live']} pages live, "
                                 f"audit {audit}")
    if spec:
        sp = rep["spec"]
        row.update({"spec_k": eng.scfg.spec_k,
                    "spec_tree_m": eng.scfg.spec_tree_m,
                    "drafter": eng.scfg.spec_drafter,
                    "accept_rate": s["accept_rate"],
                    "accepted_tokens_per_tick":
                        s["accepted_tokens_per_tick"],
                    "j_per_accepted_token": sp["j_per_accepted_token"],
                    "draft_j": sp["draft_j"], "verify_j": sp["verify_j"]})
    emit(row)
    return launches, streams, s


def _accountant():
    from repro_torch.core import accounting
    return accounting.CarbonAccountant(accounting.AccountantConfig(
        device="h100_sxm", n_devices=1))


def phase_serve(cfg, params, quant="none"):
    """bf16 full width, the dense serve loop billed to h100_sxm: 16
    requests of 32-1024 prompt tokens, 64 new tokens each. Returns the
    launches."""
    import numpy as np
    from repro_torch.serve import ServeConfig, ServeEngine
    acct = _accountant()
    eng = ServeEngine(params, cfg, ServeConfig(
        max_slots=8, max_len=2048, device="cuda", quant=quant),
        accountant=acct)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(32, 1025)))
               for _ in range(16)]
    return _serve_run("serve", eng, acct, prompts, 64)[0]


def _paged_scfg(quant, **kw):
    """Phases 7, 8b and 8d's engine: 8 slots, max_len 2048, pages of 16,
    256-token chunks, the prefix cache on."""
    from repro_torch.serve import ServeConfig
    return ServeConfig(max_slots=8, max_len=2048, device="cuda", paged=True,
                       page_size=PAGE, prefill_chunk=256, prefix_cache=True,
                       quant=quant, **kw)


def _paged_traffic(cfg):
    """16 requests of a 512-token shared prompt plus a 32-512-token tail."""
    import numpy as np
    rng = np.random.default_rng(SEED + 3)
    tails = [int(n) for n in rng.integers(32, 513, 16)]
    return _shared_prefix_prompts(rng, cfg.vocab, 512, tails)


def phase_paged_serve(cfg, params, quant="none", spec_k=0):
    """bf16 weights, the paged serve loop with the prefix cache on
    shared-prompt traffic (``_paged_traffic``); with ``spec_k``,
    speculative decode with the ngram drafter. Returns the launches, the
    streams and the summary."""
    from repro_torch.serve import ServeEngine
    acct = _accountant()
    eng = ServeEngine(params, cfg, _paged_scfg(quant, spec_k=spec_k),
                      accountant=acct)
    return _serve_run("spec_serve" if spec_k else "paged_serve", eng, acct,
                      _paged_traffic(cfg), 64)


def _first_diff(got, want):
    """(uid, index, got, want) at the first token where two runs' streams
    differ, or None."""
    for uid in sorted(want):
        a, b = got.get(uid), want[uid]
        if a == b:
            continue
        pairs = (list(zip(a, b)) if a and not isinstance(a[0], list)
                 else [(x, y) for sa, sb in zip(a, b)
                       for x, y in zip(sa, sb)])
        i = next((i for i, (x, y) in enumerate(pairs) if x != y),
                 min(len(a), len(b)))
        return uid, i, pairs[i] if i < len(pairs) else None
    return None


def _profile_serve_ticks(params, cfg, scfg, prompts, n_new, ticks=3):
    """A fresh engine with ``prompts`` submitted, stepped until every one
    of them decodes, then ``ticks`` decode ticks under torch.profiler
    (``launch/serve.py``'s ``profile_ticks``): device ms a tick (the sum
    of the kernels' device time), host wall ms a tick, the busy share, the
    launches and the largest kernels' device ms a tick. The engine is
    dropped undrained: the traffic's streams, launches and clean drain are
    the caller's ``_serve_run``'s."""
    from repro_torch.launch.serve import profile_ticks
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(params, cfg, scfg)
    for p in prompts:
        eng.submit(p, max_tokens=n_new)
    while eng.last_metrics is None or (eng.last_metrics.active_slots
                                       < len(prompts)):
        eng.step()
    _, rep = profile_ticks(eng, ticks, top=8)
    return {"ticks": ticks,
            "device_ms_per_tick": rep["device_busy_ms"] / ticks,
            "wall_ms_per_tick": rep["wall_ms"] / ticks,
            "device_busy_share": rep["device_busy_share"],
            "launches_per_tick": rep["kernel_launches_per_tick"],
            "top_kernels_ms_per_tick": {
                name[:80]: ms / ticks
                for name, ms in rep["top_kernels_ms"].items()}}


def phase_tree_serve(cfg, params, quant, plain, linear):
    """Phase 8b's traffic with tree speculation (``spec_k=4``,
    ``spec_tree_m=3``): K5 launches are tree ticks x 16 on 8b's route and
    the pool drains clean (``_serve_run``); the streams' agreement with
    phase 8b's linear ones and phase 7's plain ones (``plain``, ``linear``:
    their (streams, summary)) and the accepted tokens per tick beside
    linear's are reported. They are not asserted here: the tree verifies
    120 rows a tick where 8b verifies 40 and phase 7 decodes 8, and bf16
    GEMMs of other row counts round otherwise, so a near tie can flip a
    greedy token; phase 5 asserts the identity in fp32. Then one profiled
    tree tick against one linear tick on 8 of the requests. Returns the
    launches."""
    from repro_torch.serve import ServeEngine, generation_agreement
    acct = _accountant()
    prompts = _paged_traffic(cfg)
    eng = ServeEngine(params, cfg, _paged_scfg(
        quant, spec_k=SPEC_K, spec_tree_m=TREE_M), accountant=acct)
    launches, streams, s = _serve_run("tree_serve", eng, acct, prompts, 64)
    pairs = {"tree_linear": (streams, linear[0]),
             "tree_plain": (streams, plain[0]),
             "linear_plain": (linear[0], plain[0])}
    agree = {name: {**generation_agreement(a, b),
                    "first_difference": _first_diff(a, b)}
             for name, (a, b) in pairs.items()}
    lin_rate = linear[1]["accepted_tokens_per_tick"]
    profiles = {name: _profile_serve_ticks(params, cfg, _paged_scfg(
        quant, spec_k=SPEC_K, spec_tree_m=m), prompts[:8], 64)
        for name, m in (("tree", TREE_M), ("linear", 1))}
    emit({"phase": "tree_serve_profile", "quant": quant,
          "agreement": agree,
          "accepted_tokens_per_tick": s["accepted_tokens_per_tick"],
          "linear_accepted_tokens_per_tick": lin_rate,
          "cow_copies": s["cow_copies"], "cow_bytes": s["cow_bytes"],
          "tree_over_linear_device_ms": (
              profiles["tree"]["device_ms_per_tick"]
              / max(profiles["linear"]["device_ms_per_tick"], 1e-9)),
          "profiles": profiles})
    return launches


def _time_calls(eng, name):
    """Replace the engine's method ``name`` by one that times each call:
    the host clock from a synchronize before it to one after it, and the
    device time of its kernels (torch.profiler). Returns the list the
    (host ms, device ms) pairs go to."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    method, rows = getattr(eng, name), []

    def timed(*args, **kw):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            out = method(*args, **kw)
            torch.cuda.synchronize()
            host_ms = 1e3 * (time.monotonic() - t0)
        rows.append((host_ms, sum(
            e.self_device_time_total for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA) / 1e3))
        return out
    setattr(eng, name, timed)
    return rows


def phase_nbest(cfg, params, quant="none"):
    """n-best sampling over copy-on-write forks: 8 requests of 100-500
    prompt tokens (none page-aligned, so every fork shares a partial
    boundary block) forked 4 ways, 32 greedy tokens, 8 slots. Every stream
    must equal a plain paged engine's for its prompt; that engine is fed
    each prompt at the tick the fork group was admitted, so its extend
    calls carry the same rows and its decode ticks the same 8 slots (the
    same kernel shapes: bit-comparable in bf16). 24 forks, at least 24
    page copies, saved bytes, a clean drain. Then the same at temperature
    0.8: a clean drain, and the distinct streams of each group reported.
    Returns the launches."""
    import numpy as np
    from repro_torch.serve import ServeConfig, ServeEngine
    rng = np.random.default_rng(SEED + 7)
    lens = [int(n) + (int(n) % PAGE == 0) for n in rng.integers(100, 501, 8)]
    prompts = [rng.integers(0, cfg.vocab, n) for n in lens]
    scfg = ServeConfig(max_slots=8, max_len=1024, device="cuda", paged=True,
                       page_size=PAGE, prefill_chunk=256, quant=quant)
    acct = _accountant()
    eng = ServeEngine(params, cfg, scfg, accountant=acct)
    launches, streams, s = _serve_run("nbest_serve", eng, acct, prompts,
                                      NBEST_NEW, n_best=NBEST, hits=False)
    admit_at = [t for t, m in enumerate(eng.metrics_log)
                for _ in range(m.admitted)]
    plain = ServeEngine(params, cfg, scfg)
    want = {}
    for tick in range(10000):
        due = [i for i, t in enumerate(admit_at) if t == tick]
        for i in due:
            plain.submit(prompts[i], max_tokens=NBEST_NEW)
        want.update({r.uid: r.generated for r in plain.step()})
        if plain.metrics_log[-1].admitted != len(due):
            raise AssertionError(f"nbest_serve: the plain engine admitted "
                                 f"{plain.metrics_log[-1].admitted} at tick "
                                 f"{tick}, the fork groups {len(due)}")
        if len(want) == len(prompts):
            break
    expect = {uid: [w] * NBEST for uid, w in want.items()}
    if streams != expect:
        raise AssertionError(
            f"nbest_serve ({quant}): a fork's stream differs from the plain "
            f"engine's for its prompt; first at (uid, index, (fork, plain)) "
            f"{_first_diff(streams, expect)}")
    if not (s["forks"] == len(prompts) * (NBEST - 1)
            and s["cow_copies"] >= len(prompts) * (NBEST - 1)
            and s["fork_saved_bytes"] > 0):
        raise AssertionError(f"nbest_serve ({quant}): forks {s['forks']}, "
                             f"copies {s['cow_copies']}, saved bytes "
                             f"{s['fork_saved_bytes']}")
    hot = ServeEngine(params, cfg, dataclasses.replace(scfg,
                                                       temperature=0.8))
    calls = {name: _time_calls(hot, name)
             for name in ("_fork_slots", "_cow_call")}
    for p in prompts:
        hot.submit(p, max_tokens=NBEST_NEW, n_best=NBEST)
    done = hot.run_until_drained()
    audit = hot.pool.audit()
    if (len(done) != len(prompts) or hot.pool.live or audit
            or any(len(r.nbest) != NBEST for r in done)):
        raise AssertionError(f"nbest_serve ({quant}) at temperature 0.8: "
                             f"{len(done)} requests, {hot.pool.live} pages "
                             f"live, audit {audit}")
    emit({"phase": "nbest_serve", "quant": quant, "temperature": 0.8,
          "requests": len(prompts), "n_best": NBEST,
          "identical_to_plain_at_temperature_0": True,
          "forks": hot.summary()["forks"],
          **{name.strip("_") + "_calls": {
              "calls": len(rows),
              "host_ms_per_call": sum(h for h, _ in rows) / max(len(rows), 1),
              "device_ms_per_call": sum(d for _, d in rows)
              / max(len(rows), 1)} for name, rows in calls.items()},
          "distinct_streams_per_group": [
              len({tuple(x) for x in r.nbest})
              for r in sorted(done, key=lambda r: r.uid)],
          "pool_pages_live": hot.pool.live})
    return launches


# phase 8e: phase 7's traffic under a seeded plan of every transient kind
# in its first CHAOS_TICKS ticks, a stall of STALL_MAG at STALL_AT (in the
# first wave's steady decode) and a spike of half the pool for SPIKE_TICKS
# ticks at SPIKE_AT (as the first wave finishes and the second admits),
# with the guard armed
CHAOS_TICKS, STALL_AT, SPIKE_AT, SPIKE_TICKS = 40, 50, 64, 4
ARMED_GUARD = dict(audit_interval=1, admit_max_retries=8, admit_backoff=1,
                   stall_factor=2.0)


def _chaos_plan(num_pages):
    from repro_torch.serve import (TRANSIENT_FAULT_KINDS, FaultEvent,
                                   FaultPlan)
    plan = FaultPlan.matrix(seed=SEED, n_ticks=CHAOS_TICKS,
                            kinds=TRANSIENT_FAULT_KINDS)
    return dataclasses.replace(plan, events=plan.events + (
        FaultEvent(tick=STALL_AT, kind="stall", magnitude=STALL_MAG),
        FaultEvent(tick=SPIKE_AT, kind="pool_spike",
                   magnitude=num_pages // 2, duration=SPIKE_TICKS)))


def _host_timed(eng, name):
    """Replace the engine's method ``name`` by one that records each call's
    (host seconds, return value); returns the list they go to. ``del
    eng.<name>`` puts the class's method back."""
    method, calls = getattr(eng, name), []

    def timed(*args, **kw):
        t0 = time.monotonic()
        out = method(*args, **kw)
        calls.append((time.monotonic() - t0, out))
        return out
    setattr(eng, name, timed)
    return calls


def phase_chaos_serve(cfg, params, quant, plain):
    """Phase 8e on the bf16 weights in one mode: phase 7's traffic under
    ``_chaos_plan`` with ``ARMED_GUARD``. Asserted (``_serve_run`` and
    here): every request finished or shed, K2 = decode ticks x 16, K3 =
    extend calls x 16 (K4 in int8), a clean pool and audit, no audit
    failure, at least one compaction pause and two readback retries.
    Reported: the streams' agreement with phase 7's (``plain``: its
    streams and summary; bf16 near ties may flip a greedy token after a
    quarantined slot's retry), host ms a tick against phase 7's, the
    recovery J/token and the auditor's host ms a tick. Returns the
    launches."""
    from repro_torch.serve import (GuardrailConfig, ServeEngine,
                                   generation_agreement)
    acct = _accountant()
    scfg = _paged_scfg(quant)
    pages = scfg.max_slots * -(-scfg.max_len // PAGE)
    eng = ServeEngine(params, cfg, dataclasses.replace(
        scfg, faults=_chaos_plan(pages),
        guard=GuardrailConfig(**ARMED_GUARD)), accountant=acct)
    audit_s = _host_timed(eng, "_run_audit")
    launches, streams, s = _serve_run("chaos_serve", eng, acct,
                                      _paged_traffic(cfg), 64)
    if not (s["audit_failures"] == 0 and s["compaction_pauses"] >= 1
            and s["readback_retries"] >= 2):
        raise AssertionError(
            f"chaos_serve ({quant}): audit failures {s['audit_failures']}, "
            f"compaction pauses {s['compaction_pauses']}, readback retries "
            f"{s['readback_retries']}")
    base_streams, base = plain
    emit({"phase": "chaos_serve_report", "quant": quant,
          "faults": [[e.tick, e.kind, e.magnitude]
                     for e in eng.scfg.faults.events],
          "faults_injected": s["faults_injected"],
          "quarantined": s["quarantined"], "shed": s["shed"],
          "readback_retries": s["readback_retries"],
          "compaction_pauses": s["compaction_pauses"],
          "degraded_ticks": s["degraded_ticks"],
          "recovery_tokens": s["recovery_tokens"],
          "recovery_j_per_token": s["recovery_j_per_token"],
          "ticks": s["ticks"], "phase7_ticks": base["ticks"],
          "host_ms_per_tick": 1e3 * s["wall_s"] / s["ticks"],
          "phase7_host_ms_per_tick": 1e3 * base["wall_s"] / base["ticks"],
          "audit_host_ms_per_tick": 1e3 * sum(sec for sec, _ in audit_s)
          / max(len(audit_s), 1),
          "audits": len(audit_s),
          "agreement_with_phase7": {
              **generation_agreement(streams, base_streams),
              "first_difference": _first_diff(streams, base_streams)}})
    return launches


def phase_chaos_spec(cfg, params):
    """Phase 8e's speculative run: 8b's traffic (unquantized, k = 4) with
    the spec-k backoff armed (threshold 0.9, window 2): at least one
    backoff, K5 = spec ticks x 16 (``_serve_run``). Returns the
    launches."""
    from repro_torch.serve import GuardrailConfig, ServeEngine
    acct = _accountant()
    eng = ServeEngine(params, cfg, _paged_scfg(
        "none", spec_k=SPEC_K, guard=GuardrailConfig(
            spec_backoff_threshold=0.9, spec_backoff_window=2)),
        accountant=acct)
    launches, _, s = _serve_run("chaos_spec_serve", eng, acct,
                                _paged_traffic(cfg), 64)
    if s["spec_backoffs"] < 1:
        raise AssertionError(f"chaos_spec_serve: no spec-k backoff "
                             f"(accept rate {s['accept_rate']})")
    emit({"phase": "chaos_spec_report", "spec_backoffs": s["spec_backoffs"],
          "spec_k_current": s["spec_k_current"],
          "degraded_ticks": s["degraded_ticks"],
          "accept_rate": s["accept_rate"],
          "accepted_tokens_per_tick": s["accepted_tokens_per_tick"]})
    return launches


def phase_forced_fallback(cfg, params):
    """The int8 -> fp fallback at full width: an int8 engine built from the
    bf16 params (quantized at construction; the bf16 pair is its fp
    oracle) on phase 7's first 8 requests x NBEST_NEW tokens, with
    ``_fallback_to_fp()`` forced before tick 3. Every request completes
    with its budget and the pool drains clean; K2 and K3 ran on their
    tensor cores before (bf16 q over the int8 pool) and on SIMT after (bf16
    q over the fp32 pool), K4 not at all after. The counters stay
    cumulative; the deltas are read around the fallback. Reports its
    host seconds."""
    import torch
    from repro_torch.serve import ServeEngine
    names = ("paged_decode_attention", "paged_prefill_attention",
             "int8_matmul")
    counters = _counters()

    def snap():
        torch.cuda.synchronize()
        return {n: dict(counters[n].launches_by_kernel) for n in names}

    def delta(a, b):
        return {n: {k: b[n][k] - a[n][k] for k in b[n]} for n in names}

    eng = ServeEngine(params, cfg, _paged_scfg("int8"))
    prompts = _paged_traffic(cfg)[:8]
    for p in prompts:
        eng.submit(p, max_tokens=NBEST_NEW)
    s0 = snap()
    for _ in range(3):
        eng.step()
    s1 = snap()
    t0 = time.monotonic()
    eng._fallback_to_fp()
    torch.cuda.synchronize()
    fallback_s = time.monotonic() - t0
    done = eng.run_until_drained()
    s2 = snap()
    before, after = delta(s0, s1), delta(s1, s2)
    k2b, k3b = before["paged_decode_attention"], before[
        "paged_prefill_attention"]
    k2a, k3a = after["paged_decode_attention"], after[
        "paged_prefill_attention"]
    if not (len(done) == len(prompts)
            and all(len(r.generated) == NBEST_NEW for r in done)
            and eng.fp_fallbacks == 1 and not eng.pool.live
            and not eng.pool.audit()
            and k2b["tensor_cores"] > 0 and k2b["simt"] == 0
            and k3b["tensor_cores"] > 0 and k3b["simt"] == 0
            and k2a["tensor_cores"] == 0 and k2a["simt"] > 0
            and k3a["tensor_cores"] == 0 and k3a["simt"] > 0
            and sum(before["int8_matmul"].values()) > 0
            and sum(after["int8_matmul"].values()) == 0):
        raise AssertionError(
            f"forced fallback: {len(done)} requests, lengths "
            f"{[len(r.generated) for r in done]}, fallbacks "
            f"{eng.fp_fallbacks}, {eng.pool.live} pages live; launches "
            f"before {before}, after {after}")
    emit({"phase": "chaos_fallback", "dtype": "bfloat16",
          "requests": len(prompts), "new_tokens_each": NBEST_NEW,
          "fallback_tick": 3, "fallback_host_s": fallback_s,
          "launches_before": before, "launches_after": after,
          "ticks": eng.summary()["ticks"],
          "degraded_ticks": eng.summary()["degraded_ticks"],
          "recovery_tokens": eng.summary()["recovery_tokens"]})


# phase 8f: the first life snapshots every EARLY_INTERVAL ticks and dies at
# EARLY_KILL, so the snapshot its restore loads is one of the first
# chunked prefills (phase 7's traffic has slots mid-prefill at ticks 1-3
# and at no later snapshot tick); the second snapshots every
# SERVE_INTERVAL ticks and dies at SERVE_KILL, SERVE_KILL - SERVE_INTERVAL
# ticks past its last snapshot; the third journals only (its snapshots,
# 6 s each at the fp32 pool, are cut to keep the phase short)
EARLY_INTERVAL, EARLY_KILL, SERVE_INTERVAL, SERVE_KILL = 2, 3, 32, 40


def phase_durability_serve(cfg, params, quant, plain):
    """Phase 8f on the bf16 weights in one mode: phase 7's traffic on a
    durable paged engine killed twice (``process_kill`` at EARLY_KILL and
    SERVE_KILL), each time dropped and replaced by a fresh engine that
    restores from the directory (the last journals only, without
    snapshots): the snapshot the first restore loads
    holds slots mid-prefill and queued requests, the second replays
    SERVE_KILL - SERVE_INTERVAL ticks. Asserted: the streams phase 7's
    (``plain``; phase 8's paged int8 streams in the int8 mode), each
    restore's replayed ticks its kill tick minus its snapshot's tick,
    restore_j > 0, a clean pool and audit, and K2 = decode ticks x 16, K3
    = extend calls x 16 (K4 as in phase 8) over the ticks the three
    engines ran (pre-crash, replayed and after the restore). Reported: each
    snapshot's host seconds and GB, each restore's seconds split into
    loading and replay, the journal bytes, durability_write_j,
    restore_j_per_token and ``durability_overhead_bytes_per_tick`` at
    SERVE_INTERVAL. Returns the launches."""
    import shutil
    import tempfile
    import torch
    from repro_torch.core import energy
    from repro_torch.models import costing
    from repro_torch.serve import (FaultEvent, FaultPlan, ProcessKilled,
                                   ServeEngine)
    t_phase = time.monotonic()
    d = tempfile.mkdtemp(prefix="chip_smoke_serve_durable.")
    try:
        plan = FaultPlan(seed=SEED, events=(
            FaultEvent(tick=EARLY_KILL, kind="process_kill"),
            FaultEvent(tick=SERVE_KILL, kind="process_kill")))
        base = _paged_scfg(quant, checkpoint_dir=d, faults=plan)
        lives = [dataclasses.replace(base, checkpoint_interval=n)
                 for n in (EARLY_INTERVAL, SERVE_INTERVAL, 0)]
        acct = _accountant()
        prompts = _paged_traffic(cfg)
        eng = ServeEngine(params, cfg, lives[0], accountant=acct)
        for p in prompts:
            eng.submit(p, max_tokens=64)
        torch.cuda.synchronize()
        counters = _counters()
        for fn in counters.values():
            fn.launches = 0
        executed, snapshots, restores, done = [], [], [], {}
        start = 0
        for life in range(len(lives)):
            writes = _host_timed(eng, "_write_snapshot")
            try:
                for r in eng.run_until_drained():
                    done[r.uid] = list(r.generated)
                killed = False
            except ProcessKilled:
                killed = True
            torch.cuda.synchronize()
            executed += eng.metrics_log[start:]
            snapshots += [(sec, nbytes / 1e9) for sec, nbytes in writes]
            if not killed:
                break
            kill_tick = eng._tick_idx
            eng = None
            _free_device()
            eng = ServeEngine(params, cfg, lives[life + 1],
                              accountant=acct)
            step = eng._ckpt_mgr.latest_step()
            extra = eng._ckpt_mgr.peek_extra(step)
            replayed0 = eng.replayed_ticks
            recovered, rep = _timed_restore(eng)
            for r in recovered:
                done[r.uid] = list(r.generated)
            restores.append({
                "kill_tick": kill_tick, "snapshot_tick": step,
                "snapshot_prefilling_slots": len(extra["prefilling"]),
                "snapshot_queued": len(extra["queue"]),
                "replayed_ticks": eng.replayed_ticks - replayed0
                - extra["durability"]["replayed_ticks"], **rep})
            start = step
        s = eng.summary()
        first, second = restores if len(restores) == 2 else (None, None)
        decode_ticks = sum(1 for m in executed if m.active_slots > 0)
        extends = sum(1 for m in executed if m.prefill_tokens > 0)
        launches = {name: fn.launches for name, fn in counters.items()}
        want = {name: 0 for name in launches}
        want.update({"paged_decode_attention": decode_ticks * cfg.n_layers,
                     "paged_prefill_attention": extends * cfg.n_layers})
        if quant == "int8":
            want["int8_matmul"] = (decode_ticks + extends) * cfg.n_layers * 6
        live, audit, _ = _pool_state(eng)
        base_streams = plain[0]
        if not (first is not None and first["kill_tick"] == EARLY_KILL
                and first["snapshot_prefilling_slots"] > 0
                and first["snapshot_queued"] > 0
                and second["kill_tick"] == SERVE_KILL
                and second["snapshot_tick"] == SERVE_INTERVAL
                and all(r["replayed_ticks"] == r["kill_tick"]
                        - r["snapshot_tick"] for r in restores)
                and s["restore_j"] > 0 and done == base_streams
                and launches == want and not live and not audit):
            raise AssertionError(
                f"durability_serve ({quant}): restores {restores}, "
                f"restore_j {s['restore_j']}, streams equal "
                f"{done == base_streams} (first difference "
                f"{_first_diff(done, base_streams)}), launches {launches} "
                f"!= {want}, {live} pages live, audit {audit}")
        snap_gb = [gb for _, gb in snapshots]
        journal_file = (Path(d) / "journal.jsonl").stat().st_size
        journal_per_tick = journal_file / len(executed)
        emit({"phase": "durability_serve", "dtype": "bfloat16",
              "quant": quant, "cache": "int8" if quant == "int8"
              else "float32", "requests": len(prompts),
              "new_tokens_each": 64, "restores": restores,
              "snapshots": len(snapshots),
              "snapshot_s": [sec for sec, _ in snapshots],
              "snapshot_gb": snap_gb,
              "snapshot_gb_per_s": sum(snap_gb) / max(
                  sum(sec for sec, _ in snapshots), 1e-9),
              "journal_bytes": s["journal_bytes"],
              "journal_file_bytes": journal_file,
              # the summary bills the writes the restored state knew of (a
              # snapshot does not hold its own bytes, and the last engine
              # takes none); written_j bills every byte the three engines
              # put on disk
              "durability_write_j": s["durability_write_j"],
              "written_j": energy.dram_energy_j(1e9 * sum(snap_gb)
                                                + journal_file),
              "restore_j": s["restore_j"],
              "restore_j_per_token": s["restore_j_per_token"],
              "durability_overhead_bytes_per_tick":
                  costing.durability_overhead_bytes_per_tick(
                      1e9 * sum(snap_gb) / max(len(snap_gb), 1),
                      journal_per_tick, SERVE_INTERVAL),
              "expected_replay_ticks": costing.expected_replay_ticks(
                  SERVE_INTERVAL),
              "ticks": s["ticks"], "ticks_run": len(executed),
              "decode_ticks_run": decode_ticks, "extend_calls_run": extends,
              "launches": launches, "identical_to_phase7": True,
              "seconds": time.monotonic() - t_phase})
        return launches
    finally:
        shutil.rmtree(d, ignore_errors=True)


def phase_agreement(cfg, params, qparams):
    """Teacher-forced greedy agreement of the int8 model with the bf16 one
    at full width (reported, not asserted)."""
    import numpy as np
    from repro_torch.serve import token_agreement
    prompts = np.random.default_rng(SEED + 5).integers(0, cfg.vocab,
                                                       (8, 64))
    t0 = time.monotonic()
    res = token_agreement(params, cfg, prompts, 24, qparams=qparams)
    emit({"phase": "agreement", "prompts": 8, "prompt_len": 64,
          "new_tokens": 24, **res, "seconds": time.monotonic() - t0})


# gemma3-27b at full width (d_model 5376, 32 query heads on 16 KV heads of
# 168, d_ff 21504 gated GELU, vocab 262144) cut to 14 of its 62 layers:
# two repeats of its 6-layer pattern (5 local layers of window 1024, one
# global) and its 2-layer local tail, so every layer kind runs, each
# pattern position at two depths; fp32 params are 29.9 GB.
# 4 requests of 1100-1501 prompt tokens (past the window, whose start then
# falls inside a page and a split), 16 greedy tokens each, on 4 slots
G3_REPEATS = 2
G3_PROMPTS = (1100, 1237, 1389, 1501)
G3_NEW = 16
G3_MAX_LEN = 1536


def phase_gemma3():
    """gemma3-27b's serve paths at full width, 14 layers: in fp32 the dense
    engine (K1), the paged engine with chunked prefill (K2, K3; pages of
    16, chunks of 256) and the speculative one (K5, ``spec_k=4``) must give
    the same greedy streams token for token; then bf16 weights (the same
    draws rounded) on the paged engine, unquantized and int8 (K4 at
    gemma3's shapes), report their agreement with the fp32 streams. Each
    run's kernel launches are checked by ``_serve_run`` (every layer, on
    the kernel its route names: SIMT at D = 168). Returns the runs'
    launches."""
    import numpy as np
    import torch
    from repro_torch.configs import gemma3_27b
    from repro_torch.kernels import paged_decode_attention as k2
    from repro_torch.models import costing
    from repro_torch.models import transformer as tf_lib
    from repro_torch.serve import (ServeConfig, ServeEngine,
                                   generation_agreement)
    t_start = time.monotonic()
    cfg = dataclasses.replace(gemma3_27b.make_config(), repeats=G3_REPEATS)
    shape = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
             cfg.resolved_head_dim, cfg.d_ff, cfg.vocab)
    if shape != (14, 5376, 32, 16, 168, 21504, 262144):
        raise AssertionError(f"gemma3-27b is not at full width: {shape}")
    kinds = [sp.window for sp in cfg.pattern + cfg.tail]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cap = G3_MAX_LEN // PAGE * PAGE
    split = k2.split_plan(cap, PAGE, len(G3_PROMPTS) * cfg.n_kv_heads, sms,
                          G3_WINDOW)[0]
    # the window's start at each decode tick's query (position n + i)
    starts = [n + i + 1 - G3_WINDOW for n in G3_PROMPTS
              for i in range(G3_NEW - 1)]
    in_page = sum(1 for x in starts if x % PAGE)
    in_split = sum(1 for x in starts if x % split)
    if min(starts) <= 0 or not (in_page and in_split):
        raise AssertionError(f"gemma3's window does not bite inside a page "
                             f"and a split: starts {starts}, split {split}")
    rng = np.random.default_rng(SEED + 11)
    prompts = [rng.integers(0, cfg.vocab, n) for n in G3_PROMPTS]
    t0 = time.monotonic()
    params = tf_lib.init_lm(cfg, seed=SEED, dtype=torch.float32,
                            device="cuda")
    init_s = time.monotonic() - t0
    dense_cfg = ServeConfig(max_slots=len(prompts), max_len=G3_MAX_LEN,
                            device="cuda")
    paged_cfg = dataclasses.replace(dense_cfg, paged=True, page_size=PAGE,
                                    prefill_chunk=256, prefix_cache=False)
    runs, streams, seconds = [], {}, {}
    for name, scfg in (("dense", dense_cfg), ("paged", paged_cfg),
                       ("spec", dataclasses.replace(paged_cfg,
                                                    spec_k=SPEC_K))):
        t0 = time.monotonic()
        acct = _accountant()
        launches, streams[name], _ = _serve_run(
            f"gemma3_{name}", ServeEngine(params, cfg, scfg,
                                          accountant=acct),
            acct, prompts, G3_NEW, hits=False)
        runs.append(launches)
        seconds[name] = time.monotonic() - t0
    if not streams["dense"] == streams["paged"] == streams["spec"]:
        raise AssertionError(
            f"gemma3-27b fp32 streams differ: dense {streams['dense']}, "
            f"paged {streams['paged']}, spec {streams['spec']}; first "
            f"difference paged {_first_diff(streams['paged'], streams['dense'])}"
            f", spec {_first_diff(streams['spec'], streams['dense'])}")
    param_gb = costing.tree_bytes(params) / 1e9
    del params
    gc.collect()
    torch.cuda.empty_cache()
    bparams = tf_lib.init_lm(cfg, seed=SEED, dtype=torch.bfloat16,
                             device="cuda")
    agreement = {}
    for quant in ("none", "int8"):
        t0 = time.monotonic()
        label = "bf16" if quant == "none" else "int8"
        acct = _accountant()
        launches, got, _ = _serve_run(
            f"gemma3_paged_{label}", ServeEngine(
                bparams, cfg, dataclasses.replace(paged_cfg, quant=quant),
                accountant=acct), acct, prompts, G3_NEW, hits=False)
        runs.append(launches)
        agreement[label] = generation_agreement(got, streams["paged"])
        seconds[f"paged_{label}"] = time.monotonic() - t0
    del bparams
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "gemma3", "layers": cfg.n_layers, "windows": kinds,
          "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
          "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab, "param_gb_fp32": param_gb, "init_s": init_s,
          "prompts": list(G3_PROMPTS), "new_tokens_each": G3_NEW,
          "window_starts_inside_a_page": in_page,
          "window_starts_inside_a_split": in_split, "split": split,
          "fp32_dense_paged_spec_identical": True,
          "streams_fp32": {str(u): v for u, v in streams["dense"].items()},
          "agreement_with_fp32": agreement, "run_seconds": seconds,
          "seconds": time.monotonic() - t_start})
    return runs


# granite-34b (48 query heads on one KV head: MQA), qwen1.5-110b (QKV
# bias, untied head) and qwen2-vl-72b (M-RoPE, its text tokens on three
# equal position streams) at full width, cut to 2 layers (two repeats of
# their one-layer pattern), bf16 weights from SEED: 4 requests of
# 100-400 prompt tokens, 16 greedy tokens each, on the paged path (K2,
# K3), 4 slots, pages of 16, chunks of 256
FAMILY = ("granite-34b", "qwen1.5-110b", "qwen2-vl-72b")
FAMILY_REPEATS = 2


def phase_family_serve():
    """The rest of the dense family at full width, 2 layers, bf16, through
    the paged engine: each run's streams (every request its 16 tokens) and
    kernel launches (``_serve_run``). Returns the runs' launches."""
    import numpy as np
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import costing
    from repro_torch.models import transformer as tf_lib
    from repro_torch.serve import ServeConfig, ServeEngine
    runs = []
    for arch in FAMILY:
        t0 = time.monotonic()
        cfg = dataclasses.replace(cfgbase.get(arch).make_config(),
                                  repeats=FAMILY_REPEATS)
        params = tf_lib.init_lm(cfg, seed=SEED, dtype=torch.bfloat16,
                                device="cuda")
        rng = np.random.default_rng(SEED + 12)
        prompts = [rng.integers(0, cfg.vocab, int(rng.integers(100, 401)))
                   for _ in range(4)]
        acct = _accountant()
        eng = ServeEngine(params, cfg, ServeConfig(
            max_slots=4, max_len=512, device="cuda", paged=True,
            page_size=PAGE, prefill_chunk=256, prefix_cache=False),
            accountant=acct)
        launches, streams, _ = _serve_run(f"family_{arch}", eng, acct,
                                          prompts, 16, hits=False)
        runs.append(launches)
        emit({"phase": "family", "arch": arch, "layers": cfg.n_layers,
              "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
              "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
              "vocab": cfg.vocab, "pos_emb": cfg.pos_emb,
              "qkv_bias": cfg.qkv_bias, "tied": cfg.tie_embeddings,
              "param_gb": costing.tree_bytes(params) / 1e9,
              "prompt_lens": [len(p) for p in prompts],
              "streams": {str(u): v for u, v in streams.items()},
              "seconds": time.monotonic() - t0})
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()
    return runs


# The MoE family: moonshot-v1-16b-a3b (64 experts, top-6, d 2048, expert
# d_ff 1408, 16/16 heads of 128) and kimi-k2-1t-a32b (384 experts, top-8,
# d 7168, expert d_ff 2048, 64/8 heads of 112). The layer at full width
# runs 4096 tokens (one group of moe_group_size) and a decode-sized call
# of 8; moonshot's fp32 streams run 16 of its 48 layers (37.9 GB) with the
# capacity factor raised to n_experts / top_k, rounded up, where no route
# can drop; its bf16 and int8 runs the published factor (1.25), at 16
# layers (agreement with the fp32 streams) and at full depth (55.4 GB of
# bf16; the int8 tree quantized leaf by leaf, so the two never coexist
# whole); kimi-k2 one layer in bf16 (36.4 GB), paged and speculative
MOE_ARCHS = ("moonshot-v1-16b-a3b", "kimi-k2-1t-a32b")
MOE_LAYER_TOKENS = (4096, 8)
MOE_SHARED = 0.1
MOE_FP32_REPEATS = 16
MOE_PROMPTS = (211, 298, 377, 460)
MOE_NEW = 16
MOE_FULL_SLOTS = 8
MOE_FULL_NEW = 24


def _moe_tol(mcfg):
    """The fp32 bound between two computations of one MoE layer at full
    width: tests/test_moe.py's 2e-5 at d = 32 (smoke scale), grown with
    the square root of the contraction depth, as the rounding of a sum of
    d fp32 products grows: 1.6e-4 at moonshot's d of 2048, 3.0e-4 at
    kimi-k2's 7168. The two sides differ in the row counts of their
    products (cuBLAS picks its kernels by shape) and in the zero terms
    the reference adds, never in the routes."""
    return 2e-5 * math.sqrt(mcfg.d_model / 32)


def _host_drops(ids, n_experts, tg, cap):
    """The reference's first-come drops recounted on the host from
    read-back ids (T, k): per group of ``tg`` tokens, token by token and
    route by route, a route is dropped once its expert already holds
    ``cap`` earlier routes."""
    import numpy as np
    out = np.zeros(ids.shape, bool)
    for g0 in range(0, ids.shape[0], tg):
        seen = np.zeros(n_experts, np.int64)
        for t in range(g0, g0 + tg):
            for j, e in enumerate(ids[t]):
                out[t, j] = seen[e] >= cap
                seen[e] += 1
    return out


def _route_sum(p, mcfg, x2d, gates, ids, kept):
    """The MoE output as a per-route fp32 sum: for each expert in
    ascending id, its FFN over exactly the tokens of its kept routes, each
    token adding gate * output (an index walk over the read-back routes,
    no slot buffer and no capacity)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    y = torch.zeros_like(x2d, dtype=torch.float32)
    for e in range(mcfg.n_experts):
        t_idx, j_idx = np.nonzero((ids == e) & kept)
        if not len(t_idx):
            continue
        rows = torch.from_numpy(t_idx).to(x2d.device)
        xe = x2d[rows]
        h = xe @ p["w_in"][e]
        ye = (F.silu(xe @ p["w_gate"][e]) * h) @ p["w_out"][e]
        g = gates[rows, torch.from_numpy(j_idx).to(x2d.device)]
        y.index_add_(0, rows, g[:, None] * ye)
    return y


def _moe_layer(arch):
    """One MoE layer of ``arch`` at full width, fp32, random weights from
    SEED: at 4096 tokens and at 8, ``moe_capacity`` at a capacity factor
    computed from the routes so that none drops equals ``moe_dense``
    within ``_moe_tol``; at the published factor its dropped routes equal
    the host recount route for route (some drop at 4096) and its output
    the per-route fp32 sum over the kept routes."""
    import numpy as np
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import moe
    t0 = time.monotonic()
    cfg = cfgbase.get(arch).make_config()
    mcfg, group = cfg.moe_cfg, cfg.moe_group_size
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    p = moe.init_moe(mcfg, generator=gen, device=torch.device("cuda"),
                     dtype=torch.float32)
    tol = _moe_tol(mcfg)
    # every token shares one direction of 0.1 standard deviations, as a
    # model's hidden states share a common component: the routes skew, and
    # at the published factor some drop (iid inputs spread them so evenly
    # that moonshot's 4096 tokens drop none)
    shared = MOE_SHARED * torch.randn((mcfg.d_model,), generator=gen,
                                      device="cuda")
    rows = []
    for n_tok in MOE_LAYER_TOKENS:
        x = torch.randn((1, n_tok, mcfg.d_model), generator=gen,
                        device="cuda") + shared
        x2d = x[0]
        gates, ids, _ = moe.route(p, mcfg, x2d)
        ids_h = ids.cpu().numpy()
        tg = n_tok // max(n_tok // group, 1)
        load = max(int(np.bincount(ids_h[g0:g0 + tg].ravel(),
                                   minlength=mcfg.n_experts).max())
                   for g0 in range(0, n_tok, tg))
        ample = dataclasses.replace(
            mcfg, capacity_factor=(load + 1) * mcfg.n_experts
            / (tg * mcfg.top_k))
        if _host_drops(ids_h, mcfg.n_experts, tg, ample.capacity(tg)).any():
            raise AssertionError(f"{arch}: the ample capacity drops routes")
        torch.cuda.synchronize()
        t1 = time.monotonic()
        y_cap, aux_cap = moe.moe_capacity(p, ample, x, group)
        torch.cuda.synchronize()
        cap_s = time.monotonic() - t1
        t1 = time.monotonic()
        y_dense, aux_dense = moe.moe_dense(p, ample, x)
        torch.cuda.synchronize()
        dense_s = time.monotonic() - t1
        err_dense = float((y_cap - y_dense).abs().max())
        cap = mcfg.capacity(tg)
        want = _host_drops(ids_h, mcfg.n_experts, tg, cap)
        got = moe.dropped_routes(mcfg, ids, group).cpu().numpy()
        y_pub, _ = moe.moe_capacity(p, mcfg, x, group)
        y_ref = _route_sum(p, mcfg, x2d, gates, ids_h, ~want)
        err_routes = float((y_pub[0] - y_ref).abs().max())
        row = {"tokens": n_tok, "group": tg, "max_load": load,
               "ample_capacity": ample.capacity(tg),
               "capacity_1.25": cap, "dropped_1.25": int(want.sum()),
               "routes": int(want.size),
               "max_abs_err_vs_dense": err_dense,
               "max_abs_err_vs_route_sum": err_routes, "tol": tol,
               "y_max_abs": float(y_dense.abs().max()),
               "aux": float(aux_cap), "capacity_ms": 1e3 * cap_s,
               "dense_ms": 1e3 * dense_s}
        rows.append(row)
        if not (err_dense <= tol and err_routes <= tol
                and abs(float(aux_cap) - float(aux_dense)) <= 1e-6
                and np.array_equal(got, want)
                and bool(torch.isfinite(y_pub).all())
                and (n_tok < 4096 or want.any())):
            raise AssertionError(f"{arch} MoE layer at {n_tok} tokens: "
                                 f"{row}, device drops equal the host "
                                 f"recount: {np.array_equal(got, want)}")
        del x, x2d, y_cap, y_dense, y_pub, y_ref
    emit({"phase": "moe_layer", "arch": arch, "shared_std": MOE_SHARED,
          "d_model": mcfg.d_model,
          "d_ff": mcfg.d_ff, "experts": mcfg.n_experts, "top_k": mcfg.top_k,
          "param_gb_fp32": sum(t.numel() for t in p.values()) * 4 / 1e9,
          "rows": rows, "seconds": time.monotonic() - t0})
    del p
    gc.collect()
    torch.cuda.empty_cache()


class _DropCount:
    """Counts the routes ``moe_capacity`` drops while it is entered (the
    count runs its own ``route``, outside the model's arithmetic)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.dropped = self.routes = 0
        self._orig = moe.moe_capacity

        def counted(p, cfg, x, group_size=4096):
            _, ids, _ = moe.route(p, cfg, x.reshape(-1, x.shape[-1]))
            self.dropped += int(moe.dropped_routes(cfg, ids,
                                                   group_size).sum())
            self.routes += ids.numel()
            return self._orig(p, cfg, x, group_size)

        moe.moe_capacity = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.moe_capacity = self._orig


def _quantize_in_place(params):
    """``quantize_lm`` one leaf at a time, each bf16 leaf dropped once its
    int8 leaf exists: the peak is the bf16 tree plus one int8 leaf, where
    the whole call would hold both trees (83 GB at moonshot's full
    depth). The codes and scales are quantize_lm's."""
    from repro_torch.models import transformer as tf_lib
    from repro_torch.quant.int8 import SERVING_QUANT_KEYS

    def walk(top, d, path):
        for k in list(d):
            v = d[k]
            if isinstance(v, dict):
                if "q8" not in v:
                    walk(top, v, path + (k,))
            elif k in SERVING_QUANT_KEYS:
                tree = v
                for key in reversed(path + (k,)):
                    tree = {key: tree}
                q = tf_lib.quantize_lm({top: tree})[top]
                for key in path + (k,):
                    q = q[key]
                d[k] = q
                del v, tree

    for top, group in params.items():
        if top.startswith(("pat", "tail")):
            walk(top, group, ())
    return params


def phase_moe():
    """The MoE family on the serve paths at full width (see MOE_ARCHS'
    comment): the layer checks, moonshot's fp32 dense, paged and
    speculative (k = 4) streams identical with no route dropped, its bf16
    and int8 paged runs at 16 layers (agreement with the fp32 streams) and
    at full depth (8 slots; host ms a decode tick, peak memory, launches,
    and 3 bf16 decode ticks profiled), kimi-k2's one layer in bf16, paged
    and speculative (K2, K3 and K5 on SIMT at D 112). Every run's kernel
    calls are checked by ``_serve_run``. Returns the runs' launches."""
    import numpy as np
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import costing
    from repro_torch.models import transformer as tf_lib
    from repro_torch.serve import (ServeConfig, ServeEngine,
                                   generation_agreement)
    t_start = time.monotonic()
    for arch in MOE_ARCHS:
        _moe_layer(arch)
    runs, seconds, report = [], {}, {}
    base = cfgbase.get("moonshot-v1-16b-a3b").make_config()
    m = base.moe_cfg
    rng = np.random.default_rng(SEED + 13)
    prompts = [rng.integers(0, base.vocab, n) for n in MOE_PROMPTS]
    max_len = 512
    dense_cfg = ServeConfig(max_slots=len(prompts), max_len=max_len,
                            device="cuda")
    paged_cfg = dataclasses.replace(dense_cfg, paged=True, page_size=PAGE,
                                    prefill_chunk=256, prefix_cache=False)
    # fp32, 16 layers, a capacity at which no route can drop
    cfg = dataclasses.replace(
        base, repeats=MOE_FP32_REPEATS, moe_cfg=dataclasses.replace(
            m, capacity_factor=float(math.ceil(m.n_experts / m.top_k))))
    params = tf_lib.init_lm(cfg, seed=SEED, dtype=torch.float32,
                            device="cuda")
    report["param_gb_fp32_16_layers"] = costing.tree_bytes(params) / 1e9
    streams = {}
    with _DropCount() as drops:
        for name, scfg in (("dense", dense_cfg), ("paged", paged_cfg),
                           ("spec", dataclasses.replace(paged_cfg,
                                                        spec_k=SPEC_K))):
            t0 = time.monotonic()
            acct = _accountant()
            launches, streams[name], _ = _serve_run(
                f"moe_fp32_{name}", ServeEngine(params, cfg, scfg,
                                                accountant=acct),
                acct, prompts, MOE_NEW, hits=False)
            runs.append(launches)
            seconds[f"fp32_{name}"] = time.monotonic() - t0
    if drops.dropped or not drops.routes:
        raise AssertionError(f"moonshot fp32: {drops.dropped} of "
                             f"{drops.routes} routes dropped")
    if not streams["dense"] == streams["paged"] == streams["spec"]:
        raise AssertionError(
            f"moonshot fp32 streams differ: dense {streams['dense']}, "
            f"paged {streams['paged']}, spec {streams['spec']}; first "
            f"difference paged "
            f"{_first_diff(streams['paged'], streams['dense'])}, spec "
            f"{_first_diff(streams['spec'], streams['dense'])}")
    report["fp32_routes"] = drops.routes
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # bf16 and int8 at the published capacity factor: 16 layers (the same
    # draws rounded; agreement with the fp32 streams), then full depth
    agreement = {}
    for depth in (MOE_FP32_REPEATS, base.repeats):
        cfg = dataclasses.replace(base, repeats=depth)
        params = tf_lib.init_lm(cfg, seed=SEED, dtype=torch.bfloat16,
                                device="cuda")
        report[f"param_gb_bf16_{depth}_layers"] = (
            costing.tree_bytes(params) / 1e9)
        full = depth == base.repeats
        scfg = (dataclasses.replace(paged_cfg, max_slots=MOE_FULL_SLOTS)
                if full else paged_cfg)
        traffic = ([rng.integers(0, base.vocab, int(rng.integers(100, 501)))
                    for _ in range(MOE_FULL_SLOTS)] if full else prompts)
        n_new = MOE_FULL_NEW if full else MOE_NEW
        for quant in ("none", "int8"):
            label = f"{'bf16' if quant == 'none' else 'int8'}_{depth}"
            if quant == "int8":
                cfg = dataclasses.replace(cfg, quant=tf_lib.INT8_QUANT)
                gc.collect()
                torch.cuda.empty_cache()
                t0 = time.monotonic()
                params = _quantize_in_place(params)
                torch.cuda.synchronize()
                report[f"quantize_s_{depth}"] = time.monotonic() - t0
                report[f"param_gb_int8_{depth}_layers"] = (
                    costing.tree_bytes(params) / 1e9)
            t0 = time.monotonic()
            acct = _accountant()
            qcfg = dataclasses.replace(scfg, quant=quant)
            # the 16-layer runs count the dropped routes (the count's own
            # routing and reads add host time); the full-depth runs are
            # the timed ones, each with 3 decode ticks profiled
            counter = contextlib.nullcontext() if full else _DropCount()
            with counter as drops:
                launches, got, _ = _serve_run(
                    f"moe_paged_{label}", ServeEngine(
                        params, cfg, qcfg, accountant=acct), acct, traffic,
                    n_new, hits=False)
            runs.append(launches)
            seconds[f"paged_{label}"] = time.monotonic() - t0
            if full:
                report[f"profile_{label}"] = _profile_serve_ticks(
                    params, cfg, qcfg, traffic, n_new)
            else:
                report[f"dropped_{label}"] = [drops.dropped, drops.routes]
                agreement[label] = generation_agreement(got, streams["paged"])
        del params
        gc.collect()
        torch.cuda.empty_cache()
    # kimi-k2 at full width, one layer, bf16: paged and speculative, and
    # paged over a bf16 cache (K3 on its tensor cores at D 112)
    kcfg = dataclasses.replace(cfgbase.get("kimi-k2-1t-a32b").make_config(),
                               repeats=1)
    kparams = tf_lib.init_lm(kcfg, seed=SEED, dtype=torch.bfloat16,
                             device="cuda")
    report["param_gb_bf16_kimi_1_layer"] = costing.tree_bytes(kparams) / 1e9
    kprompts = [rng.integers(0, kcfg.vocab, n) for n in MOE_PROMPTS]
    kstreams = {}
    for name, scfg in (("paged", paged_cfg),
                       ("spec", dataclasses.replace(paged_cfg,
                                                    spec_k=SPEC_K)),
                       ("paged_bf16_cache", dataclasses.replace(
                           paged_cfg, cache_dtype=torch.bfloat16))):
        t0 = time.monotonic()
        acct = _accountant()
        launches, kstreams[name], _ = _serve_run(
            f"moe_kimi_{name}", ServeEngine(kparams, kcfg, scfg,
                                            accountant=acct),
            acct, kprompts, MOE_NEW, hits=False)
        runs.append(launches)
        seconds[f"kimi_{name}"] = time.monotonic() - t0
    report["profile_kimi_paged"] = _profile_serve_ticks(
        kparams, kcfg, paged_cfg, kprompts, MOE_NEW)
    del kparams
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "moe", "fp32_layers": MOE_FP32_REPEATS,
          "fp32_capacity_factor": float(math.ceil(m.n_experts / m.top_k)),
          "prompts": list(MOE_PROMPTS), "new_tokens_each": MOE_NEW,
          "fp32_dense_paged_spec_identical": True,
          "streams_fp32": {str(u): v for u, v in streams["dense"].items()},
          "agreement_with_fp32": agreement,
          "kimi_paged_spec_agreement": generation_agreement(
              kstreams["spec"], kstreams["paged"]),
          "kimi_bf16_cache_agreement": generation_agreement(
              kstreams["paged_bf16_cache"], kstreams["paged"]),
          **report, "run_seconds": seconds,
          "seconds": time.monotonic() - t_start})
    return runs


SSM_ARCHS = ("mamba2-1.3b", "zamba2-7b")
# 8 slots, max_len 2048: 4 prompts of 512 tokens and 4 of 301, alternating,
# so the first admission prefills the 512s together and sends the 301s
# back to the queue (equal-length groups: an SSM state integrates padding)
SSM_PROMPTS = (512, 301) * 4
SSM_NEW = 24
SSM_SLOTS = 8
# one mamba2 layer's scan at full shapes, chunked against naive (B, S)
SSD_SCAN = (2, 1024)
# zamba2-7b's heads at full width (32 query heads on 32 KV heads of 112)
ZAMBA2_HEADS = (32, 32, 112)


def _ssd_scan_tol(y_max):
    """The chunked scan against the naive recurrence: tests/test_ssd.py's
    2e-4, relative to the largest value once it exceeds 1 (both sides
    fp32, TF32 off; the chunked form sums 256-term products in another
    order than the 1024-step recurrence)."""
    return 2e-4 * max(1.0, y_max)


def _live_ssd_conv(params):
    """``conv_b``/``conv_c`` of every SSD group drawn N(0, 0.2) from SEED,
    in place: ``init_lm`` leaves them at zero, as the reference's does,
    which makes B and C silu(0) = 0 and every SSM state 0 (only the D
    skip and ``conv_x`` would carry signal). fp32 draws, cast to the
    params' dtype, so bf16 params get the fp32 draws rounded."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for key in sorted(params):
        group = params[key]
        if isinstance(group, dict) and "ssd" in group:
            for name in ("conv_b", "conv_c"):
                t = group["ssd"][name]
                t.copy_(0.2 * torch.randn(t.shape, generator=gen,
                                          device="cuda"))
    return params


def _ssm_state_max(eng):
    """The largest |value| of any SSM state in an engine's caches."""
    return max(float(e["ssd"].ssm.abs().max())
               for e in eng.state.caches.values() if "ssd" in e)


def phase_kernels_zamba2():
    """K1 at zamba2-7b's heads (32 on 32 KV heads of 112: a group of one,
    unlike kimi-k2's 8), no window, in the two serve modes, checked and
    timed as ``kernels_d112``. Returns its MAIN_INT8 row."""
    import torch
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import ref
    t0 = time.monotonic()
    rows = _check_kernel(
        "decode_attention", k1.decode_attention, ref.decode_attention_ref,
        _library_decode, lambda q, kv: _decode_inputs(q, kv, ZAMBA2_HEADS),
        lambda a, w: _decode_bound(a[0], a[1], a[3], w),
        dead=torch.tensor(LENGTHS) == 0, iters=48, kv_pos=(1, 2),
        device_time=True, route=_k25_route(), modes=G3_MODES,
        windows=(-1,), cold=(1, 2))
    emit({"phase": "kernels_zamba2", "heads": list(ZAMBA2_HEADS),
          "seconds": time.monotonic() - t0})
    return rows[MAIN_INT8]


def _ssd_scan_check(cfg, params):
    """Layer 0 of mamba2 at full shapes: its projections of N(0, 1)
    hidden states (B, S = SSD_SCAN) through its convs, dt and A, then
    ``ssd_chunked`` against ``ssd_naive`` on those inputs, fp32."""
    import torch
    from repro_torch.models import layers, ssd
    t0 = time.monotonic()
    scfg = cfg.ssd_cfg
    p = {k: v[0] for k, v in params["pat0"]["ssd"].items()
         if isinstance(v, torch.Tensor)}
    norm = {"scale": params["pat0"]["norm_ssd"]["scale"][0]}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 29)
    x = torch.randn(SSD_SCAN + (cfg.d_model,), generator=gen, device="cuda")
    _, xin, b_raw, c_raw, dt_raw = ssd._projections(
        p, scfg, layers.rms_norm(norm, x))
    xin = ssd.silu(ssd._causal_dwconv(xin, p["conv_x"]))
    bm = ssd._expand_groups(ssd.silu(ssd._causal_dwconv(
        b_raw, p["conv_b"])), scfg.n_heads)
    cm = ssd._expand_groups(ssd.silu(ssd._causal_dwconv(
        c_raw, p["conv_c"])), scfg.n_heads)
    dt, a = ssd._dt_a(p, dt_raw)
    torch.cuda.synchronize()
    t1 = time.monotonic()
    y, h = ssd.ssd_chunked(xin, dt, a, bm, cm, scfg.chunk)
    torch.cuda.synchronize()
    chunked_s = time.monotonic() - t1
    t1 = time.monotonic()
    y_ref, h_ref = ssd.ssd_naive(xin, dt, a, bm, cm)
    torch.cuda.synchronize()
    naive_s = time.monotonic() - t1
    y_max, h_max = float(y_ref.abs().max()), float(h_ref.abs().max())
    err = float((y - y_ref).abs().max())
    err_state = float((h - h_ref).abs().max())
    row = {"phase": "ssd_scan", "batch": SSD_SCAN[0], "seq": SSD_SCAN[1],
           "heads": scfg.n_heads, "head_dim": scfg.head_dim,
           "d_state": scfg.d_state, "chunk": scfg.chunk,
           "max_abs_err": err, "tol": _ssd_scan_tol(y_max),
           "max_abs_err_state": err_state,
           "tol_state": _ssd_scan_tol(h_max),
           "y_max_abs": y_max, "state_max_abs": h_max,
           "chunked_ms": 1e3 * chunked_s, "naive_ms": 1e3 * naive_s,
           "seconds": time.monotonic() - t0}
    emit(row)
    if not (err <= row["tol"] and err_state <= row["tol_state"]
            and h_max > 0):
        raise AssertionError(f"ssd_chunked disagrees with ssd_naive: {row}")


def _ssm_fp32(arch, cfg, params, prompts, scfg):
    """On fp32 ``params``: the dense engine's streams against
    ``ReferenceEngine``'s (and mamba2's against a restore from the tick-4
    snapshot and the journal). Returns the launches, the streams and a
    report."""
    from repro_torch.models import costing
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.reference import ReferenceEngine
    t0 = time.monotonic()
    rep = {"param_gb": costing.tree_bytes(params) / 1e9}
    acct = _accountant()
    eng = ServeEngine(params, cfg, scfg, accountant=acct)
    launches, streams, _ = _serve_run(f"ssm_fp32_{arch}", eng, acct,
                                      prompts, SSM_NEW, hits=False)
    rep["ssm_state_max_abs"] = _ssm_state_max(eng)
    rep["admissions"] = sum(1 for m in eng.metrics_log
                            if m.prefill_tokens > 0)
    if rep["ssm_state_max_abs"] <= 0 or rep["admissions"] < 2:
        raise AssertionError(f"{arch} fp32: {rep}")
    eng = None
    _free_device()
    t1 = time.monotonic()
    ref = ReferenceEngine(params, cfg, scfg)
    for p in prompts:
        ref.submit(p, max_tokens=SSM_NEW)
    want = {r.uid: list(r.generated) for r in ref.run_until_drained()}
    rep["reference_s"] = time.monotonic() - t1
    ref = None
    _free_device()
    if streams != want:
        raise AssertionError(f"{arch} fp32: the dense engine's streams "
                             f"differ from ReferenceEngine's: "
                             f"{_first_diff(streams, want)}")
    if arch == "mamba2-1.3b":
        eng, got, rep["restore"] = _kill_and_restore(params, cfg, scfg,
                                                     prompts, SSM_NEW)
        eng = None
        _free_device()
        if got != want:
            raise AssertionError(f"{arch} fp32: the restored streams "
                                 f"differ: {_first_diff(got, want)}")
    rep["seconds"] = time.monotonic() - t0
    return launches, streams, rep


def phase_ssm_family():
    """The SSD/hybrid family on the dense serve path at full width and full
    depth (see SSM_ARCHS' comment): mamba2's scan check, then per arch the
    fp32 streams against ``ReferenceEngine``'s (mamba2's also against a
    restore), and the bf16 (zamba2: also int8) runs with 3 decode ticks
    profiled. Every run's kernel calls are checked by ``_serve_run`` (K1
    at zamba2's 13 shared sites a decode tick, K4 at their projections in
    the int8 mode; mamba2 launches none). Returns the runs' launches."""
    import numpy as np
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import costing
    from repro_torch.models import transformer as tf_lib
    from repro_torch.serve import (ServeConfig, ServeEngine,
                                   generation_agreement)
    t_start = time.monotonic()
    runs = []
    scfg = ServeConfig(max_slots=SSM_SLOTS, max_len=2048, device="cuda")
    for arch in SSM_ARCHS:
        t_arch = time.monotonic()
        cfg = cfgbase.get(arch).make_config()
        rng = np.random.default_rng(SEED + 31)
        prompts = [rng.integers(0, cfg.vocab, n) for n in SSM_PROMPTS]
        report = {}
        params = _live_ssd_conv(tf_lib.init_lm(
            cfg, seed=SEED, dtype=torch.float32, device="cuda"))
        if arch == "mamba2-1.3b":
            _ssd_scan_check(cfg, params)
        launches, fp32, report["fp32"] = _ssm_fp32(arch, cfg, params,
                                                   prompts, scfg)
        runs.append(launches)
        params = None
        _free_device()
        params = _live_ssd_conv(tf_lib.init_lm(
            cfg, seed=SEED, dtype=torch.bfloat16, device="cuda"))
        streams = {}
        for quant in ("none", "int8") if arch == "zamba2-7b" else ("none",):
            label = "bf16" if quant == "none" else "int8"
            t0 = time.monotonic()
            qcfg = dataclasses.replace(scfg, quant=quant)
            acct = _accountant()
            eng = ServeEngine(params, cfg, qcfg, accountant=acct)
            launches, streams[label], _ = _serve_run(
                f"ssm_{label}_{arch}", eng, acct, prompts, SSM_NEW,
                hits=False)
            runs.append(launches)
            report[label] = {
                "param_gb": costing.tree_bytes(eng.params) / 1e9,
                "kv_cache_gb": eng.kv_cache_bytes / 1e9,
                "ssm_state_max_abs": _ssm_state_max(eng),
                "launches": launches}
            eng = None
            _free_device()
            report[label]["profile"] = _profile_serve_ticks(
                params, cfg, qcfg, prompts, SSM_NEW)
            report[label]["launches_per_layer_per_tick"] = (
                report[label]["profile"]["launches_per_tick"]
                / cfg.n_layers)
            report[label]["seconds"] = time.monotonic() - t0
            _free_device()
        if "int8" in streams:
            report["int8_vs_bf16_agreement"] = generation_agreement(
                streams["int8"], streams["bf16"])
        report["bf16_vs_fp32_agreement"] = generation_agreement(
            streams["bf16"], fp32)
        params = None
        _free_device()
        emit({"phase": "ssm_family", "arch": arch, "layers": cfg.n_layers,
              "d_model": cfg.d_model, "prompts": list(SSM_PROMPTS),
              "new_tokens_each": SSM_NEW, "slots": SSM_SLOTS,
              "fp32_engine_reference_identical": True,
              **({"fp32_restore_identical": True}
                 if arch == "mamba2-1.3b" else {}),
              **report, "seconds": time.monotonic() - t_arch})
    emit({"phase": "ssm_family_total", "seconds": time.monotonic() - t_start})
    return runs


# (kernel, its CUDA source under src/repro_torch/kernels/csrc/, the TPU
# kernel it replaces)
# whisper-large-v3 at full width and full depth (32 + 32 layers, d 1280,
# 20 heads of 64, vocab 51866): B 2, all 1500 frames N(0, 1) from SEED, a
# 4-token prompt, then 32 greedy tokens through decode_step with a self
# cache of 448 rows (whisper's design length)
ENCDEC_B, ENCDEC_PROMPT, ENCDEC_NEW, ENCDEC_MAX_LEN = 2, 4, 32, 448
# each decode step's logits against decode_train's teacher-forced logits on
# the same stream: 1e-4 of max(1, max |logit|). The two differ in the order
# of the self-attention's fp32 sums (K6's 3xTF32 tiles against
# decode_step's masked sdpa, about 1e-6 relative) and in the row counts of
# the fp32 GEMMs (35 rows against 2), carried through 32 layers
ENCDEC_TOL = 1e-4
# the Trainer on whisper-large-v3, fp32, B 2 x 64 decoder tokens, random
# frames, 2 steps, at full depth (its peak is predicted in PERF.md)
ENCDEC_TRAIN_B, ENCDEC_TRAIN_S, ENCDEC_TRAIN_STEPS = 2, 64, 2
ENCDEC_TRAIN_ENC, ENCDEC_TRAIN_DEC = 32, 32
# a key bias's gradient is zero in exact arithmetic (it shifts every key's
# score of a query by one q . bk, which the softmax cancels): each route's
# is rounding noise, held below this share of the largest gradient of any
# leaf instead of to its own leaf's max
ENCDEC_BK_NOISE = 1e-5
LAUNCHER_STEPS = 2


def _whisper(dtype, n_enc=None, n_dec=None):
    """whisper-large-v3's config (depths cut when given) and its weights in
    ``dtype`` from SEED on the card."""
    from repro_torch.configs import whisper_large_v3
    from repro_torch.models import encdec
    cfg = whisper_large_v3.make_config()
    if n_enc is not None:
        cfg = dataclasses.replace(cfg, n_enc_layers=n_enc, n_dec_layers=n_dec)
    return cfg, encdec.init_encdec(cfg, seed=SEED, dtype=dtype,
                                   device="cuda")


def _frames(cfg, b, dtype):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return torch.randn((b, cfg.n_audio_ctx, cfg.d_model), generator=gen,
                       device="cuda").to(dtype)


def _greedy_encdec(params, cfg, enc_out, prompt, n_new, max_len, dtype):
    """The cross cache of ``enc_out``, the prompt (B, P) through
    ``decode_step`` one position at a time, then ``n_new`` greedy tokens.
    Returns (the fed stream (B, P + n_new - 1), every step's logits (B,
    P + n_new - 1, vocab), the generated tokens (B, n_new))."""
    import torch
    from repro_torch.models import encdec
    caches = encdec.init_dec_caches(cfg, prompt.shape[0], max_len, dtype,
                                    device=prompt.device)
    caches["cross"] = encdec.build_cross_cache(params, cfg, enc_out)
    fed, logits, gen = [], [], []
    tok = prompt[:, :1]
    for pos in range(prompt.shape[1] + n_new - 1):
        fed.append(tok)
        step, caches = encdec.decode_step(params, cfg, tok, pos, caches)
        logits.append(step[:, 0].float())
        if pos + 1 < prompt.shape[1]:
            tok = prompt[:, pos + 1:pos + 2]
        else:
            tok = step[:, 0].argmax(-1, keepdim=True)
            gen.append(tok)
    return (torch.cat(fed, 1), torch.stack(logits, 1), torch.cat(gen, 1))


def _host_device_ms(fn, k=3):
    """(host ms a call: wall time around ``fn()`` ending in a synchronize,
    the mean of k calls; torch.profiler's device busy ms and launches a
    call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(k):
        fn()
    torch.cuda.synchronize()
    host = 1e3 * (time.monotonic() - t0) / k
    prof = _profile_device(fn, k)
    return {"host_ms": host, "device_ms": prof["device_busy_ms_per_call"],
            "launches": prof["launches_per_call"],
            "device_busy_share": prof["device_busy_share"],
            "top_kernels_ms": prof["top_kernels_ms_per_call"]}


def phase_encdec():
    """whisper-large-v3 at full width and full depth: fp32 weights from
    SEED, ``encode`` over B 2 x 1500 frames, ``build_cross_cache``, a
    4-token prompt and 32 greedy tokens through ``decode_step`` (a 448-row
    self cache, masked ``sdpa``). Then ``decode_train`` on the fed stream
    (``positions=None``: K6 on the card), the counters set to 0 just
    before and read just after: every step's logits within ENCDEC_TOL x
    max(1, max |logit|) of the teacher-forced ones, the greedy tokens
    their argmax, K6 = 32 launches (one a decoder layer) and no other
    kernel. Then the same in bf16, reported: host and device ms of
    ``encode``, ``build_cross_cache`` and a decode step, launches a step,
    peak memory. Returns the fp32 run's launches."""
    import numpy as np
    import torch
    from repro_torch.models import encdec
    counters = _counters()
    rows = {}
    launches = None
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        torch.cuda.reset_peak_memory_stats()
        cfg, params = _whisper(dt)
        frames = _frames(cfg, ENCDEC_B, dt)
        rng = np.random.default_rng(SEED)
        prompt = torch.from_numpy(rng.integers(
            0, cfg.vocab, (ENCDEC_B, ENCDEC_PROMPT))).cuda()
        with torch.no_grad():
            t0 = time.monotonic()
            enc_out = encdec.encode(params, cfg, frames)
            torch.cuda.synchronize()
            encode_s = time.monotonic() - t0
            t0 = time.monotonic()
            fed, step_logits, gen = _greedy_encdec(
                params, cfg, enc_out, prompt, ENCDEC_NEW, ENCDEC_MAX_LEN, dt)
            torch.cuda.synchronize()
            decode_s = time.monotonic() - t0
            row = {"phase": "encdec", "dtype": dt_name,
                   "layers": [cfg.n_enc_layers, cfg.n_dec_layers],
                   "batch": ENCDEC_B, "frames": cfg.n_audio_ctx,
                   "prompt": ENCDEC_PROMPT, "new_tokens": ENCDEC_NEW,
                   "max_len": ENCDEC_MAX_LEN, "encode_s": encode_s,
                   "decode_s": decode_s,
                   "finite": bool(torch.isfinite(step_logits).all())}
            if dt_name == "float32":
                for fn in counters.values():
                    fn.launches = 0
                _reset_flash_kernels()
                tf = encdec.decode_train(params, cfg, fed, enc_out)
                torch.cuda.synchronize()
                launches = {n: fn.launches for n, fn in counters.items()}
                by_kernel = _flash_on_route("encdec")
                tf = tf[..., :cfg.vocab].float()
                scale = max(1.0, float(tf.abs().max()))
                err = float((step_logits - tf).abs().max())
                greedy = torch.equal(tf[:, ENCDEC_PROMPT - 1:].argmax(-1),
                                     gen)
                row.update({"max_abs_logit_diff": err,
                            "tol": ENCDEC_TOL * scale, "greedy_equal": greedy,
                            "stream": gen.tolist(), "launches": launches,
                            "flash_launches_by_kernel": by_kernel})
                want = {n: (cfg.n_dec_layers if n == "flash_attention_fwd"
                            else 0) for n in counters}
                if not (row["finite"] and err <= ENCDEC_TOL * scale
                        and greedy and launches == want):
                    raise AssertionError(f"encdec: decode_step against "
                                         f"decode_train: {row} (launches "
                                         f"want {want})")
                _add_flash_dims(launches, cfg.head_dim)
            else:
                caches = encdec.init_dec_caches(cfg, ENCDEC_B, ENCDEC_MAX_LEN,
                                                dt, device="cuda")
                caches["cross"] = encdec.build_cross_cache(params, cfg,
                                                           enc_out)
                tok = prompt[:, :1]
                last = ENCDEC_PROMPT + ENCDEC_NEW - 1

                def step():
                    encdec.decode_step(params, cfg, tok, last, caches)

                row.update({
                    "encode": _host_device_ms(
                        lambda: encdec.encode(params, cfg, frames)),
                    "build_cross_cache": _host_device_ms(
                        lambda: encdec.build_cross_cache(params, cfg,
                                                         enc_out)),
                    "decode_step": _host_device_ms(step, 8),
                    "agreement_with_fp32": float(
                        (gen.cpu() == torch.tensor(rows["float32"]["stream"]))
                        .float().mean())})
                if not row["finite"]:
                    raise AssertionError(f"encdec bf16: {row}")
            row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        emit(row)
        rows[dt_name] = row
        del params, frames, enc_out, step_logits
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def _add_flash_dims(launches, head_dim):
    """Adds ``head_dim`` to MAIN_HEAD_DIMS for each flash kernel that
    launched in a counted run."""
    for name in TRAIN_FLASH + ("flash_attention",):
        if launches.get(name):
            MAIN_HEAD_DIMS.setdefault(name, set()).add(head_dim)


def _encdec_pipeline(cfg):
    """Synthetic tokens (the Markov source's vocab x vocab table is 10 GB
    of host memory at whisper's vocab), B ENCDEC_TRAIN_B x
    ENCDEC_TRAIN_S."""
    from repro_torch.data import DataConfig, make_pipeline
    return make_pipeline(DataConfig(
        vocab=cfg.vocab, seq_len=ENCDEC_TRAIN_S, global_batch=ENCDEC_TRAIN_B,
        seed=SEED, source="synthetic"))


def _encdec_trainer(cfg, params, frames):
    """A Trainer on the encoder-decoder ``cfg`` (fp32 ``params``), the
    frames in every batch, ``_encdec_pipeline``'s tokens, AdamW as the
    smoke launcher's, billed to h100_sxm."""
    from repro_torch.models import encdec
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train import TrainConfig, Trainer
    steps = ENCDEC_TRAIN_STEPS
    return Trainer(
        loss_fn=lambda p, b: encdec.loss_fn(p, cfg, {**b, "frames": frames}),
        params=params,
        opt_cfg=AdamWConfig(lr=warmup_cosine(3e-3, 1, steps)),
        train_cfg=TrainConfig(num_steps=steps, log_every=1,
                              checkpoint_every=10 ** 9),
        pipeline=_encdec_pipeline(cfg), accountant=_accountant())


def phase_encdec_train():
    """(1) whisper-large-v3 at full width, ENCDEC_TRAIN_ENC +
    ENCDEC_TRAIN_DEC layers, fp32, B 2 x 64 decoder tokens, N(0, 1) frames:
    the first batch's loss and gradients through K6-K8 (``positions=None``)
    against the same call with explicit arange positions (the masked
    ``sdpa``): the loss within 1e-5 relative and each leaf within 1e-4 of
    its max (``phase_train_parity``'s bounds; the key biases, zero in exact
    arithmetic, below ENCDEC_BK_NOISE of the largest gradient in both);
    then the Trainer 2 steps (finite losses, K6 = K7 = K8 = steps x 32, on
    the tensor cores; s/step, peak memory). (2) ``launch.train.main
    ["--arch", a, "--smoke", "--steps", "2"]`` on the card for every LM
    and encoder-decoder arch of the registry: a finite final loss, K6 = K7
    = K8 = steps x the flash-route attention layers' forwards where the
    smoke config's training attention takes the flash route (M-RoPE's and
    an SSD-only config's take none: every other kernel none). Returns the
    launches of (1)'s Trainer run and of each launcher run."""
    import contextlib
    import io
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch import train as launch_train
    from repro_torch.models import encdec
    from repro_torch.models.common import flatten
    counters = _counters()
    torch.cuda.reset_peak_memory_stats()
    cfg, params = _whisper(torch.float32, ENCDEC_TRAIN_ENC, ENCDEC_TRAIN_DEC)
    frames = _frames(cfg, ENCDEC_TRAIN_B, torch.float32)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _encdec_pipeline(cfg).batch_at(0).items()}
    leaves, _ = flatten(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    names = [".".join(p) for p in _leaf_paths(params)]
    pos = torch.arange(ENCDEC_TRAIN_S, device="cuda").expand(
        ENCDEC_TRAIN_B, ENCDEC_TRAIN_S)
    results = {}
    for route, extra in (("flash", {}), ("sdpa", {"positions": pos})):
        for fn in counters.values():
            fn.launches = 0
        _reset_flash_kernels()
        with torch.enable_grad():
            loss, _ = encdec.loss_fn(params, cfg, {**batch, "frames": frames,
                                                   **extra})
            grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        results[route] = (loss.detach(), [g.detach() for g in grads],
                          {n: fn.launches for n, fn in counters.items()})
        del loss, grads
        if route == "flash":
            by_kernel = _flash_on_route("encdec train parity")
    (l_f, g_f, launches_f), (l_s, g_s, launches_s) = (results["flash"],
                                                      results["sdpa"])
    g_max = max(float(g.abs().max()) for g in g_s)
    loss_rel = float((l_f - l_s).abs() / l_s.abs())
    leaf_rel, bk_max = 0.0, 0.0
    for name, a, b in zip(names, g_f, g_s):
        if name.endswith(".bk"):
            bk_max = max(bk_max, float(a.abs().max()), float(b.abs().max()))
            continue
        leaf_rel = max(leaf_rel, float((a - b).abs().max()
                                       / b.abs().max().clamp_min(1e-30)))
    del results, g_f, g_s
    parity = {"phase": "encdec_train_parity",
              "layers": [cfg.n_enc_layers, cfg.n_dec_layers],
              "batch": ENCDEC_TRAIN_B, "dec_seq": ENCDEC_TRAIN_S,
              "loss_flash": float(l_f), "loss_sdpa": float(l_s),
              "loss_rel_diff": loss_rel, "max_leaf_rel_diff": leaf_rel,
              "bk_grad_max_over_max_grad": bk_max / g_max,
              "leaves": len(leaves), "launches": launches_f,
              "flash_launches_by_kernel": by_kernel,
              "sdpa_launches": launches_s}
    emit(parity)
    want = {n: (cfg.n_dec_layers if n in TRAIN_FLASH else 0)
            for n in counters}
    if not (bool(torch.isfinite(l_f)) and loss_rel <= 1e-5
            and leaf_rel <= 1e-4 and bk_max <= ENCDEC_BK_NOISE * g_max
            and launches_f == want and not any(launches_s.values())):
        raise AssertionError(f"encdec train parity: {parity} (launches "
                             f"want {want})")
    tr = _encdec_trainer(cfg, params, frames)
    for fn in counters.values():
        fn.launches = 0
    _reset_flash_kernels()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    tr.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {n: fn.launches for n, fn in counters.items()}
    by_kernel = _flash_on_route("encdec trainer")
    losses = [e["loss"] for e in tr.metrics_log]
    row = {"phase": "encdec_train", "layers": [cfg.n_enc_layers,
                                               cfg.n_dec_layers],
           "batch": ENCDEC_TRAIN_B, "dec_seq": ENCDEC_TRAIN_S,
           "steps": ENCDEC_TRAIN_STEPS, "losses": losses,
           "s_per_step": wall / ENCDEC_TRAIN_STEPS,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "flash_launches_by_kernel": by_kernel}
    emit(row)
    want = {n: (ENCDEC_TRAIN_STEPS * cfg.n_dec_layers if n in TRAIN_FLASH
                else 0) for n in counters}
    if not (len(losses) == ENCDEC_TRAIN_STEPS
            and all(math.isfinite(x) for x in losses) and launches == want):
        raise AssertionError(f"encdec trainer: {row} (launches want {want})")
    _add_flash_dims(launches, cfg.head_dim)
    runs = [launches]
    del tr, params, frames, leaves
    gc.collect()
    torch.cuda.empty_cache()

    rows = []
    for arch in cfgbase.arch_ids():
        spec = cfgbase.get(arch)
        if spec.kind not in ("lm", "encdec"):
            continue
        smoke = spec.make_smoke()
        heads = _flash_heads(smoke)
        for fn in counters.values():
            fn.launches = 0
        _reset_flash_kernels()
        out = io.StringIO()
        # the launcher's Trainer takes SIGTERM for a preemption flag; this
        # script's own handling comes back after the run
        sigterm = signal.getsignal(signal.SIGTERM)
        t0 = time.monotonic()
        try:
            with contextlib.redirect_stdout(out):
                launch_train.main(["--arch", arch, "--smoke", "--steps",
                                   str(LAUNCHER_STEPS)])
        finally:
            signal.signal(signal.SIGTERM, sigterm)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {n: fn.launches for n, fn in counters.items()}
        final = json.loads(next(
            line for line in out.getvalue().splitlines()
            if line.startswith("final metrics:")).split(":", 1)[1])
        r = {"arch": arch, "loss": final["loss"], "seconds": wall,
             "heads": None if heads is None else list(heads),
             "launches": {n: c for n, c in launches.items() if c}}
        rows.append(r)
        n6 = launches["flash_attention_fwd"]
        flash_ok = (n6 > 0 and n6 % LAUNCHER_STEPS == 0
                    and launches["flash_attention_bwd_dq"] == n6
                    and launches["flash_attention_bwd_dkv"] == n6) \
            if heads is not None else n6 == 0
        others = all(c == 0 for n, c in launches.items()
                     if n not in TRAIN_FLASH)
        if not (math.isfinite(final["loss"]) and flash_ok and others):
            raise AssertionError(f"launch.train --smoke on the card: {r}")
        _flash_on_route(f"launch.train {arch}")
        if heads is not None:
            _add_flash_dims(launches, heads[2])
        runs.append(launches)
    emit({"phase": "launch_train_smoke", "steps": LAUNCHER_STEPS,
          "runs": rows})
    return runs


# The families' training on the card at full width (the reference trains
# each on its chip): gemma3-27b cut to 3 sliding-window layers (window
# 1024) and 1 global one, zamba2-7b to 2 of its 13 groups (5 SSD layers
# and a site of the shared attention block each), moonshot-v1-16b-a3b to
# 2 of its 48 MoE layers, mamba2-1.3b at full depth; fp32 with AdamW, B 1
# x S 2048 (past gemma3's window, so the window cuts keys), mamba2's 1024
# (its 48 chunked scans keep ~1.2 GB of activations a layer at 2048,
# which with its 21.5 GB of state passed the card). The depths from 16
# bytes a parameter (fp32 weight, gradient and AdamW's two moments) plus
# activations within the card's 80 GB: PERF.md section 4.
# The Markov source's table is vocab x vocab (550 GB at gemma3's 262,144
# tokens): the tokens are the synthetic source's, as encdec_train's.
# kimi-k2-1t-a32b stays off: one layer's 16.9 G expert parameters are 270
# GB at 16 bytes a parameter.
# arch -> S
FAMILY_TRAIN = {"gemma3-27b": 2048, "zamba2-7b": 2048,
                "moonshot-v1-16b-a3b": 2048, "mamba2-1.3b": 1024}
FAMILY_TRAIN_B, FAMILY_TRAIN_STEPS = 1, 3
# one step through K6-K8 against the same step through the masked sdpa
# (the plain math of kernels/ref.py): the loss within FAMILY_LOSS_TOL
# relative, each leaf within FAMILY_LEAF_TOL of its max; a key bias's
# gradient (zero in exact arithmetic) below ENCDEC_BK_NOISE of the
# largest gradient in both. An SSD block's per-head scalars (a_log,
# dt_bias, d_skip) get a gradient summed over every position and channel
# of the head, which cancels to 0.4-1.7% of the largest gradient: the two
# routes' ~1e-6 differences there reached 2.5e-5 of the leaf's own max in
# zamba2-7b's full-width step, and are held to FAMILY_SCALAR_TOL
FAMILY_LOSS_TOL, FAMILY_LEAF_TOL, FAMILY_SCALAR_TOL = 1e-6, 1e-5, 1e-4
FAMILY_SCALAR_LEAVES = (".ssd.a_log", ".ssd.dt_bias", ".ssd.d_skip")


def _family_train_cfg(arch):
    """``arch``'s config at full width, cut to the depth FAMILY_TRAIN's
    comment gives."""
    from repro_torch.configs import base as cfgbase
    full = cfgbase.get(arch).make_config()
    if arch == "gemma3-27b":
        local, glob = full.pattern[0], full.pattern[-1]
        return dataclasses.replace(full, pattern=(local,) * 3 + (glob,),
                                   repeats=1, tail=())
    if arch == "zamba2-7b":
        return dataclasses.replace(full, repeats=2, tail=())
    if arch == "moonshot-v1-16b-a3b":
        return dataclasses.replace(full, repeats=2)
    return full


def _family_parity(arch, cfg, params, batch, counters, attn_layers):
    """One step's loss and gradients through K6-K8 against the masked
    sdpa's (explicit arange positions), held to FAMILY_LOSS_TOL and
    FAMILY_LEAF_TOL. Returns the row."""
    import torch
    from repro_torch.models import transformer as tf_lib
    from repro_torch.models.common import flatten
    leaves, _ = flatten(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    names = [".".join(p) for p in _leaf_paths(params)]
    b, s = batch["tokens"].shape
    pos = torch.arange(s, device="cuda").expand(b, s)
    results = {}
    for route, extra in (("flash", {}), ("sdpa", {"positions": pos})):
        for fn in counters.values():
            fn.launches = 0
        _reset_flash_kernels()
        with torch.enable_grad():
            loss, metrics = tf_lib.loss_fn(params, cfg, {**batch, **extra})
            grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        results[route] = (loss.detach(), float(metrics["aux"].detach()),
                          [g.detach() for g in grads],
                          {n: fn.launches for n, fn in counters.items()})
        del loss, grads
        if route == "flash":
            by_kernel = _flash_on_route(f"{arch} train parity",
                                        cfg.resolved_head_dim)
    (l_f, aux_f, g_f, launches_f), (l_s, aux_s, g_s, launches_s) = (
        results["flash"], results["sdpa"])
    del results
    g_max = max(float(g.abs().max()) for g in g_s)
    loss_rel = float((l_f - l_s).abs() / l_s.abs())
    leaf_rels, bk_max = {}, 0.0
    for name, a, c in zip(names, g_f, g_s):
        if name.endswith(".bk"):
            bk_max = max(bk_max, float(a.abs().max()), float(c.abs().max()))
            continue
        leaf_rels[name] = (float((a - c).abs().max()
                                 / c.abs().max().clamp_min(1e-30)),
                           float(c.abs().max()) / g_max)
    scalar = {n: r for n, (r, _) in leaf_rels.items()
              if n.endswith(FAMILY_SCALAR_LEAVES)}
    leaf_rel = max(r for n, (r, _) in leaf_rels.items() if n not in scalar)
    scalar_rel = max(scalar.values(), default=0.0)
    worst = sorted(leaf_rels.items(), key=lambda kv: -kv[1][0])[:6]
    finite = all(bool(torch.isfinite(x).all()) for x in [l_f, l_s] + g_f
                 + g_s)
    del g_f, g_s
    for leaf in leaves:
        leaf.requires_grad_(False)
    row = {"finite": finite, "loss_flash": float(l_f),
           "loss_sdpa": float(l_s),
           "aux_flash": aux_f, "aux_sdpa": aux_s,
           "loss_rel_diff": loss_rel, "max_leaf_rel_diff": leaf_rel,
           "max_ssd_scalar_rel_diff": scalar_rel,
           "worst_leaves_rel_diff_and_max_over_max_grad": dict(worst),
           "bk_grad_max_over_max_grad": bk_max / g_max,
           "leaves": len(leaves), "launches": launches_f,
           "flash_launches_by_kernel": by_kernel,
           "sdpa_launches": launches_s}
    want = {n: (attn_layers if n in TRAIN_FLASH else 0) for n in counters}
    if not (finite and loss_rel <= FAMILY_LOSS_TOL
            and leaf_rel <= FAMILY_LEAF_TOL
            and scalar_rel <= FAMILY_SCALAR_TOL
            and bk_max <= ENCDEC_BK_NOISE * g_max
            and launches_f == want and not any(launches_s.values())):
        raise AssertionError(f"{arch} train parity: {row} (launches want "
                             f"{want})")
    return row


def phase_family_train():
    """gemma3-27b, zamba2-7b, moonshot-v1-16b-a3b and mamba2-1.3b trained
    on the card at full width and FAMILY_TRAIN's depths, in fp32 with the
    smoke launcher's pieces (``init_lm``, ``transformer.loss_fn``,
    warmup-cosine AdamW, the Trainer; synthetic tokens; the SSD blocks on
    live ``conv_b``/``conv_c``, ``_live_ssd_conv``): for each arch
    with attention, one step through K6-K8 held to the masked sdpa's
    (``_family_parity``); then FAMILY_TRAIN_STEPS Trainer steps with
    finite losses (moonshot's with its aux loss above zero), K6 = K7 = K8
    = the flash-route attention layers a step, each on its route's kernel,
    s/step with the first step apart, peak memory; then one more step
    profiled (``_profile_tick``). Returns each Trainer run's launches."""
    import torch
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.models import transformer as tf_lib
    from repro_torch.models.common import flatten
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train import TrainConfig, Trainer
    counters = _counters()
    runs = []
    for arch, seq in FAMILY_TRAIN.items():
        t_arch = time.monotonic()
        cfg = _family_train_cfg(arch)
        heads = _flash_heads(cfg)
        specs = tuple(cfg.pattern) * cfg.repeats + tuple(cfg.tail)
        attn_layers = 0 if heads is None else sum(
            1 for sp in specs if sp.kind != "ssd")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        params = _live_ssd_conv(tf_lib.init_lm(
            cfg, seed=SEED, dtype=torch.float32, device="cuda"))
        init_s = time.monotonic() - t0
        n_params = sum(p.numel() for p in flatten(params)[0])
        pipeline = make_pipeline(DataConfig(
            vocab=cfg.vocab, seq_len=seq,
            global_batch=FAMILY_TRAIN_B, seed=SEED, source="synthetic"))
        row = {"phase": "family_train", "arch": arch,
               "layers": len(specs), "attention_layers": attn_layers,
               "d_model": cfg.d_model,
               "heads": None if heads is None else list(heads),
               "batch": FAMILY_TRAIN_B, "seq": seq,
               "params": n_params,
               "state_gb_at_16_bytes": 16 * n_params / 1e9,
               "init_s": init_s}
        if heads is not None:
            batch = {k: torch.from_numpy(v).cuda()
                     for k, v in pipeline.batch_at(0).items()}
            row["parity"] = _family_parity(arch, cfg, params, batch,
                                           counters, attn_layers)
            del batch
            gc.collect()
            torch.cuda.empty_cache()
        steps = FAMILY_TRAIN_STEPS
        tr = Trainer(
            loss_fn=lambda p, b, cfg=cfg: tf_lib.loss_fn(p, cfg, b),
            params=params,
            opt_cfg=AdamWConfig(lr=warmup_cosine(3e-3, 1, steps)),
            train_cfg=TrainConfig(num_steps=steps, log_every=1,
                                  checkpoint_every=10 ** 9),
            pipeline=pipeline, accountant=_accountant())
        del params
        for fn in counters.values():
            fn.launches = 0
        _reset_flash_kernels()
        torch.cuda.reset_peak_memory_stats()
        tr.run()
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in counters.items()}
        log = tr.metrics_log
        losses = [e["loss"] for e in log]
        step_s = [e["step_time_s"] for e in log]
        row.update({
            "steps": steps, "losses": losses,
            "aux": [e.get("aux") for e in log],
            "first_step_s": step_s[0],
            "s_per_step": sum(step_s[1:]) / max(len(step_s) - 1, 1),
            "tokens_per_s": FAMILY_TRAIN_B * seq * (
                len(step_s) - 1) / max(sum(step_s[1:]), 1e-9),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": {n: c for n, c in launches.items() if c},
            "flash_launches_per_step": {
                n: launches[n] / steps for n in TRAIN_FLASH}})
        if heads is not None:
            row["flash_launches_by_kernel"] = _flash_on_route(
                f"{arch} trainer", heads[2])
        # one more step under torch.profiler: where the step's time goes
        row["profile"] = _profile_tick(tr, 1, top=6)
        want = {n: (steps * attn_layers if n in TRAIN_FLASH else 0)
                for n in counters}
        aux_ok = cfg.moe_cfg is None or all(
            a is not None and a > 0 for a in row["aux"])
        row["seconds"] = time.monotonic() - t_arch
        emit(row)
        if not (len(losses) == steps
                and all(math.isfinite(x) for x in losses)
                and launches == want and aux_ok):
            raise AssertionError(f"family_train {arch}: {row} (launches "
                                 f"want {want})")
        if heads is not None:
            _add_flash_dims(launches, heads[2])
        runs.append(launches)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    return runs


# the cells phase: starcoder2-7b decode_32k at full width and depth with
# its batch cut 128 -> 8 (the bf16 cache of 128 rows of 32768 tokens is
# 256 GiB, of 8 rows 16 GiB beside 14.3 GB of weights), the same cell
# with int8 weights, whisper-large-v3's decode_32k cell cut the same way
# (a 43 GB self cache at 8 rows), and starcoder2-7b train_4k at full
# width cut to 8 of its 32 layers and a global batch of 1 (from 256)
CELL_BATCH = 8
CELL_TRAIN_LAYERS = 8
CELL_TRAIN_STEPS = 2


def _cell_record(arch_id, shape_name, shape, overrides, mesh_name):
    """The dry-run record of a cut cell (meta tensors, no device), its
    traceback dropped."""
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell(arch_id, shape_name, overrides=overrides,
                          mesh_name=mesh_name, shape=shape)
    if not rec.get("ok"):
        raise AssertionError(f"cells: dry-run of {rec['label']}: "
                             f"{rec.get('error')}")
    return {k: rec[k] for k in (
        "label", "mesh", "kind", "n_params_total", "tokens_per_step",
        "memory", "flops_per_device", "bytes_per_device", "flops_by_prim",
        "compute_s", "memory_s", "bound", "step_time_s",
        "collective_bytes_per_device", "collective_note")}


def _run_cell(phase, arch_id, shape_name, shape, overrides, check):
    """Builds the cut cell, materializes it on the card from SEED, and
    runs ``check(cell, args, counters)`` with every counter set to 0 just
    before the cell's step and read inside it; prints the row with the
    dry-run's records of the same cell and the peak memory beside them.
    Returns the launches."""
    import torch
    from repro_torch.launch import cells, dryrun
    counters = _counters()
    mesh = dryrun.mesh_named("one")
    t0 = time.monotonic()
    cell = cells.build_cell(arch_id, shape_name, mesh, overrides,
                            shape=shape)
    torch.cuda.reset_peak_memory_stats()
    args = cell.materialize("cuda", SEED)
    torch.cuda.synchronize()
    row = {"phase": phase, "arch": arch_id, "shape": shape_name,
           "kind": cell.kind, "overrides": overrides or {},
           "global_batch": shape.global_batch, "seq_len": shape.seq_len,
           "layers": cell.cfg.n_layers, "build_materialize_s":
           time.monotonic() - t0}
    for fn in counters.values():
        fn.launches = 0
        for key in fn.launches_by_kernel:
            fn.launches_by_kernel[key] = 0
    row.update(check(cell, args, counters))
    row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    row["dryrun"] = {m: _cell_record(arch_id, shape_name, shape, overrides,
                                     m) for m in ("one", "single", "multi")}
    one = row["dryrun"]["one"]["memory"]
    row["peak_vs_dryrun_gb"] = {
        "peak_allocated": row["peak_mem_gb"],
        "dryrun_argument": one["argument"] / 1e9,
        "dryrun_analytic_live": one["analytic_live"] / 1e9}
    emit(row)
    launches = row["launches"]
    del args, cell
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# K1 at the decode cell's shapes is held against its plain version with
# q of unit scale and at CELL_Q_PEAKED times it: at 32768 keys a
# unit q spreads its softmax over thousands of keys, so outputs are ~1e-2
# and the bf16 atol alone would pass a lost split; the peaked q puts most
# of the weight on a few keys, so a split dropped or combined wrongly
# moves outputs of order one
CELL_Q_PEAKED = 8.0


def _cell_kernels_check(cell, params, caches):
    """The cell's kernels at the shapes its step gives them, each against
    its plain version: K1 on layer 0's bf16 cache (B rows, every one of
    its keys live after the step) within MODES' bf16 tolerance, for a q
    at unit scale and one CELL_Q_PEAKED times it; with int8 weights also
    K4 on layer 0's q projection (x (B, d_model) bf16) within K4_TOL.
    Returns each check's max abs error and the largest plain output."""
    import torch
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import ref
    from repro_torch.models import transformer as tf_lib
    cfg = cell.cfg
    if not isinstance(cfg, tf_lib.LMConfig):
        return {}
    window = cfg.pattern[0].window
    entry = caches["pat0"]
    k, v, tags = entry["kv"].k[0], entry["kv"].v[0], entry["pos"][0]
    lengths = (tags >= 0).sum(-1).to(torch.int32)
    b, sk = tags.shape
    if not bool((lengths == sk).all()):
        raise AssertionError(f"cells: layer 0's cache holds {lengths} "
                             f"keys a row, not {sk}")
    atol, rtol = next((a, r) for qn, kn, a, r in MODES
                      if (qn, kn) == ("bfloat16", "bfloat16"))
    scale = cfg.attn_cfg(window).scale
    gen = torch.Generator(device="cuda").manual_seed(SEED + 35)
    q = torch.randn((b, cfg.n_heads, cfg.resolved_head_dim), generator=gen,
                    device="cuda")
    out = {"k1_shape": {"B": b, "Sk": sk, "H": cfg.n_heads,
                        "Hkv": k.shape[-2], "D": k.shape[-1],
                        "window": window}}
    for label, mult in (("unit_q", 1.0), ("peaked_q", CELL_Q_PEAKED)):
        qs = (q * mult).to(torch.bfloat16)
        got = k1.decode_attention(qs, k, v, lengths, scale=scale,
                                  window=window)
        want = ref.decode_attention_ref(qs, k, v, lengths, scale=scale,
                                        window=window)
        err = (got.float() - want.float()).abs()
        row = {"max_abs_err": float(err.max()),
               "plain_max_abs": float(want.float().abs().max()),
               "atol": atol, "rtol": rtol}
        out[f"k1_{label}"] = row
        if not (bool((err <= atol + rtol * want.float().abs()).all())
                and bool(torch.isfinite(got).all())):
            raise AssertionError(f"cells: K1 at {out['k1_shape']}, "
                                 f"{label}: {row}")
    if cfg.use_int8_matmul:
        wq = params["pat0"]["attn"]["wq"]
        q8, s8 = wq["q8"][0], wq["s8"][0]
        codes = q8.reshape(q8.shape[0], -1)
        sc = torch.broadcast_to(s8, q8.shape[1:]).reshape(-1).float()
        x = torch.randn((b, codes.shape[0]), generator=gen,
                        device="cuda").to(torch.bfloat16)
        _, max_err = _check_k4(x, codes, sc.contiguous(), torch.bfloat16)
        out["k4_wq"] = {"m": b, "k": codes.shape[0], "n": codes.shape[1],
                        "max_abs_err": max_err,
                        "tolerance": K4_TOL["bfloat16", "bfloat16"]}
    return out


def _decode_check(per_layer):
    """A decode cell's check: one step through ``Cell.run``, then a direct
    ``decode_step`` on the same tensors (the step's cache write is the same
    row with the same values, so the second call sees the same cache):
    the logits equal bit for bit and finite (a wiring check: both run the
    same kernels), and each kernel's launches in the cell's step
    ``per_layer[name]`` x the layers; then the cell's kernels against
    their plain versions at its shapes (``_cell_kernels_check``). Both
    calls' wall seconds are reported (the first with its warm-up)."""
    import torch
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tf_lib

    def check(cell, args, counters):
        params, token, pos, caches = args
        t0 = time.monotonic()
        with torch.no_grad():
            logits, _ = cell.run(*args)
            torch.cuda.synchronize()
            step_s = time.monotonic() - t0
            launches = {n: fn.launches for n, fn in counters.items()}
            by_kernel = {n: dict(counters[n].launches_by_kernel)
                         for n in per_layer}
            t0 = time.monotonic()
            if isinstance(cell.cfg, tf_lib.LMConfig):
                want, _ = tf_lib.decode_step(params, cell.cfg, token,
                                             pos.expand(token.shape[0]),
                                             caches)
            else:
                want, _ = encdec.decode_step(params, cell.cfg, token, pos,
                                             caches)
            torch.cuda.synchronize()
            direct_s = time.monotonic() - t0
            kernel_checks = _cell_kernels_check(cell, params, caches)
        n_layers = cell.cfg.n_layers if isinstance(
            cell.cfg, tf_lib.LMConfig) else cell.cfg.n_dec_layers
        expect = {n: per_layer.get(n, 0) * n_layers for n in counters}
        out = {"step_s": step_s, "direct_step_s": direct_s,
               "launches": launches,
               "launches_by_kernel": by_kernel,
               "kernel_checks": kernel_checks,
               "logits_shape": list(logits.shape),
               "finite": bool(torch.isfinite(logits).all()),
               "equal_to_direct_decode_step": bool(torch.equal(logits,
                                                               want))}
        if not (out["finite"] and out["equal_to_direct_decode_step"]
                and launches == expect):
            raise AssertionError(f"cells: {cell.arch_id} {cell.shape_name} "
                                 f"{cell.notes}: {out} (launches want "
                                 f"{expect})")
        return out
    return check


def _train_check(cell, args, counters):
    """Two training steps through ``Cell.run``: the losses finite, K6, K7
    and K8 once a layer a step, each on the kernel ``route`` names; the
    attention route the step took and s/step reported."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    _reset_flash_kernels()
    losses, secs = [], []
    for _ in range(CELL_TRAIN_STEPS):
        t0 = time.monotonic()
        _, _, metrics = cell.run(*args)
        losses.append(float(metrics["loss"]))
        secs.append(time.monotonic() - t0)
    launches = {n: fn.launches for n, fn in counters.items()}
    by_kernel = _flash_on_route("cells_train", cell.cfg.resolved_head_dim,
                                "bfloat16")
    expect = {n: (CELL_TRAIN_STEPS * cell.cfg.n_layers if n in TRAIN_FLASH
                  else 0) for n in counters}
    out = {"losses": losses, "s_per_step": secs, "launches": launches,
           "attention_route": {
               "path": "ops.flash_attention_train (positions=None)",
               "kernel": fa.route(torch.bfloat16,
                                  cell.cfg.resolved_head_dim)},
           "flash_launches_by_kernel": by_kernel}
    if not (all(math.isfinite(x) for x in losses) and launches == expect):
        raise AssertionError(f"cells train: {out} (launches want {expect})")
    _add_flash_dims(launches, cell.cfg.resolved_head_dim)
    return out


def phase_cells():
    """The mesh cells (``launch.cells``) on one card, a one-device mesh,
    at full width: starcoder2-7b ``decode_32k`` (32 of 32 layers, bf16,
    global batch cut to CELL_BATCH) through K1 once a layer, the same
    cell with ``_weights_int8`` (every projection on K4: six a layer),
    whisper-large-v3's ``decode_32k`` cell (32 + 32 layers, the same
    batch; masked ``sdpa``, no kernel), and starcoder2-7b ``train_4k``
    (CELL_TRAIN_LAYERS layers, batch 1, the cells' AdamW: bf16 moments, no
    master) for CELL_TRAIN_STEPS steps through K6-K8. Each cell's dry-run
    record on the one-device mesh and the production meshes is printed
    beside its peak memory. Returns each run's launches."""
    from repro_torch.configs import base as cfgbase
    decode = dataclasses.replace(cfgbase.SHAPES["decode_32k"],
                                 global_batch=CELL_BATCH)
    train = dataclasses.replace(cfgbase.SHAPES["train_4k"], global_batch=1)
    emit({"phase": "cells_cuts", "cuts": {
        "decode_32k": f"global_batch 128 -> {CELL_BATCH}: 128 bf16 rows of "
                      f"32768 tokens are 256 GiB of KV cache at "
                      f"starcoder2-7b, 8 rows 16 GiB",
        "whisper decode_32k": f"global_batch 128 -> {CELL_BATCH}: a 43 GB "
                              f"self cache at 8 rows",
        "train_4k": f"32 -> {CELL_TRAIN_LAYERS} layers and global_batch 256 "
                    f"-> 1: one card's memory and the phase's time"}})
    runs = [
        _run_cell("cells_decode", "starcoder2-7b", "decode_32k", decode,
                  None, _decode_check({"decode_attention": 1})),
        _run_cell("cells_decode_int8", "starcoder2-7b", "decode_32k",
                  decode, {"_weights_int8": True},
                  _decode_check({"decode_attention": 1, "int8_matmul": 6})),
        _run_cell("cells_encdec_decode", "whisper-large-v3", "decode_32k",
                  decode, None, _decode_check({})),
        _run_cell("cells_train", "starcoder2-7b", "train_4k", train,
                  {"repeats": CELL_TRAIN_LAYERS}, _train_check)]
    MAIN_HEAD_DIMS.setdefault("decode_attention", set()).add(128)
    return runs


def _leaf_paths(tree, prefix=()):
    """The key path of every leaf of a nested dict, in ``flatten``'s
    order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _leaf_paths(v, prefix + (k,))
        else:
            out.append(prefix + (k,))
    return out


KERNELS = (
    ("decode_attention", "decode_attention",
     "src/repro/kernels/decode_attention.py:122"),
    ("paged_decode_attention", "paged_decode_attention",
     "src/repro/kernels/decode_attention.py:245"),
    ("paged_prefill_attention", "paged_prefill_attention",
     "src/repro/kernels/flash_attention.py:494"),
    ("int8_matmul", "int8_matmul", "src/repro/kernels/int8_matmul.py:53"),
    ("paged_verify_attention", "paged_verify_attention",
     "src/repro/kernels/decode_attention.py:388"),
    ("flash_attention_fwd", "flash_attention",
     "src/repro/kernels/flash_attention.py:262"),
    ("flash_attention_bwd_dq", "flash_attention",
     "src/repro/kernels/flash_attention.py:337"),
    ("flash_attention_bwd_dkv", "flash_attention",
     "src/repro/kernels/flash_attention.py:357"),
    ("int8_matmul_dx", "int8_matmul", "src/repro/kernels/int8_matmul.py:124"),
    ("flash_attention", "flash_attention",
     "src/repro/kernels/flash_attention.py:103"),
    ("ternary_matmul", "ternary_matmul",
     "src/repro/kernels/ternary_matmul.py:58"),
)


def phase_serve_runs():
    """Phases 6-9 on the bf16 weights and their int8 quantization: the
    dense, paged and speculative serve runs, the tree and n-best runs held
    to their streams, and the int8 agreement. Returns each run's
    launches."""
    import torch
    from repro_torch.models import transformer as tf_lib
    cfg = _starcoder2(SERVE_LAYERS)
    params = tf_lib.init_lm(cfg, seed=SEED, dtype=torch.bfloat16,
                            device="cuda")
    qcfg = dataclasses.replace(cfg, quant=tf_lib.INT8_QUANT)
    qparams = tf_lib.quantize_lm(params)
    runs = [phase_serve(cfg, params), phase_serve(qcfg, qparams, "int8")]
    for c, p, quant in ((cfg, params, "none"), (qcfg, qparams, "int8")):
        launches, *plain = phase_paged_serve(c, p, quant)
        runs.append(launches)
        launches, *linear = phase_paged_serve(c, p, quant, spec_k=SPEC_K)
        runs += [launches, phase_tree_serve(c, p, quant, plain, linear),
                 phase_nbest(c, p, quant),
                 phase_chaos_serve(c, p, quant, plain),
                 phase_durability_serve(c, p, quant, plain)]
    runs.append(phase_chaos_spec(cfg, params))
    phase_forced_fallback(cfg, params)
    phase_agreement(cfg, params, qparams)
    return runs


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
    # seconds since the start at the end of each group of phases: where the
    # script's 1200 s go
    timeline = {}

    def mark(name):
        timeline[name] = time.monotonic() - t0

    phase_device()
    phase_build()
    mark("build")
    phase_routes()
    rows = {name: r[MAIN_INT8] for name, r in phase_kernels().items()}
    d168 = phase_kernels_d168()
    d112 = phase_kernels_d112()
    k1_zamba2 = phase_kernels_zamba2()
    phase_prefill_ragged()
    phase_decode_ragged()
    rows["int8_matmul"] = phase_int8_decode()
    phase_int8_matmul()
    phase_int8_family()
    rows["int8_matmul_dx"] = phase_int8_dx()
    phase_int8_train_grads()
    rows["ternary_matmul"] = phase_ternary_matmul()
    flash_rows, bf16 = phase_flash_kernels()
    rows.update(flash_rows)
    phase_flash_ragged()
    rows["flash_attention"], bf16["flash_attention"] = phase_flash_infer()
    small = phase_flash_small_dims()
    small.update(phase_flash_wide_dims())
    mark("kernels")
    # before any long profile: after one of tens of thousands of kernels,
    # the card's profiles drop records for a while, and the CNN phase
    # counts K11's records in profiles of two forwards
    from repro_torch.models import cnn
    runs = []
    for cnn_cfg in (cnn.ALEXNET, cnn.VGG16):
        runs.append(phase_cnn(cnn_cfg))
        gc.collect()
        torch.cuda.empty_cache()
    mark("cnn")
    runs += phase_cells()
    mark("cells")
    phase_streams()
    mark("streams")
    torch.cuda.empty_cache()
    runs += phase_serve_runs()
    mark("serve_runs")
    gc.collect()
    torch.cuda.empty_cache()
    runs += phase_gemma3()
    runs += phase_family_serve()
    mark("gemma3_family")
    gc.collect()
    torch.cuda.empty_cache()
    runs += phase_moe()
    mark("moe")
    gc.collect()
    torch.cuda.empty_cache()
    runs += phase_ssm_family()
    mark("ssm_family")
    runs.append(phase_encdec())
    mark("encdec")
    gc.collect()
    torch.cuda.empty_cache()
    runs += phase_encdec_train()
    mark("encdec_train")
    gc.collect()
    torch.cuda.empty_cache()
    runs += phase_family_train()
    mark("family_train")
    gc.collect()
    torch.cuda.empty_cache()
    runs += [phase_train_parity(), phase_train_parity("bfloat16"),
             phase_train()]
    gc.collect()
    torch.cuda.empty_cache()
    runs.append(phase_train("bfloat16"))
    mark("train")
    gc.collect()
    torch.cuda.empty_cache()
    runs += [phase_trainer(), phase_train_bench(), phase_kernel_bench()]
    mark("trainer_benches")
    launches = {name: sum(r[name] for r in runs) for name, _, _ in KERNELS}
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    emit({"phase": "timeline", "seconds_since_start": timeline})
    emit({"phase": "total", "seconds": time.monotonic() - t0})
    emit({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{source}.cu",
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": rows[name]["max_abs_err"], "ms": rows[name]["ms"],
        "plain_ms": rows[name]["plain_ms"],
        "bound_ms": rows[name]["bound_ms"],
        "bound_by": rows[name]["bound_by"],
        "library_ms": rows[name]["library_ms"],
        **({"kernels_launched": MAIN_ROUTES[name]} if name in MAIN_ROUTES
           else {}),
        **({"head_dims": sorted(MAIN_HEAD_DIMS.get(name, ())),
            **{label: {key: rows_d[name][key] for key in (
                "ms", "max_abs_err", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "route")}
               for label, rows_d in (("d168", d168), ("d112", d112))}}
           if name in d168 else {}),
        **({"d112_zamba2": {key: k1_zamba2[key] for key in (
            "ms", "max_abs_err", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "route")}} if name == "decode_attention" else {}),
        **({"bf16": {key: bf16[name][key] for key in (
            "ms", "max_abs_err", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_kernels")}} if name in bf16 else {}),
        **({"head_dims": sorted(MAIN_HEAD_DIMS.get(name, ())),
            **{f"d{d}": {key: small[d][name][key] for key in (
                "ms", "max_abs_err", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "route")} for d in sorted(small)}}
           if name in small[8] else {})}
        for name, source, replaces in KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
