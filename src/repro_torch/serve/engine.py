"""Device-resident continuous-batching serve core of the PyTorch port
(mirror of the dense and paged paths of ``repro.serve.engine``).

Dense: submit -> ``Scheduler`` -> padded admission prefill -> one decode
tick -> one host readback -> ``StepMetrics`` -> ``CarbonAccountant``.

Paged (``ServeConfig.paged``): submit -> ``Scheduler`` (capacity gate) ->
prefix lookup in the ``PagePool`` -> page allocation -> one
``paged_extend`` call per tick advancing every in-flight prefill by one
chunk (K3 on the card) -> one ``paged_decode_step`` tick (K2) -> one
readback -> publish and release at finish -> page-granular bills.

The decode tick runs the batched decode step over the shared KV cache
(per-slot positions, so decode attention is the K1 or K2 kernel on the
card), samples, advances tokens and positions, sets EOS/budget/length done
flags and writes a device-side output buffer. The host reads back ONE
packed (2, B) ``[done, bad]`` array per tick; generated tokens leave the
device only when a request finishes. Where the JAX engine donates its
``DeviceState`` to a jitted tick, this engine updates the same tensors in
place; PyTorch runs eagerly, so there is no trace to count.

Not ported yet (ROADMAP queue 1): int8, speculative decode, copy-on-write
forks, the chaos tier and durability. A slot whose logits go non-finite
therefore raises instead of being quarantined.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import accounting
from repro_torch.models import costing
from repro_torch.models import layers
from repro_torch.models import transformer as tf_lib
from repro_torch.serve.pages import ROOT, PagePool, block_tokens, fragmentation
from repro_torch.serve.scheduler import Scheduler, SchedulerConfig

PyTree = Any


@dataclasses.dataclass
class ServeConfig:
    max_slots: int = 4
    max_len: int = 512
    eos_id: int = -1          # -1: never; sampling stops at max_tokens
    temperature: float = 0.0  # default per-request temperature; 0 = greedy
    cache_dtype: torch.dtype = torch.float32
    seed: int = 0
    # where the engine runs; "cuda" raises on a machine without a card
    device: str = "cuda"
    # paged KV cache + prefix reuse + chunked prefill:
    paged: bool = False
    page_size: int = 16       # tokens per KV page (block granularity)
    # pool capacity in pages. None = dense-equivalent:
    # max_slots * ceil(max_len / page_size); smaller pools admit by deferral
    num_pages: Optional[int] = None
    # content-matched block reuse at admission: a hit copies page-table
    # entries instead of recomputing the shared prefix's prefill
    prefix_cache: bool = True
    # admit long prompts in chunks of this many tokens, interleaved with
    # decode ticks. 0 = whole suffix in one extend call
    prefill_chunk: int = 0
    # compact a live slot's private page suffix into a contiguous run when
    # its table's fragmentation score reaches this threshold; 0.0 = off
    compact_threshold: float = 0.0
    # park reclamation: "lru" | "cost" (cheapest-to-recompute block first)
    evict_policy: str = "lru"


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (S,) int32
    max_tokens: int = 16
    temperature: Optional[float] = None   # None -> ServeConfig.temperature
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # engine tick at submission (the scheduler's queue-aging term reads it)
    submit_tick: int = -1


@dataclasses.dataclass
class StepMetrics:
    """What one engine tick did — the unit core/accounting.py bills. The
    fields are the JAX engine's, so the accountant copy bills it unchanged;
    the dense path leaves the paged/spec/chaos/COW channels at zero."""
    tokens: int                 # decode tokens produced this tick
    active_slots: int           # slots decoding this tick
    wall_s: float               # host wall time of the tick (incl. admission)
    prefill_tokens: int = 0     # prompt tokens prefilled this tick
    admitted: int = 0           # requests admitted this tick
    queue_depth: int = 0        # requests still waiting after the tick
    weight_bytes: float = 0.0   # parameter bytes streamed from HBM
    kv_bytes: float = 0.0       # KV-cache bytes read/written
    flops: float = 0.0          # modeled FLOPs
    prefix_hit_tokens: int = 0
    saved_bytes: float = 0.0
    saved_flops: float = 0.0
    spec_draft_tokens: int = 0
    spec_accepted_tokens: int = 0
    draft_flops: float = 0.0
    draft_bytes: float = 0.0
    verify_flops: float = 0.0
    verify_bytes: float = 0.0
    prefill_gather_bytes: float = 0.0
    compaction_moves: int = 0
    faults_injected: int = 0
    quarantined: int = 0
    shed: int = 0
    recovery_tokens: int = 0
    recovery_flops: float = 0.0
    recovery_bytes: float = 0.0
    degraded: int = 0
    readback_retries: int = 0
    cow_bytes: float = 0.0
    cow_copies: int = 0
    forks: int = 0
    fork_saved_bytes: float = 0.0
    fork_saved_flops: float = 0.0

    @property
    def bytes_moved(self) -> float:
        return self.weight_bytes + self.kv_bytes


# StepMetrics fields that are deliberately NOT energy channels — pure
# occupancy/queue observability with no joule interpretation
ACCOUNTING_EXEMPT = frozenset({"active_slots", "admitted", "queue_depth"})


@dataclasses.dataclass
class _AdmitInfo:
    """What one admission pass did + its modeled traffic/compute bill."""
    admitted: int = 0
    prefill_tokens: int = 0
    weight_passes: int = 0      # extra weight-tree streams (0 or 1)
    kv_bytes: float = 0.0
    flops: float = 0.0
    prefix_hit_tokens: int = 0
    saved_bytes: float = 0.0
    saved_flops: float = 0.0
    gather_bytes: float = 0.0   # cached-window gather share of kv_bytes


@dataclasses.dataclass
class DeviceState:
    """All per-slot serving state, resident on the device between ticks."""
    caches: PyTree
    tok: torch.Tensor           # (B,)  last token per slot
    pos: torch.Tensor           # (B,)  next cache write position per slot
    gen: torch.Tensor           # (B,)  tokens generated per slot
    budget: torch.Tensor        # (B,)  max_tokens per slot
    active: torch.Tensor        # (B,)  bool
    temp: torch.Tensor          # (B,)  per-slot sampling temperature
    # (B,) request uid per slot: with the engine seed and the token index it
    # keys the counter-based sampler (the JAX engine keeps threefry keys)
    uid: torch.Tensor
    out_buf: torch.Tensor       # (B, max_len) device-side output buffer
    # paged mode: (B, NB) int32 logical-block -> physical-page map (the
    # PagePool owns allocation; entries past a slot's pages point at the
    # sink page). Dense mode: (B, 0).
    page_table: torch.Tensor


def _bucket_len(n: int, cap: Optional[int] = None) -> int:
    """Pad prompt-batch length to a pow2 bucket, clamped at ``cap``."""
    b = 4
    while b < n:
        b *= 2
    return min(b, cap) if cap is not None else b


class ServeEngine:
    def __init__(self, params: PyTree, cfg: tf_lib.LMConfig,
                 serve_cfg: ServeConfig,
                 accountant: Optional[accounting.CarbonAccountant] = None,
                 scheduler: Optional[Scheduler] = None):
        if (serve_cfg.paged and serve_cfg.prefill_chunk
                and serve_cfg.prefill_chunk % serve_cfg.page_size != 0):
            raise ValueError(
                f"prefill_chunk ({serve_cfg.prefill_chunk}) must be a "
                f"multiple of page_size ({serve_cfg.page_size}): a chunk "
                f"boundary inside a page would split block publication")
        if not 0.0 <= serve_cfg.compact_threshold <= 1.0:
            raise ValueError(f"compact_threshold must be in [0, 1], got "
                             f"{serve_cfg.compact_threshold}")
        self.device = device_lib.resolve(serve_cfg.device)
        if params["embed"]["w"].device != self.device:
            raise ValueError(f"params live on {params['embed']['w'].device}, "
                             f"the engine on {self.device}")
        self.scfg = serve_cfg
        self.accountant = accountant
        self.scheduler = scheduler or Scheduler(SchedulerConfig())
        self._uid = 0
        # instrumentation: the tests assert one host readback per tick
        self.host_readbacks = 0
        self.last_metrics: Optional[StepMetrics] = None
        self.metrics_log: List[StepMetrics] = []
        self.prefill_wall_s = 0.0
        self._tick_idx = 0
        self.n_finished_ok = 0
        # paged mode: queued uids already checked against the pool size
        self._fit_checked: set = set()
        self._init_runtime(params, cfg)

    def _init_runtime(self, params: PyTree, cfg: tf_lib.LMConfig) -> None:
        """Build the device-resident state and the cost-model scalars."""
        scfg, dev = self.scfg, self.device
        self.params = params
        self.cfg = cfg
        b, cap = scfg.max_slots, scfg.max_len

        def zeros(dtype=torch.int64):
            return torch.zeros(b, dtype=dtype, device=dev)

        if scfg.paged:
            # a shared block pool replaces the per-slot dense cache; the
            # host PagePool owns allocation, refcounts and the prefix
            # registry
            if not tf_lib.paged_supported(cfg):
                raise NotImplementedError(
                    "paged serving is attention-only and incompatible with "
                    "ring caches")
            ps = scfg.page_size
            self._blocks_per_slot = -(-cap // ps)
            n_pages = scfg.num_pages
            if n_pages is None:
                n_pages = b * self._blocks_per_slot
            # block_cost is attached below, once the cost-model scalars
            # exist
            self.pool: Optional[PagePool] = PagePool(
                n_pages, ps, evict_policy=scfg.evict_policy)
            caches = tf_lib.init_paged_caches(cfg, n_pages, ps,
                                              scfg.cache_dtype, device=dev)
            page_table = torch.full((b, self._blocks_per_slot),
                                    self.pool.sink, dtype=torch.int32,
                                    device=dev)
        else:
            self.pool = None
            caches = tf_lib.init_caches(cfg, b, cap, scfg.cache_dtype,
                                        device=dev)
            page_table = torch.zeros((b, 0), dtype=torch.int32, device=dev)
        self.state = DeviceState(
            caches=caches,
            tok=zeros(), pos=zeros(), gen=zeros(), budget=zeros(),
            active=zeros(torch.bool), temp=zeros(torch.float32), uid=zeros(),
            out_buf=torch.zeros((b, cap), dtype=torch.int64, device=dev),
            page_table=page_table)
        # host mirrors (admission + finished-mask readbacks keep them exact)
        self.slot_req: List[Optional[Request]] = [None] * b
        self._host_gen = [0] * b
        self._host_temp = [0.0] * b
        # tensors on the card run the kernels; the gather bill follows
        self._kernel_path = dev.type == "cuda"
        # paged mirrors: pages owned per slot (released at finish) and
        # in-flight chunked prefills {slot: {"req", "plen", "next", ...}}
        self._slot_pages: List[List[int]] = [[] for _ in range(b)]
        self._prefilling: Dict[int, Dict[str, Any]] = {}
        # modeled per-tick traffic/compute from the resident tensors' sizes
        self.weight_bytes = costing.tree_bytes(self.params)
        self.kv_cache_bytes = costing.kv_bytes(self.state.caches)
        self._matmul_elems = costing.matmul_weight_elems(self.params, cfg)
        self._n_attn = costing.attn_layers(cfg)
        self._attn_dims = cfg.n_heads * cfg.resolved_head_dim
        if scfg.paged:
            # KV payload bytes per cached token, for the page-granular
            # traffic model
            self._kv_token_bytes = self.kv_cache_bytes / float(
                (self.pool.num_pages + 1) * scfg.page_size)
            # cost-aware eviction score: recompute FLOPs per resident byte
            # of one block at chain depth d
            ps = scfg.page_size
            block_bytes = self._kv_token_bytes * ps
            self.pool.block_cost = lambda d: costing.block_recompute_flops(
                self._matmul_elems, self._n_attn, self._attn_dims,
                d * ps, ps) / block_bytes

    # -- queue API ------------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_tokens: int = 16,
               temperature: Optional[float] = None) -> int:
        prompt = np.asarray(prompt, np.int32)
        if prompt.size >= self.scfg.max_len:
            raise ValueError(f"prompt length {prompt.size} >= max_len "
                             f"{self.scfg.max_len}")
        if self.pool is not None:
            # a request whose worst-case page demand can never be met would
            # livelock admission (fits() false forever): reject it here
            need = self._pages_needed(prompt.size, max_tokens)
            if need > self.pool.num_pages:
                raise ValueError(
                    f"request needs {need} pages (prompt {prompt.size} + "
                    f"max_tokens {max_tokens}) but the pool has only "
                    f"{self.pool.num_pages}; raise num_pages or lower "
                    f"max_tokens")
        self._uid += 1
        self.scheduler.submit(Request(self._uid, prompt, max_tokens,
                                      temperature,
                                      submit_tick=self._tick_idx))
        return self._uid

    @property
    def queue(self):
        return self.scheduler.pending

    # -- host readback --------------------------------------------------------

    def _readback(self, x: torch.Tensor) -> np.ndarray:
        """Every device->host transfer goes through here (counted: the tick
        hot path must do exactly one — the packed done/bad flags)."""
        self.host_readbacks += 1
        return x.cpu().numpy()

    # -- admission ------------------------------------------------------------

    def _admit(self, toks, lens, slots, budgets, temps, uids, *,
               sampled: bool) -> torch.Tensor:
        """Admission body: ONE padded prefill over the prompt stack, first
        tokens sampled, every admitted slot's cache rows and slot state
        written at once. Returns the (N,) finished-at-admission mask."""
        scfg, st, max_len = self.scfg, self.state, self.scfg.max_len
        logits1, row_caches = tf_lib.prefill(
            self.params, self.cfg, toks, max_len=max_len,
            cache_dtype=scfg.cache_dtype, lengths=lens)
        tok0 = _sample(logits1[:, 0], scfg.seed, uids,
                       torch.zeros_like(uids), temps, sampled=sampled)
        for key, entry in st.caches.items():
            ax = 1 if key.startswith("pat") else 0   # stacked layers lead
            row = row_caches[key]
            for dst, src in ((entry["kv"].k, row["kv"].k),
                             (entry["kv"].v, row["kv"].v),
                             (entry["pos"], row["pos"])):
                dst.index_copy_(ax, slots, src.to(dst.dtype))
        # a request can finish at admission: max_tokens == 1, prompt at the
        # length cap, or the first sampled token being EOS
        done = (budgets <= 1) | (lens >= max_len - 1)
        if scfg.eos_id >= 0:
            done |= tok0 == scfg.eos_id
        st.tok[slots] = tok0
        st.pos[slots] = lens
        st.gen[slots] = 1
        st.budget[slots] = budgets
        st.active[slots] = ~done
        st.temp[slots] = temps
        st.uid[slots] = uids
        st.out_buf[slots] = 0
        st.out_buf[slots, 0] = tok0
        return done

    def _admit_dense(self, finished: List[Request]) -> _AdmitInfo:
        """Batched dense admission: ONE padded prefill + all-slot scatter."""
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        reqs = self.scheduler.select(len(free), now=self._tick_idx)
        if not reqs:
            return _AdmitInfo()
        t0 = time.monotonic()
        lmax = _bucket_len(max(len(r.prompt) for r in reqs),
                           cap=self.scfg.max_len)
        n = len(reqs)
        toks = np.zeros((n, lmax), np.int64)
        lens = np.zeros(n, np.int64)
        temps = np.zeros(n, np.float32)
        for j, req in enumerate(reqs):
            toks[j, :len(req.prompt)] = req.prompt
            lens[j] = len(req.prompt)
            temps[j] = (self.scfg.temperature if req.temperature is None
                        else req.temperature)

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        done = self._admit(
            dev(toks), dev(lens), dev(np.asarray(free[:n], np.int64)),
            dev(np.asarray([r.max_tokens for r in reqs], np.int64)),
            dev(temps), dev(np.asarray([r.uid for r in reqs], np.int64)),
            sampled=bool((temps > 0).any()))
        done_mask = self._readback(done)
        for j, req in enumerate(reqs):
            self.slot_req[free[j]] = req
            self._host_gen[free[j]] = 1
            self._host_temp[free[j]] = float(temps[j])
            if done_mask[j]:
                self._finish_slot(free[j], finished)
        self.prefill_wall_s += time.monotonic() - t0
        return _AdmitInfo(
            admitted=n, prefill_tokens=int(lens.sum()), weight_passes=1,
            kv_bytes=self.kv_cache_bytes * n / self.scfg.max_slots,
            flops=sum(costing.prefill_span_flops(
                self._matmul_elems, self._n_attn, self._attn_dims, 0, int(l))
                for l in lens))

    # -- paged admission ------------------------------------------------------

    def _pages_needed(self, prompt_len: int, max_tokens: int) -> int:
        """Worst-case (no-hit) page demand of a request: its full possible
        context, prompt + budget, capped at max_len."""
        ctx = min(prompt_len + max_tokens, self.scfg.max_len)
        return -(-ctx // self.scfg.page_size)

    def _defer_admission(self, req: Request, hits: List[int], n_hit0: int,
                         n_blocks: int, rest: List[Request]) -> None:
        """The one deferral path for a selected-but-unallocatable paged
        admission: release the retained hit pages, roll back the lookup's
        stats booking (the retry looks up, and books, again) and requeue
        head-of-line."""
        self.pool.release_all(hits)
        self.pool.unbook_lookup(n_hit0, n_blocks)
        self.scheduler.requeue_front([req] + rest)

    def _extend(self, toks, starts, lens, slots, tables, budgets, temps,
                uids, final, *, sampled: bool) -> torch.Tensor:
        """Paged admission body: ONE ``paged_extend`` call advances every
        in-flight prefill by one chunk. Rows whose prompt ends in this chunk
        (``final``) sample their first token and activate their slot;
        mid-chunk rows only record progress (``pos``) and stay inactive, so
        decode ticks interleave with long admissions. ``tables`` is
        ROW-major (row j's pages): ``paged_extend`` indexes its table by
        batch row, and the slot-major state table is written separately —
        handing it the state table would write through another slot's pages
        whenever rows and slots do not line up. Returns the (N,)
        finished-at-admission mask."""
        scfg, st = self.scfg, self.state
        st.page_table[slots] = tables
        logits1, _ = tf_lib.paged_extend(self.params, self.cfg, toks, starts,
                                         lens, tables, st.caches)
        tok0 = _sample(logits1[:, 0], scfg.seed, uids, torch.zeros_like(uids),
                       temps, sampled=sampled)
        end = starts + lens
        done = final & ((budgets <= 1) | (end >= scfg.max_len - 1))
        if scfg.eos_id >= 0:
            done |= final & (tok0 == scfg.eos_id)
        tok0 = torch.where(final, tok0, torch.zeros_like(tok0))
        st.tok[slots] = tok0
        st.pos[slots] = end
        st.gen[slots] = final.long()
        st.budget[slots] = budgets
        st.active[slots] = final & ~done
        st.temp[slots] = temps
        st.uid[slots] = uids
        st.out_buf[slots] = 0
        st.out_buf[slots, 0] = tok0
        return done

    def _admit_paged(self, finished: List[Request]) -> _AdmitInfo:
        """Paged admission tick: select new requests that fit the pool,
        look up their prefix blocks, allocate suffix + decode pages, then
        advance EVERY in-flight prefill (new and continuing) by one chunk in
        a single ``paged_extend`` call. With ``prefill_chunk == 0`` the
        whole suffix lands in one call; with a chunk size, the per-tick
        prefill work is bounded by ``max_slots * prefill_chunk`` tokens."""
        scfg, pool = self.scfg, self.pool
        ps, nb = scfg.page_size, self._blocks_per_slot

        # a queued request whose worst-case demand exceeds the whole pool
        # can never be admitted (FIFO head-of-line livelock); submit()
        # rejects these, but requests can reach the queue directly — fail
        # them fast, once per uid
        def never_fits(r: Request) -> bool:
            if r.uid in self._fit_checked:
                return False
            self._fit_checked.add(r.uid)
            return (self._pages_needed(len(r.prompt), r.max_tokens)
                    > pool.num_pages)

        for req in self.scheduler.drop(never_fits):
            self._fit_checked.discard(req.uid)
            req.done = True
            req.generated = []
            finished.append(req)
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        budget_pages = [pool.available]

        def fits(req: Request) -> bool:
            # conservative: ignores hits (submit() guarantees the demand
            # fits an empty pool, so deferral always terminates); a
            # non-fitting request is not looked up, so it books no stats
            need = self._pages_needed(len(req.prompt), req.max_tokens)
            if need > budget_pages[0]:
                return False
            budget_pages[0] -= need
            return True

        reqs = self.scheduler.select(len(free), fits=fits, now=self._tick_idx)
        admitted = len(reqs)
        hit_tokens = 0
        hit_sq = 0.0
        for j, req in enumerate(reqs):
            self._fit_checked.discard(req.uid)
            slot = free[j]
            plen = len(req.prompt)
            blocks = block_tokens(req.prompt, ps) if scfg.prefix_cache else []
            hits = pool.lookup(blocks)
            n_hit0 = len(hits)
            # at least one suffix token must run to produce the sampling
            # logits, so a fully cached prompt recomputes its last block
            while hits and len(hits) * ps >= plen:
                pool.release(hits.pop())
            shared = len(hits) * ps
            fresh = pool.alloc(self._pages_needed(plen, req.max_tokens)
                               - len(hits))
            if fresh is None:       # the estimate raced capacity: defer
                self._defer_admission(req, hits, n_hit0, len(blocks),
                                      reqs[j + 1:])
                admitted = j
                break
            pages = hits + fresh
            self.slot_req[slot] = req
            self._slot_pages[slot] = pages
            self._prefilling[slot] = {"req": req, "plen": plen,
                                      "next": shared, "blocks": blocks,
                                      "pages": pages}
            hit_tokens += shared
            hit_sq += float(shared) ** 2
        work = sorted(self._prefilling.items())
        if not work:
            return _AdmitInfo(admitted=admitted, prefix_hit_tokens=hit_tokens)
        t0 = time.monotonic()
        # with chunking off, the implicit chunk is capped where dense
        # prefill switches to q-chunked attention, as in JAX
        chunk_cap = scfg.prefill_chunk or min(scfg.max_len,
                                              layers._CHUNKED_SDPA_THRESHOLD)
        call_lens = [min(w["plen"] - w["next"], chunk_cap) for _, w in work]
        n, width = len(work), max(call_lens)
        toks = np.zeros((n, width), np.int64)
        starts = np.zeros(n, np.int64)
        lens = np.asarray(call_lens, np.int64)
        tables = np.full((n, nb), pool.sink, np.int32)
        budgets = np.zeros(n, np.int64)
        temps = np.zeros(n, np.float32)
        uids = np.zeros(n, np.int64)
        final = np.zeros(n, bool)
        for j, ((slot, w), clen) in enumerate(zip(work, call_lens)):
            req = w["req"]
            toks[j, :clen] = req.prompt[w["next"]:w["next"] + clen]
            starts[j] = w["next"]
            budgets[j] = req.max_tokens
            temps[j] = (scfg.temperature if req.temperature is None
                        else req.temperature)
            uids[j] = req.uid
            final[j] = w["next"] + clen >= w["plen"]
            tables[j, :len(w["pages"])] = w["pages"]

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        done = self._extend(
            dev(toks), dev(starts), dev(lens),
            dev(np.asarray([slot for slot, _ in work], np.int64)),
            dev(tables), dev(budgets), dev(temps), dev(uids), dev(final),
            sampled=bool((temps > 0).any()))
        done_mask = self._readback(done)
        for j, ((slot, w), clen) in enumerate(zip(work, call_lens)):
            if final[j]:
                del self._prefilling[slot]
                self._host_gen[slot] = 1
                self._host_temp[slot] = float(temps[j])
                # publish the prompt's full, now-frozen blocks for reuse,
                # chaining each key through the CANONICAL page publish()
                # returns: two slots computing the same prefix in one tick
                # converge on one chain
                if scfg.prefix_cache:
                    parent = ROOT
                    for bi, block in enumerate(w["blocks"]):
                        parent = pool.publish(w["pages"][bi], parent, block)
                if done_mask[j]:
                    self._finish_slot(slot, finished)
            else:
                w["next"] += clen
        self.prefill_wall_s += time.monotonic() - t0
        computed = int(lens.sum())
        # causal-attention FLOPs of the chunk: end^2 - start^2 per row
        attn_sq = float(((starts + lens) ** 2 - starts ** 2).sum())
        # the cached-window gather bill: what the extend path moves to read
        # KV behind the chunk. On the card K3 reads ceil(start / ps) pages
        # per row; the plain path on the CPU gathers the whole table, billed
        # as the JAX engine's XLA path bills it (every slot row, per call)
        if self._kernel_path:
            gather_tokens = float(sum(-(-int(s) // ps) * ps for s in starts))
        else:
            gather_tokens = float(scfg.max_slots * nb * ps)
        gather_bytes = self._kv_token_bytes * gather_tokens
        return _AdmitInfo(
            admitted=admitted, prefill_tokens=computed, weight_passes=1,
            prefix_hit_tokens=hit_tokens,
            kv_bytes=gather_bytes + self._kv_token_bytes * computed,
            gather_bytes=gather_bytes,
            flops=(2.0 * self._matmul_elems * computed
                   + 2.0 * self._n_attn * self._attn_dims * attn_sq),
            saved_bytes=self._kv_token_bytes * hit_tokens,
            saved_flops=(2.0 * self._matmul_elems * hit_tokens
                         + 2.0 * self._n_attn * self._attn_dims * hit_sq))

    def _maybe_compact(self) -> int:
        """Defragment at most ONE slot's private page suffix per tick. A
        slot qualifies when it is decoding (not mid-prefill), its table's
        fragmentation reaches the threshold, its movable suffix (refcount
        1, unpublished; shared prefix blocks are pinned) is itself
        scattered, and a contiguous free run exists. Returns pages moved."""
        thr = self.scfg.compact_threshold
        if thr <= 0.0 or self.pool is None:
            return 0
        nb, sink = self._blocks_per_slot, self.pool.sink
        for slot, req in enumerate(self.slot_req):
            if req is None or slot in self._prefilling:
                continue
            pages = self._slot_pages[slot]
            if len(pages) < 2 or fragmentation(pages) < thr:
                continue
            lo = self.pool.movable_suffix(pages)
            movable = pages[lo:]
            if len(movable) < 2 or fragmentation(movable) == 0.0:
                continue
            run = self.pool.alloc_run(len(movable))
            if run is None:             # no contiguous free run: next tick
                continue

            def dev(a):
                return torch.tensor(a, dtype=torch.int32, device=self.device)

            tf_lib.move_pages(self.state.caches, dev(movable), dev(run))
            new_pages = pages[:lo] + run
            self.state.page_table[slot] = dev(
                (new_pages + [sink] * nb)[:nb])
            self.pool.release_all(movable)  # private + unkeyed -> free list
            self._slot_pages[slot] = new_pages
            return len(movable)
        return 0

    def _finish_slot(self, slot: int, finished: List[Request]) -> None:
        req = self.slot_req[slot]
        n = self._host_gen[slot]
        toks = self._readback(self.state.out_buf[slot, :n])
        req.generated = [int(t) for t in toks]
        req.done = True
        self.slot_req[slot] = None
        self._host_gen[slot] = 0
        self._host_temp[slot] = 0.0
        if self.pool is not None and self._slot_pages[slot]:
            pages = self._slot_pages[slot]
            if self.scfg.prefix_cache and n > 0:
                # publish the finished stream's full, frozen blocks (prompt
                # and committed generation) BEFORE releasing: release_all
                # frees unpublished pages, so publishing afterwards would
                # certify recyclable pages. The cache holds positions
                # [0, prompt + n - 1): the last generated token's K/V never
                # landed.
                cached = np.concatenate(
                    [np.asarray(req.prompt, np.int64),
                     np.asarray(toks[:n - 1], np.int64)])
                parent = ROOT
                for bi, block in enumerate(
                        block_tokens(cached, self.scfg.page_size)):
                    if bi >= len(pages):
                        break
                    parent = self.pool.publish(pages[bi], parent, block)
            # published blocks park in the pool's LRU (still hittable);
            # private pages free immediately
            self.pool.release_all(pages)
            self._slot_pages[slot] = []
        finished.append(req)
        self.n_finished_ok += 1

    # -- the decode tick ------------------------------------------------------

    def _tick(self, sampled: bool) -> torch.Tensor:
        """One decode step over every slot plus sampling and bookkeeping, all
        on the device. Returns the packed (2, B) int32 ``[done, bad]``."""
        scfg, st = self.scfg, self.state
        if self.pool is not None:
            # dead and prefilling lanes' K/V writes go to the sink page:
            # their table rows may name recycled pages
            logits1, _ = tf_lib.paged_decode_step(
                self.params, self.cfg, st.tok[:, None], st.pos,
                st.page_table, st.caches, active=st.active)
        else:
            logits1, _ = tf_lib.decode_step(self.params, self.cfg,
                                            st.tok[:, None], st.pos,
                                            st.caches)
        logits = logits1[:, 0]                              # (B, V) fp32
        # numerics sentinel: a non-finite logit row makes no progress
        bad = st.active & ~torch.isfinite(logits).all(dim=-1)
        ok = st.active & ~bad
        tok_new = _sample(logits, scfg.seed, st.uid, st.gen, st.temp,
                          sampled=sampled)
        tok_new = torch.where(ok, tok_new, st.tok)
        rows = torch.arange(st.tok.shape[0], device=self.device)
        widx = st.gen.clamp(0, st.out_buf.shape[1] - 1)
        st.out_buf[rows, widx] = torch.where(ok, tok_new,
                                             st.out_buf[rows, widx])
        st.gen += ok
        st.pos += ok
        hit_eos = (tok_new == scfg.eos_id if scfg.eos_id >= 0
                   else torch.zeros_like(ok))
        done = ok & (hit_eos | (st.gen >= st.budget)
                     | (st.pos >= scfg.max_len - 1))
        st.tok = tok_new
        st.active &= ~done & ~bad
        return torch.stack([done, bad]).to(torch.int32)

    def step(self) -> List[Request]:
        """Admit + one decode tick. Returns finished requests."""
        t0 = time.monotonic()
        finished: List[Request] = []
        paged = self.pool is not None
        adm = (self._admit_paged(finished) if paged
               else self._admit_dense(finished))
        moves = self._maybe_compact()
        # decoding slots only: a mid-prefill paged slot holds a slot but
        # decodes nothing until its final chunk
        active = [i for i, r in enumerate(self.slot_req)
                  if r is not None and i not in self._prefilling]
        # live context per decoding slot (prompt + generated so far),
        # captured before finishes clear the slot: the paged KV read bill
        ctx = sum(len(self.slot_req[i].prompt) + self._host_gen[i]
                  for i in active) if paged else 0
        if active:
            packed = self._tick(sampled=any(self._host_temp[i] > 0
                                            for i in active))
            arr = self._readback(packed)    # the ONE hot-path transfer
            done_mask, bad_mask = arr[0].astype(bool), arr[1].astype(bool)
            if bad_mask.any():
                raise RuntimeError(
                    f"non-finite logits in slots {np.nonzero(bad_mask)[0]}; "
                    f"quarantine is not ported yet")
            for i in active:
                self._host_gen[i] += 1
            for i in np.nonzero(done_mask)[0]:
                if (self.slot_req[int(i)] is not None
                        and int(i) not in self._prefilling):
                    self._finish_slot(int(i), finished)
        # modeled traffic/compute: the decode tick streams the weight tree
        # once; the dense tick reads the whole resident KV payload (every
        # slot billed at max_len, as the JAX dense path bills it), the paged
        # tick only the decoding slots' live context, page-granular;
        # admission adds its own prefill bill
        na = len(active)
        wb = kvb = fl = 0.0
        if active:
            wb += self.weight_bytes
            if paged:
                kvb += self._kv_token_bytes * ctx
                fl += costing.decode_tick_flops(
                    self._matmul_elems, self._n_attn, self._attn_dims,
                    ctx, na)
            else:
                kvb += self.kv_cache_bytes
                fl += costing.decode_tick_flops(
                    self._matmul_elems, self._n_attn, self._attn_dims,
                    na * self.scfg.max_len, na)
        if adm.weight_passes:
            wb += self.weight_bytes * adm.weight_passes
        kvb += adm.kv_bytes
        fl += adm.flops
        if moves:
            # each relocated page is one pool read + one pool write
            kvb += 2.0 * moves * self.scfg.page_size * self._kv_token_bytes
        m = StepMetrics(tokens=na, active_slots=na,
                        wall_s=time.monotonic() - t0,
                        prefill_tokens=adm.prefill_tokens,
                        admitted=adm.admitted,
                        queue_depth=len(self.scheduler),
                        weight_bytes=wb, kv_bytes=kvb, flops=fl,
                        prefix_hit_tokens=adm.prefix_hit_tokens,
                        saved_bytes=adm.saved_bytes,
                        saved_flops=adm.saved_flops,
                        prefill_gather_bytes=adm.gather_bytes,
                        compaction_moves=moves)
        self.last_metrics = m
        self.metrics_log.append(m)
        if self.accountant is not None:
            self.accountant.observe_serve(m)
        self._tick_idx += 1
        return finished

    def run_until_drained(self, max_ticks: int = 10000) -> List[Request]:
        done: List[Request] = []
        for _ in range(max_ticks):
            done.extend(self.step())
            if not len(self.scheduler) and all(r is None
                                               for r in self.slot_req):
                break
        return done

    def summary(self) -> Dict[str, float]:
        """Aggregate run stats; every ratio is 0.0 on an empty run.
        ``prefill_wall_s`` is the admission share of ``wall_s``."""
        toks = sum(m.tokens for m in self.metrics_log)
        wall = sum(m.wall_s for m in self.metrics_log)
        out = {"ticks": len(self.metrics_log),
               "decode_tokens": toks,
               "prefill_tokens": sum(m.prefill_tokens
                                     for m in self.metrics_log),
               "wall_s": wall,
               "prefill_wall_s": self.prefill_wall_s,
               "decode_tokens_per_s": toks / wall if wall > 0 else 0.0}
        if self.pool is not None:
            hit = sum(m.prefix_hit_tokens for m in self.metrics_log)
            total = hit + out["prefill_tokens"]
            out["prefix_hit_tokens"] = hit
            out["prefix_hit_rate"] = hit / total if total > 0 else 0.0
            out["saved_bytes"] = sum(m.saved_bytes for m in self.metrics_log)
            out["prefill_gather_bytes"] = sum(m.prefill_gather_bytes
                                              for m in self.metrics_log)
            out["compaction_moves"] = sum(m.compaction_moves
                                          for m in self.metrics_log)
            out["pool_pages"] = self.pool.num_pages
            out["pool_pages_live"] = self.pool.live
            out["pool_hit_rate"] = self.pool.stats.hit_rate
        return out


# -- sampling -----------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash on int64 tensors holding values in [0, 2^32);
    both multipliers are below 2^31, so no product leaves int64's range."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x68E31DA5) & _M32
    return x ^ (x >> 16)


def _uniform(seed: int, uid: torch.Tensor, index: torch.Tensor,
             vocab: int) -> torch.Tensor:
    """(B, vocab) uniforms in (0, 1), a pure function of (seed, uid, token
    index, vocab id): counter-based, so a draw does not depend on the slot
    a request lands in or on the other requests of the batch."""
    key = _mix32(torch.full_like(uid, seed & _M32))
    key = _mix32(key ^ (uid & _M32))
    key = _mix32(key ^ (index & _M32))                      # (B,)
    ids = torch.arange(vocab, dtype=torch.int64, device=uid.device)
    h = _mix32(_mix32(key[:, None] ^ ((ids * 0x9E3779B9) & _M32)[None]))
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def _sample(logits: torch.Tensor, seed: int, uid: torch.Tensor,
            index: torch.Tensor, temp: torch.Tensor, *,
            sampled: bool) -> torch.Tensor:
    """Per-slot sampling: greedy where temp == 0, else Gumbel-max at temp
    with noise keyed on (seed, uid, token index). JAX's threefry bits are
    not reproduced; the distribution is the same. ``sampled`` is the host's
    knowledge that some slot has temp > 0 (no device sync to find out)."""
    greedy = torch.argmax(logits, dim=-1)
    if not sampled:
        return greedy
    u = _uniform(seed, uid, index, logits.shape[-1])
    gumbel = -torch.log(-torch.log(u))
    tsafe = torch.where(temp > 0, temp, torch.ones_like(temp))
    drawn = torch.argmax(logits / tsafe[:, None] + gumbel, dim=-1)
    return torch.where(temp > 0, drawn, greedy)
