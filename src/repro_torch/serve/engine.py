"""Device-resident continuous-batching serve core of the PyTorch port
(mirror of the dense, paged and speculative paths of
``repro.serve.engine``).

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

``ServeConfig.quant="int8"`` serves through the quantized fast path on
either path: the weight tree is quantized to int8 per output channel at
construction (every projection through K4 on the card) and the KV cache or
pool holds int8 codes plus fp32 row scales (K1/K2/K3/K5 in their int8-KV
modes); the byte bills follow the resident codes and scales.

Speculative decode (``ServeConfig.spec_k > 0``, paged only, either quant
mode): each tick drafts ``spec_k`` tokens per slot (``serve/spec.py``: the
``ngram`` drafter over a device-resident token history, or ``oracle``,
``spec_k`` plain paged decode passes through K2), scores them in ONE
``paged_verify_step`` (K5), accepts a prefix plus a correction or bonus
token, and reads back one packed (3, B) ``[done, emitted, bad]`` array.
The bill splits draft and verify. At temperature 0 the streams are the
plain paged engine's.

Copy-on-write forks (paged only): ``submit(..., n_best=n)`` admits ONE
prefill and fans it out to ``n`` slots that share the prompt's committed
pages (``PagePool.fork``); a pre-tick barrier makes every page a tick may
write private to its slot first (``PagePool.cow_write`` plus one
``cow_pages`` call), and the request completes with all ``n`` streams in
``nbest``. Tree speculation (``spec_tree_m = m > 1``) drafts ``m``
branches per greedy slot over forked write windows, folds them into rows
``b * m + j`` of the one ``paged_verify_step`` (K5 at ``m`` times the
rows), commits the branch that emits the most tokens and reads back one
packed (4, B) ``[done, emitted, bad, winner]`` array.

The numerics sentinel: a slot whose logits go non-finite makes no
progress that tick and deactivates itself on the device; the host then
quarantines it (its pages scrubbed and released unpublished) and requeues
a continuation (prompt plus committed tokens, the remaining budget) at
the head of the queue; at finish the caller sees one stream.

The chaos tier (``ServeConfig.faults`` and ``guard``, ``serve/faults.py``):
a seeded ``FaultPlan`` replays NaN or inf logits (a poison vector added
inside the tick, from one resident buffer), KV page corruption, pool
spikes, host stalls, garbled or dropped readbacks and a process kill; the
tick's packed readback is validated and read again on a transport fault.
The degradation ladder's rungs, each off until ``GuardrailConfig`` arms it:
admission retry caps with exponential backoff, per-request deadlines that
shed queued requests, the spec-k backoff on collapsing acceptance, a
compaction pause on a straggling tick, the pool auditor, and in the int8
mode a drift watch against the fp oracle (the params and config before
quantization) that falls back to fp serving once.

The durability tier (``ServeConfig.checkpoint_dir`` and
``checkpoint_interval``, ``serve/snapshot.py``): every submit is written
to a write-ahead journal (fsync'd) before it is acked, every tick appends
a record of the streams it finished, and every ``checkpoint_interval``
ticks the whole engine is snapshotted: the device tensors (caches, slot
state, page table, token history) and every host mirror, in one atomic
``CheckpointManager`` save. ``restore()`` on a fresh engine loads the
latest snapshot into the live tensors, checks it (config fingerprint,
checksum, pool audit and ownership) and replays the journal's tail; a
``process_kill`` is survived that way and does not fire again.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.checkpoint.manager import CheckpointConfig, CheckpointManager
from repro_torch.core import accounting, energy
from repro_torch.models import costing
from repro_torch.models import layers
from repro_torch.models import ssd as ssd_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.serve import spec as spec_lib
from repro_torch.serve.faults import (FaultInjector, FaultPlan,
                                      GuardrailConfig, ProcessKilled,
                                      corrupt_kv_page)
from repro_torch.serve.pages import ROOT, PagePool, block_tokens, fragmentation
from repro_torch.serve.sampling import _sample
from repro_torch.serve.scheduler import Scheduler, SchedulerConfig
from repro_torch.serve.snapshot import (Journal, check_fingerprint,
                                        host_state_dict, install_host_state,
                                        reconcile_ownership)
from repro_torch.train.ft import Ewma

PyTree = Any

# the stream of a fork cancelled at activation (its parent finished on its
# first token): resolved to a copy of stream 0 when the group closes
_FORK_MIRROR = object()


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
    # quantized serving fast path: "none" | "int8". int8 quantizes the
    # weight tree (per-channel scales) AND the KV cache (per-row scales);
    # cache_dtype is then ignored for K/V
    quant: str = "none"
    # speculative multi-token decode on the paged path: draft spec_k tokens
    # per slot per tick, verify them in ONE multi-query pass, commit the
    # accepted prefix plus a correction/bonus token. 0 = off
    spec_k: int = 0
    # "ngram": prompt lookup over each slot's own token history; "oracle":
    # the target model drafts itself greedily (k extra decode passes, the
    # accept-all parity harness)
    spec_drafter: str = "ngram"
    # tree speculation: draft spec_tree_m k-token branches per greedy slot
    # over copy-on-write forked write windows and verify all of them in the
    # one multi-query pass (branches fold into batch rows); the branch that
    # emits the most commits. 1 = linear speculation. Temperature slots keep
    # branch 0 only: multi-branch rejection sampling would need a joint
    # residual scheme to stay unbiased
    spec_tree_m: int = 1
    # chaos tier: a seeded fault schedule to replay against this engine
    # (None = no injection), and the guardrail knobs that arm the
    # degradation ladder's rungs (all-default = the fault-free behavior;
    # the numerics sentinel is always on)
    faults: Optional[FaultPlan] = None
    guard: GuardrailConfig = dataclasses.field(
        default_factory=GuardrailConfig)
    # durability tier: the directory of crash-consistent snapshots and the
    # write-ahead request journal (None = durability off).
    # checkpoint_interval > 0 snapshots the whole engine every N completed
    # ticks: it trades snapshot write J/token against the replay a restore
    # pays (restore_j); 0 = journal only (a restore replays from tick 0)
    checkpoint_dir: Optional[str] = None
    checkpoint_interval: int = 0


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (S,) int32
    max_tokens: int = 16
    temperature: Optional[float] = None   # None -> ServeConfig.temperature
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # per-request deadline: shed from the queue once ``deadline_ticks``
    # engine ticks have passed since ``submit_tick`` without admission
    # (None = wait forever)
    deadline_ticks: Optional[int] = None
    # engine tick at submission (the scheduler's queue-aging term and the
    # deadline read it)
    submit_tick: int = -1
    # n-best sampling over copy-on-write forks: n_best > 1 admits ONE
    # prefill and fans out to n_best slots sharing the prompt's committed
    # pages; the request completes when every fork's stream is in, with
    # ``nbest`` holding them all (``generated`` is stream 0). Fork-internal
    # requests (children, continuations of forks) carry ``fork_group`` (the
    # parent's uid) and their ``fork_idx``; the caller never sees them
    n_best: int = 1
    nbest: Optional[List[List[int]]] = None
    fork_group: Optional[int] = None
    fork_idx: int = 0


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
    # rows re-prefilling a quarantined slot's context bill their share of
    # the above here too
    recovery_tokens: int = 0
    recovery_flops: float = 0.0
    recovery_bytes: float = 0.0


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
    # speculative mode: (B, max_len) token history per slot (prompt +
    # emitted), valid through pos inclusive — hist[b, pos[b]] is the
    # pending token; the ngram drafter's corpus. (B, 0) otherwise.
    hist: torch.Tensor


def cache_tensors(entry) -> List[torch.Tensor]:
    """A dense cache entry's per-slot tensors in a fixed order: K, V,
    their int8 scales when present, the position tags; an SSD entry's
    three conv windows and its SSM state."""
    if "ssd" in entry:
        return entry["ssd"].tensors()
    out = [entry["kv"].k, entry["kv"].v]
    if "kv_scale" in entry:
        out += [entry["kv_scale"].k, entry["kv_scale"].v]
    return out + [entry["pos"]]


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
        if serve_cfg.quant not in ("none", "int8"):
            raise ValueError(f"unknown quant mode {serve_cfg.quant!r}")
        if serve_cfg.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {serve_cfg.spec_k}")
        if serve_cfg.spec_k > 0 and not serve_cfg.paged:
            raise ValueError("speculative decode (spec_k > 0) runs on the "
                             "paged path only; set paged=True")
        if serve_cfg.spec_drafter not in spec_lib.DRAFTERS:
            raise ValueError(f"unknown drafter {serve_cfg.spec_drafter!r}; "
                             f"expected one of {spec_lib.DRAFTERS}")
        if serve_cfg.spec_tree_m < 1:
            raise ValueError(f"spec_tree_m must be >= 1, got "
                             f"{serve_cfg.spec_tree_m}")
        if serve_cfg.spec_tree_m > 1 and serve_cfg.spec_k <= 0:
            raise ValueError("tree speculation (spec_tree_m > 1) rides the "
                             "speculative verify pass; set spec_k > 0")
        if serve_cfg.spec_tree_m > 1 and serve_cfg.spec_drafter != "ngram":
            raise ValueError("tree speculation drafts with the ngram "
                             "drafter only (the oracle drafter is a linear "
                             "parity harness)")
        if serve_cfg.checkpoint_interval < 0:
            raise ValueError(f"checkpoint_interval must be >= 0, got "
                             f"{serve_cfg.checkpoint_interval}")
        if (serve_cfg.checkpoint_interval > 0
                and serve_cfg.checkpoint_dir is None):
            raise ValueError("checkpoint_interval > 0 requires a "
                             "checkpoint_dir to write snapshots into")
        self.device = device_lib.resolve(serve_cfg.device)
        if params["embed"]["w"].device != self.device:
            raise ValueError(f"params live on {params['embed']['w'].device}, "
                             f"the engine on {self.device}")
        # the fp oracle pair (the params and config before quantization, by
        # reference): the drift rung's check and the fp fallback read it
        self._oracle = (params, cfg)
        if serve_cfg.quant == "int8":
            # int8 weight tree + int8 KV cache; an already-quantized tree
            # (the caller ran quantize_lm) passes through
            cfg = dataclasses.replace(cfg, quant=tf_lib.INT8_QUANT)
            params = tf_lib.quantize_lm(params)
        self.scfg = serve_cfg
        self.guard = serve_cfg.guard
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
        # n-best fork groups: group uid -> {"req": parent, "k": fan-out,
        # "streams": {fork index: tokens}}
        self._fork_groups: Dict[int, Dict[str, Any]] = {}
        # quarantine: uid -> the original prompt, budget and the tokens
        # committed before each capture; uids whose re-prefill is still to
        # be billed as recovery
        self._recovery: Dict[int, Dict[str, Any]] = {}
        self._recovering: set = set()
        self.n_quarantined = 0
        self._tick_quarantined = 0
        # the chaos tier's state; it survives the fp fallback's rebuild
        self._injector = (FaultInjector(serve_cfg.faults)
                          if serve_cfg.faults is not None else None)
        self._cur_spec_k = serve_cfg.spec_k
        self._fell_back = False
        self._pending_shed: List[Request] = []
        self._defer_counts: Dict[int, int] = {}
        self._retry_after: Dict[int, int] = {}
        self._tick_wall_ewma = Ewma(alpha=self.guard.ewma_alpha)
        self._accept_ewma = Ewma(alpha=self.guard.ewma_alpha)
        self._drift_ewma = Ewma(alpha=self.guard.ewma_alpha)
        self._compact_pause_until = 0
        self._drift_rr = 0
        self._tick_shed = 0
        self._rb_retries_tick = 0
        self.n_shed = 0
        self.spec_backoffs = 0
        self.fp_fallbacks = 0
        self.drift_checks = 0
        self.compaction_pauses = 0
        self.audit_failures = 0
        self.audit_log: List[str] = []
        self.readback_retries_total = 0
        # the durability tier: snapshot manager and write-ahead journal.
        # Synchronous saves: a snapshot is on disk before the tick after it
        # is journaled as replayable from it
        self._ckpt_mgr: Optional[CheckpointManager] = None
        self._journal: Optional[Journal] = None
        if serve_cfg.checkpoint_dir is not None:
            self._ckpt_mgr = CheckpointManager(CheckpointConfig(
                directory=os.path.join(serve_cfg.checkpoint_dir,
                                       "snapshots"),
                async_save=False))
            self._journal = Journal(os.path.join(serve_cfg.checkpoint_dir,
                                                 "journal.jsonl"))
        # replay mode: journaling and snapshots off, the recompute billed
        # to the restore_* channels
        self._replaying = False
        # ticks at or before this index already fired their process_kill
        # (the crash a restore recovered from); -1 = fresh engine
        self._restore_boundary = -1
        self.snapshots_taken = 0
        self.snapshot_bytes_total = 0.0
        self.journal_bytes_total = 0.0
        self.replayed_ticks = 0
        self.restore_flops = 0.0
        self.restore_bytes = 0.0
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
                    "paged serving is attention-only (no SSD/hybrid) and "
                    "incompatible with ring caches")
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
            page_table=page_table,
            hist=torch.zeros((b, cap if scfg.spec_k > 0 else 0),
                             dtype=torch.int64, device=dev))
        # host mirrors (admission + finished-mask readbacks keep them exact)
        self.slot_req: List[Optional[Request]] = [None] * b
        self._host_gen = [0] * b
        self._host_temp = [0.0] * b
        # tensors on the card run the kernels; the gather bill follows
        self._kernel_path = dev.type == "cuda"
        # an MoE block ranks the routes of every row of a call together, so
        # admission feeds the rows the JAX engine feeds: max_slots rows
        # (padding rows hold token 0, length 0) at the power-of-two width
        self._pad_rows = cfg.has_moe
        # padded prefill needs causal masking to keep each row to itself;
        # an SSM state integrates the padding, so SSD archs admit groups of
        # equal-length prompts, unpadded (engine.py:543-547)
        self._pad_ok = not cfg.has_ssd
        # paged mirrors: pages owned per slot (released at finish) and
        # in-flight chunked prefills {slot: {"req", "plen", "next", ...}}
        self._slot_pages: List[List[int]] = [[] for _ in range(b)]
        self._prefilling: Dict[int, Dict[str, Any]] = {}
        # fork mirrors: child slots reserved for a parent still mid-prefill
        # (kept out of the decoding set until the fork), and parent slot ->
        # its reserved children
        self._fork_wait: Dict[int, int] = {}
        self._fork_children: Dict[int, List[int]] = {}
        # tree speculation: this tick's staged branch windows,
        # slot -> (window_lo, window_hi, [branch pages or None] * (m - 1))
        self._tree_branches: Dict[int, Tuple[int, int, list]] = {}
        # the injector's page holds referenced the previous pool
        self._spike_holds: List[Tuple[int, List[int]]] = []
        # the logit poison every tick adds: resident zeros, written with
        # copy_ on a fault tick only (and zeroed after it), so a healthy
        # tick moves nothing from the host
        self._poison = torch.zeros(b, dtype=torch.float32, device=dev)
        self._poison_dirty = False
        # per-tick copy-on-write and fork bills (reset in step())
        self._tick_cow_bytes = 0.0
        self._tick_cow_copies = 0
        self._tick_forks = 0
        self._tick_fork_saved_bytes = 0.0
        self._tick_fork_saved_flops = 0.0
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
               temperature: Optional[float] = None,
               deadline_ticks: Optional[int] = None,
               n_best: int = 1) -> int:
        prompt = np.asarray(prompt, np.int32)
        if prompt.size >= self.scfg.max_len:
            raise ValueError(f"prompt length {prompt.size} >= max_len "
                             f"{self.scfg.max_len}")
        if self.cfg.has_ssd and prompt.size < self.cfg.ssd_cfg.d_conv - 1:
            # the prefill's conv windows need d_conv - 1 inputs; the
            # reference admits such a prompt and fails in its scatter
            raise ValueError(f"prompt length {prompt.size} < the SSD conv "
                             f"window's {self.cfg.ssd_cfg.d_conv - 1}")
        if deadline_ticks is not None and deadline_ticks <= 0:
            raise ValueError(f"deadline_ticks must be > 0, got "
                             f"{deadline_ticks}")
        if n_best < 1:
            raise ValueError(f"n_best must be >= 1, got {n_best}")
        if n_best > 1 and not self.scfg.paged:
            raise ValueError("n-best sampling forks the paged KV cache; set "
                             "paged=True")
        if n_best > self.scfg.max_slots:
            raise ValueError(f"n_best ({n_best}) exceeds max_slots "
                             f"({self.scfg.max_slots}): every fork of one "
                             f"group decodes concurrently")
        if self.pool is not None:
            # a request whose worst-case page demand can never be met would
            # livelock admission (fits() false forever): reject it here
            need = self._pages_needed_group(prompt.size, max_tokens, n_best)
            if need > self.pool.num_pages:
                raise ValueError(
                    f"request needs {need} pages (prompt {prompt.size} + "
                    f"max_tokens {max_tokens} x n_best {n_best}) but the "
                    f"pool has only {self.pool.num_pages}; raise num_pages "
                    f"or lower max_tokens")
        self._uid += 1
        if self._journal is not None and not self._replaying:
            # the write-ahead contract: the admission is durable (fsync'd)
            # BEFORE it is acked, so an acked request survives any crash
            nb = self._journal.append_submit(
                uid=self._uid, prompt=[int(t) for t in prompt.tolist()],
                max_tokens=max_tokens, temperature=temperature,
                deadline_ticks=deadline_ticks, n_best=n_best,
                tick=self._tick_idx)
            self.journal_bytes_total += nb
            if self.accountant is not None:
                self.accountant.observe_durability(journal_bytes=nb)
        self.scheduler.submit(Request(self._uid, prompt, max_tokens,
                                      temperature,
                                      deadline_ticks=deadline_ticks,
                                      submit_tick=self._tick_idx,
                                      n_best=n_best))
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

    def _checked_readback(self, x: torch.Tensor, validate, tick: int
                          ) -> np.ndarray:
        """The tick's readback with transport-fault detection: the injector
        may drop or garble the host copy (as a real transfer can), and
        ``validate`` knows the packed layout's value domain. A failed check
        reads the unchanged device buffer again, up to
        ``guard.readback_max_retries`` times, then raises."""
        attempt = 0
        while True:
            arr = self._readback(x)
            if self._injector is not None:
                arr = self._injector.filter_readback(arr, tick, attempt)
            if arr is not None and validate(arr):
                return arr
            attempt += 1
            if attempt > self.guard.readback_max_retries:
                raise RuntimeError(
                    f"tick {tick}: readback failed validation "
                    f"{attempt} times")
            self.readback_retries_total += 1
            self._rb_retries_tick += 1

    @staticmethod
    def _validate_plain_packed(arr: np.ndarray) -> bool:
        return (arr.ndim == 2 and arr.shape[0] == 2
                and bool(np.isin(arr, (0, 1)).all()))

    def _validate_spec_packed(self, arr: np.ndarray) -> bool:
        if arr.ndim != 2 or arr.shape[0] != 3:
            return False
        flags_ok = bool(np.isin(arr[(0, 2), :], (0, 1)).all())
        emit_ok = bool(((arr[1] >= 0)
                        & (arr[1] <= self._cur_spec_k + 1)).all())
        return flags_ok and emit_ok

    def _validate_tree_packed(self, arr: np.ndarray) -> bool:
        if arr.ndim != 2 or arr.shape[0] != 4:
            return False
        flags_ok = bool(np.isin(arr[(0, 2), :], (0, 1)).all())
        emit_ok = bool(((arr[1] >= 0)
                        & (arr[1] <= self._cur_spec_k + 1)).all())
        win_ok = bool(((arr[3] >= 0)
                       & (arr[3] < self.scfg.spec_tree_m)).all())
        return flags_ok and emit_ok and win_ok

    # -- the chaos tier: fault application -----------------------------------

    def _apply_host_faults(self, tick: int) -> None:
        """Inject this tick's host-side fault events (the logit poison rides
        the tick instead). Runs before admission, so a pool spike presses
        this tick's admission and a KV flip is what its decode attends."""
        inj = self._injector
        # spike holds expire on schedule whatever else fires
        keep = []
        for expires, pages in self._spike_holds:
            if tick >= expires and self.pool is not None:
                self.pool.release_all(pages)
            else:
                keep.append((expires, pages))
        self._spike_holds = keep
        if inj is None:
            return
        stall = inj.stall_seconds(tick)
        if stall > 0.0:
            time.sleep(stall)
        for ev in inj.events_for(tick):
            if ev.kind == "pool_spike" and self.pool is not None:
                n = min(int(ev.magnitude), self.pool.available)
                if n > 0:
                    held = self.pool.alloc(n)
                    if held is not None:
                        self._spike_holds.append(
                            (tick + max(ev.duration, 1), held))
                        inj.count("pool_spike")
            elif ev.kind == "kv_bitflip" and self.scfg.paged:
                self._inject_kv_bitflip(ev)
            elif ev.kind == "process_kill":
                # the simulated process death: the exception leaves step();
                # a kill at or before the restore boundary is the crash a
                # restore already recovered from and does not fire again
                if ev.tick > self._restore_boundary:
                    inj.count("process_kill")
                    raise ProcessKilled(
                        f"process_kill fault at tick {tick}: engine "
                        f"state is gone; restart from checkpoint_dir "
                        f"via ServeEngine.restore()")

    def _inject_kv_bitflip(self, ev) -> None:
        """Corrupt one K page of a decoding slot, inside its attended
        window, so the sentinel (not luck) must catch it. Only decoding
        slots: a mid-prefill slot's extend readback carries no ``bad``
        lane, and its poisoned logits would go unobserved."""
        ps = self.scfg.page_size
        victims = [i for i, r in enumerate(self.slot_req)
                   if r is not None and i not in self._prefilling]
        if ev.slot in victims:
            victims = [ev.slot]
        for slot in victims:
            pages = self._slot_pages[slot]
            req = self.slot_req[slot]
            n_live = -(-(len(req.prompt) + self._host_gen[slot]) // ps)
            lo = self.pool.movable_suffix(pages)
            cand = [p for j, p in enumerate(pages) if lo <= j < n_live]
            if not cand:
                continue
            corrupt_kv_page(self.state.caches, cand[0])
            self._injector.count("kv_bitflip")
            return

    # -- admission ------------------------------------------------------------

    def _admit(self, toks, lens, slots, budgets, temps, uids, *,
               sampled: bool) -> torch.Tensor:
        """Admission body: ONE padded prefill over the prompt stack, first
        tokens sampled, every admitted slot's cache rows and slot state
        written at once. ``toks`` and ``lens`` may carry padding rows past
        the N admitted ones (``_pad_rows``): they run through the prefill
        and are dropped after it. Returns the (N,) finished-at-admission
        mask."""
        scfg, st, max_len = self.scfg, self.state, self.scfg.max_len
        n = slots.shape[0]
        logits1, row_caches = tf_lib.prefill(
            self.params, self.cfg, toks, max_len=max_len,
            cache_dtype=scfg.cache_dtype,
            lengths=lens if self._pad_ok else None)
        lens = lens[:n]
        tok0 = _sample(logits1[:n, 0], scfg.seed, uids,
                       torch.zeros_like(uids), temps, sampled=sampled)
        for key, entry in st.caches.items():
            ax = 1 if key.startswith("pat") else 0   # stacked layers lead
            for dst, src in zip(cache_tensors(entry),
                                cache_tensors(row_caches[key])):
                dst.index_copy_(ax, slots, src.narrow(ax, 0, n).to(dst.dtype))
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
        if not self._pad_ok:
            # SSD/hybrid archs: only prompts of the first one's length share
            # a prefill, stacked at exactly that length; the rest go back
            n0 = len(reqs[0].prompt)
            self.scheduler.requeue_front([r for r in reqs
                                          if len(r.prompt) != n0])
            reqs = [r for r in reqs if len(r.prompt) == n0]
        lmax = (_bucket_len(max(len(r.prompt) for r in reqs),
                            cap=self.scfg.max_len)
                if self._pad_ok else len(reqs[0].prompt))
        n = len(reqs)
        rows = self.scfg.max_slots if self._pad_rows else n
        toks = np.zeros((rows, lmax), np.int64)
        lens = np.zeros(rows, np.int64)
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
        # recovery bill: dense prefill is single-shot, so a quarantined
        # slot's continuation bills its whole prompt here
        rec_tok, rec_fl, rec_by = 0, 0.0, 0.0
        for req in reqs:
            if req.uid in self._recovering:
                plen = len(req.prompt)
                rec_tok += plen
                rec_fl += costing.prefill_span_flops(
                    self._matmul_elems, self._n_attn, self._attn_dims, 0,
                    plen)
                rec_by += self.kv_cache_bytes / self.scfg.max_slots
                self._recovering.discard(req.uid)
        return _AdmitInfo(
            admitted=n, prefill_tokens=int(lens.sum()), weight_passes=1,
            kv_bytes=self.kv_cache_bytes * n / self.scfg.max_slots,
            flops=sum(costing.prefill_span_flops(
                self._matmul_elems, self._n_attn, self._attn_dims, 0, int(l))
                for l in lens),
            recovery_tokens=rec_tok, recovery_flops=rec_fl,
            recovery_bytes=rec_by)

    # -- paged admission ------------------------------------------------------

    def _pages_needed(self, prompt_len: int, max_tokens: int) -> int:
        """Worst-case (no-hit) page demand of a request: its full possible
        context, prompt + budget, capped at max_len. Speculative mode books
        ``spec_k`` extra tokens: a verify tick writes up to k draft
        positions past the committed length, and booking them keeps those
        writes in the slot's own private pages."""
        ctx = min(prompt_len + max_tokens + self.scfg.spec_k,
                  self.scfg.max_len)
        return -(-ctx // self.scfg.page_size)

    def _tree_extra(self) -> int:
        """Per-slot transient page demand of tree speculation: each of the
        ``spec_tree_m - 1`` extra branches claims a private copy of the
        write window for one tick, at most ``(ps - 1 + k) // ps + 1`` pages
        (the worst alignment of a k+1-token span). Booked by the admission
        gate but never attached to a slot; a pool race at staging drops
        that branch's lane instead of failing."""
        scfg = self.scfg
        if scfg.spec_tree_m <= 1:
            return 0
        ps = scfg.page_size
        return (scfg.spec_tree_m - 1) * ((ps - 1 + scfg.spec_k) // ps + 1)

    def _pages_needed_group(self, prompt_len: int, max_tokens: int,
                            n_best: int) -> int:
        """Worst-case page demand of an ``n_best``-way fork group: the
        parent's full demand plus, per child, a private decode tail (the
        blocks past the shared full prompt blocks, which counts one copy of
        the partial boundary block), plus every member's transient tree
        branch windows."""
        need = self._pages_needed(prompt_len, max_tokens)
        shared_full = prompt_len // self.scfg.page_size
        return (need + (n_best - 1) * (need - shared_full)
                + n_best * self._tree_extra())

    def _defer_admission(self, req: Request, hits: List[int], n_hit0: int,
                         n_blocks: int, rest: List[Request]) -> None:
        """The one deferral path for a selected-but-unallocatable paged
        admission: release the retained hit pages, roll back the lookup's
        stats booking (the retry looks up, and books, again) and requeue
        head-of-line.

        The backpressure rung: with ``guard.admit_max_retries`` set, each
        deferral of a uid counts, and past the cap the request is shed
        instead of retried; with ``guard.admit_backoff`` set, the retry
        waits an exponentially growing number of ticks."""
        self.pool.release_all(hits)
        self.pool.unbook_lookup(n_hit0, n_blocks)
        guard = self.guard
        n = self._defer_counts.get(req.uid, 0) + 1
        self._defer_counts[req.uid] = n
        if guard.admit_max_retries > 0 and n > guard.admit_max_retries:
            self._defer_counts.pop(req.uid, None)
            self._retry_after.pop(req.uid, None)
            self._pending_shed.append(req)
            self.scheduler.requeue_front(rest)
            return
        if guard.admit_backoff > 0:
            delay = min(guard.admit_backoff * 2 ** (n - 1), 32)
            self._retry_after[req.uid] = self._tick_idx + delay
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
        whenever rows and slots do not line up. Padding rows past the N
        in-flight ones (``_pad_rows``: no tokens, sink tables) run through
        the call and are dropped after it. Returns the (N,)
        finished-at-admission mask."""
        scfg, st = self.scfg, self.state
        n = slots.shape[0]
        logits1, _ = tf_lib.paged_extend(self.params, self.cfg, toks, starts,
                                         lens, tables, st.caches)
        toks, starts, lens, tables = toks[:n], starts[:n], lens[:n], tables[:n]
        st.page_table[slots] = tables
        tok0 = _sample(logits1[:n, 0], scfg.seed, uids,
                       torch.zeros_like(uids), temps, sampled=sampled)
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
        if st.hist.shape[1]:
            # speculative mode: mirror the chunk, and the first sampled
            # token of final rows, into the drafter's token history
            c = torch.arange(st.hist.shape[1], device=self.device)[None]
            rel = c - starts[:, None]
            chunk = toks.gather(1, rel.clamp(0, toks.shape[1] - 1))
            row = torch.where((rel >= 0) & (rel < lens[:, None]), chunk,
                              st.hist[slots])
            st.hist[slots] = torch.where(final[:, None] & (c == end[:, None]),
                                         tok0[:, None], row)
        return done

    def _admit_paged(self, finished: List[Request]) -> _AdmitInfo:
        """Paged admission tick: select new requests that fit the pool,
        look up their prefix blocks, allocate suffix + decode pages, then
        advance EVERY in-flight prefill (new and continuing) by one chunk in
        a single ``paged_extend`` call. With ``prefill_chunk == 0`` the
        whole suffix lands in one call; with a chunk size, the per-tick
        prefill work is bounded by ``max_slots * prefill_chunk`` tokens. An
        n-best request books its whole fork group (its ``n_best`` slots and
        the group's worst-case pages) in one decision and forks at its
        final chunk."""
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
            return (self._pages_needed_group(len(r.prompt), r.max_tokens,
                                             r.n_best)
                    > pool.num_pages)

        for req in self.scheduler.drop(never_fits):
            self._fit_checked.discard(req.uid)
            req.done = True
            req.generated = []
            if req.n_best > 1:
                req.nbest = [[] for _ in range(req.n_best)]
            finished.append(req)
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        budget_pages = [pool.available]
        budget_slots = [len(free)]

        def fits(req: Request) -> bool:
            # the backoff gate: a deferred request sits out its retry
            # window before it takes any page budget
            if self._retry_after.get(req.uid, 0) > self._tick_idx:
                return False
            # conservative: ignores hits (submit() guarantees the demand
            # fits an empty pool, so deferral always terminates); a
            # non-fitting request is not looked up, so it books no stats
            need = self._pages_needed_group(len(req.prompt), req.max_tokens,
                                            req.n_best)
            if need > budget_pages[0] or req.n_best > budget_slots[0]:
                return False
            budget_pages[0] -= need
            budget_slots[0] -= req.n_best
            return True

        reqs = self.scheduler.select(len(free), fits=fits, now=self._tick_idx)
        admitted = len(reqs)
        hit_tokens = 0
        hit_sq = 0.0
        # slots assign from a pool: an n-best parent takes its own slot and
        # one reserved slot per child
        slot_pool = list(free)
        for j, req in enumerate(reqs):
            self._fit_checked.discard(req.uid)
            slot = slot_pool[0]
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
            # admitted: the backpressure bookkeeping clears
            self._defer_counts.pop(req.uid, None)
            self._retry_after.pop(req.uid, None)
            slot_pool.pop(0)
            self.slot_req[slot] = req
            self._slot_pages[slot] = pages
            self._prefilling[slot] = {"req": req, "plen": plen,
                                      "next": shared, "blocks": blocks,
                                      "pages": pages}
            if req.n_best > 1:
                # mint and reserve the children now: they hold slots (kept
                # out of decode by _fork_wait) until the parent's final
                # chunk, where _fork_slots fans the committed pages out
                req.fork_group = req.uid
                req.fork_idx = 0
                self._fork_groups[req.uid] = {"req": req, "k": req.n_best,
                                              "streams": {}}
                kids = [slot_pool.pop(0) for _ in range(req.n_best - 1)]
                self._fork_children[slot] = kids
                for i, kid in enumerate(kids):
                    self._uid += 1
                    self.slot_req[kid] = Request(
                        self._uid, req.prompt, req.max_tokens,
                        req.temperature, fork_group=req.uid,
                        fork_idx=i + 1, submit_tick=self._tick_idx)
                    self._fork_wait[kid] = slot
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
        n, width, rows = len(work), max(call_lens), len(work)
        if self._pad_rows:
            width = _bucket_len(width, cap=chunk_cap)
            rows = scfg.max_slots
        toks = np.zeros((rows, width), np.int64)
        starts = np.zeros(rows, np.int64)
        lens = np.zeros(rows, np.int64)
        lens[:n] = call_lens
        tables = np.full((rows, nb), pool.sink, np.int32)
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
        # the recovery bill: rows re-prefilling a quarantined slot's
        # context bill their share of this call apart, with the same
        # formulas as the call's bill below, per row
        rec_tok, rec_fl, rec_by = 0, 0.0, 0.0
        for j, ((slot, w), clen) in enumerate(zip(work, call_lens)):
            uid = w["req"].uid
            if uid in self._recovering:
                rec_tok += clen
                rec_fl += costing.prefill_span_flops(
                    self._matmul_elems, self._n_attn, self._attn_dims,
                    int(starts[j]), clen)
                row_gather = (-(-int(starts[j]) // ps) * ps
                              if self._kernel_path else nb * ps)
                rec_by += self._kv_token_bytes * (row_gather + clen)
                if final[j]:
                    self._recovering.discard(uid)
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
                kids = self._fork_children.pop(slot, None)
                if done_mask[j]:
                    if kids is not None:
                        self._cancel_fork(slot, kids)
                    self._finish_slot(slot, finished)
                elif kids is not None:
                    # the prompt's KV is committed and the first token
                    # sampled: fan the group out
                    self._fork_slots(slot, kids)
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
                         + 2.0 * self._n_attn * self._attn_dims * hit_sq),
            recovery_tokens=rec_tok, recovery_flops=rec_fl,
            recovery_bytes=rec_by)

    def _maybe_compact(self) -> int:
        """Defragment at most ONE slot's private page suffix per tick. A
        slot qualifies when it is decoding (not mid-prefill), its table's
        fragmentation reaches the threshold, its movable suffix (refcount
        1, unpublished; shared prefix blocks are pinned) is itself
        scattered, and a contiguous free run exists. Returns pages moved."""
        thr = self.scfg.compact_threshold
        if thr <= 0.0 or self.pool is None:
            return 0
        # the latency-pressure rung: a straggling tick pauses this
        # deferrable work for a window
        if self._tick_idx < self._compact_pause_until:
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

    # -- quarantine: the numerics sentinel's recovery ------------------------

    def _scrub_slot_storage(self, slot: int) -> None:
        """Zero the K/V storage a quarantined slot may have poisoned. A bad
        tick writes non-finite K/V into the slot's private pages, and a NaN
        in V leaks through masked attention (probability 0 times NaN is
        NaN), so a freed page would poison its next owner: free storage
        must never hold NaN. Shared prefix pages are clean by construction
        and skipped. A rare-path in-place fill, not tick work."""
        if self.pool is not None:
            pages = self._slot_pages[slot]
            lo = self.pool.movable_suffix(pages)
            self._scrub_pages(pages[lo:])
        else:
            self._scrub_sel([slot])

    def _scrub_pages(self, pages: List[int]) -> None:
        """Zero pool pages about to be freed that belong to no slot's list
        (a flagged tree tick's branch windows): free storage is never NaN."""
        if pages:
            self._scrub_sel(pages)

    def _scrub_sel(self, sel: List[int]) -> None:
        """Zero K/V (and the int8 scales) at ``sel``: pool pages on the
        paged path, the slots' whole cache rows on the dense one (the dense
        layout has B where the pool has pages). SSD state is left as it
        is, as in the reference: the slot's next admission overwrites all
        of it."""
        idx = torch.tensor(sel, dtype=torch.long, device=self.device)
        for key, entry in self.state.caches.items():
            ax = 1 if key.startswith("pat") else 0  # stacked layers lead
            for name in ("kv", "kv_scale"):
                if name in entry:
                    entry[name].k.index_fill_(ax, idx, 0)
                    entry[name].v.index_fill_(ax, idx, 0)

    def _capture_slot(self, slot: int) -> Request:
        """Freeze a live slot into a continuation request that carries its
        committed progress: its prompt is the original prompt plus the
        committed tokens (read back here, off the hot path), its budget
        what remains. The original prompt and budget park in
        ``_recovery[uid]`` and come back at finish, so the caller sees one
        stream; the re-prefill is billed as recovery."""
        req = self.slot_req[slot]
        g = self._host_gen[slot]
        toks = ([int(t) for t in self._readback(self.state.out_buf[slot, :g])]
                if g > 0 else [])
        rec = self._recovery.setdefault(
            req.uid, {"prompt": req.prompt, "max_tokens": req.max_tokens,
                      "tokens": []})
        rec["tokens"].extend(toks)
        cont = Request(
            req.uid,
            np.concatenate([np.asarray(rec["prompt"], np.int32),
                            np.asarray(rec["tokens"], np.int32)]),
            max_tokens=max(rec["max_tokens"] - len(rec["tokens"]), 1),
            temperature=req.temperature,
            deadline_ticks=req.deadline_ticks, submit_tick=self._tick_idx,
            # a captured fork member stays a member (its finish banks into
            # the group) but never forks again (n_best stays 1)
            fork_group=req.fork_group, fork_idx=req.fork_idx)
        self._recovering.add(req.uid)
        self.slot_req[slot] = None
        self._host_gen[slot] = 0
        self._host_temp[slot] = 0.0
        self._prefilling.pop(slot, None)
        self._fork_wait.pop(slot, None)
        kids = self._fork_children.pop(slot, None)
        if kids is not None:
            # children reserved but never forked (the parent captured mid-
            # prefill): requeue them as independent admissions; their
            # streams still bank into the group, only the sharing is lost
            requeue = []
            for kid in kids:
                child = self.slot_req[kid]
                self.slot_req[kid] = None
                self._fork_wait.pop(kid, None)
                if child is not None:
                    child.submit_tick = self._tick_idx
                    requeue.append(child)
            self.scheduler.requeue_front(requeue)
        self._scrub_slot_storage(slot)
        if self.pool is not None and self._slot_pages[slot]:
            # released unpublished: a faulted slot's pages may hold corrupt
            # KV, and unkeyed they are rewritten before any lookup can hit
            self.pool.release_all(self._slot_pages[slot])
            self._slot_pages[slot] = []
        return cont

    def _quarantine_slot(self, slot: int) -> None:
        """Sentinel hit: tear the slot down and requeue its continuation at
        the head of the queue. The slot made no progress on the bad tick,
        so the continuation resumes exactly at the last committed token."""
        self.scheduler.requeue_front([self._capture_slot(slot)])
        self.n_quarantined += 1
        self._tick_quarantined += 1

    def _shed_request(self, req: Request, finished: List[Request]) -> None:
        """Fail a request fast (deadline expiry or admission retries spent):
        it completes with whatever tokens its recovery already banked, and
        never silently vanishes."""
        rec = self._recovery.pop(req.uid, None)
        if rec is not None:
            req.prompt = rec["prompt"]
            req.max_tokens = rec["max_tokens"]
            req.generated = list(rec["tokens"])
        else:
            req.generated = []
        self._recovering.discard(req.uid)
        self._defer_counts.pop(req.uid, None)
        self._retry_after.pop(req.uid, None)
        self._fit_checked.discard(req.uid)
        req.done = True
        if req.fork_group is not None:
            # a shed fork member still reports: the group must close
            self._record_fork_stream(req.fork_group, req.fork_idx,
                                     req.generated, finished)
        elif req.n_best > 1:
            # shed before its admission forked (no group exists): the
            # caller still sees an n-best-shaped result
            req.nbest = [list(req.generated) for _ in range(req.n_best)]
            finished.append(req)
        else:
            finished.append(req)
        self.n_shed += 1
        self._tick_shed += 1

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
                # landed. A continuation's prompt is the original prompt
                # plus the recovered tokens, which is the stream's content.
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
        # recovery merge last: the original prompt and budget come back and
        # the recovered tokens go in front, so the caller sees one stream
        rec = self._recovery.pop(req.uid, None)
        if rec is not None:
            req.prompt = rec["prompt"]
            req.max_tokens = rec["max_tokens"]
            req.generated = list(rec["tokens"]) + req.generated
            self._recovering.discard(req.uid)
        if req.fork_group is not None:
            # a fork-group member banks its stream into the group; the
            # caller receives the parent once every fork has reported
            self._record_fork_stream(req.fork_group, req.fork_idx,
                                     req.generated, finished)
        else:
            finished.append(req)
        self.n_finished_ok += 1

    # -- copy-on-write forks and tree speculation ----------------------------

    def _cow_call(self, events: List[Tuple[int, int, int, int, int]]
                  ) -> None:
        """Apply ``(src, dst, slot, blk, entry)`` page events in ONE
        ``cow_pages`` call, padded to a power-of-two count with sink->sink
        copies and out-of-range slot ids. ``src == dst == sink`` rows move
        only the table entry; out-of-range slot rows copy only the page (a
        branch window that no table row owns)."""
        n = _bucket_len(len(events))
        sink, nslots = self.pool.sink, self.scfg.max_slots
        ev = np.zeros((5, n), np.int64)
        ev[:] = np.array([sink, sink, nslots + 1, 0, sink])[:, None]
        ev[:, :len(events)] = np.asarray(events, np.int64).T
        src, dst, sl, bl, en = torch.from_numpy(ev).to(self.device)
        tf_lib.cow_pages(self.state.caches, self.state.page_table, src, dst,
                         sl, bl, en)

    def _fork_slots(self, parent_slot: int, kids: List[int]) -> None:
        """Activate a fork group: fork the parent's committed prompt pages
        into each child's table (no bytes move), give each child a private
        decode tail, then copy the parent's slot row to every child in one
        device call. A child whose tail loses a pool race is requeued as an
        independent admission: its stream still banks into the group."""
        scfg = self.scfg
        ps, nb, sink = scfg.page_size, self._blocks_per_slot, self.pool.sink
        parent = self.slot_req[parent_slot]
        plen = len(parent.prompt)
        pages = self._slot_pages[parent_slot]
        # blocks holding committed prompt KV (the last may be partial:
        # shared under copy-on-write, each diverging writer copies it at
        # the barrier)
        n_shared = -(-plen // ps)
        tail = len(pages) - n_shared
        dsts, tables, uids, requeue = [], [], [], []
        for kid in kids:
            child = self.slot_req[kid]
            self._fork_wait.pop(kid, None)
            shared = self.pool.fork(pages[:n_shared])
            fresh = self.pool.alloc(tail)
            if fresh is None:
                self.pool.release_all(shared)
                self.slot_req[kid] = None
                child.submit_tick = self._tick_idx
                requeue.append(child)
                continue
            kid_pages = shared + fresh
            self._slot_pages[kid] = kid_pages
            self._host_gen[kid] = 1
            self._host_temp[kid] = self._host_temp[parent_slot]
            dsts.append(kid)
            tables.append((kid_pages + [sink] * nb)[:nb])
            uids.append(child.uid)
            # the duplicate-KV bill this fork did not pay: an independent
            # admission of the same stream would re-prefill the prompt
            self._tick_forks += 1
            self._tick_fork_saved_bytes += self._kv_token_bytes * plen
            self._tick_fork_saved_flops += costing.prefill_span_flops(
                self._matmul_elems, self._n_attn, self._attn_dims, 0, plen)
        if requeue:
            self.scheduler.requeue_front(requeue)
        if dsts:
            self._fork_rows(parent_slot, dsts, tables, uids)

    def _fork_rows(self, src: int, dsts: List[int], tables: List[List[int]],
                   uids: List[int]) -> None:
        """The fork's device call: the parent's slot row (pending token,
        position, counts, budget, temperature, output buffer, drafter
        history) to every child, each child's own table, and each child's
        own uid, which keys its draws from here on."""
        st, dev = self.state, self.device
        d = torch.tensor(dsts, dtype=torch.long, device=dev)
        for t in (st.tok, st.pos, st.gen, st.budget, st.active, st.temp,
                  st.out_buf, st.hist):
            t[d] = t[src].clone()
        st.page_table[d] = torch.tensor(tables, dtype=st.page_table.dtype,
                                        device=dev)
        st.uid[d] = torch.tensor(uids, dtype=st.uid.dtype, device=dev)

    def _cancel_fork(self, parent_slot: int, kids: List[int]) -> None:
        """The parent finished at activation (budget 1, or EOS on its first
        token): every fork would replay the same one-token stream, so the
        reserved child slots free and the group banks mirror streams,
        resolved against stream 0 when the parent's finish records it."""
        g = self._fork_groups.get(self.slot_req[parent_slot].fork_group)
        for kid in kids:
            child = self.slot_req[kid]
            self.slot_req[kid] = None
            self._fork_wait.pop(kid, None)
            if g is not None and child is not None:
                g["streams"][child.fork_idx] = _FORK_MIRROR

    def _record_fork_stream(self, gid: int, idx: int, toks: List[int],
                            finished: List[Request]) -> None:
        """Bank one fork's finished stream into its group; once every fork
        has reported, the parent request completes with ``nbest`` holding
        all streams in fork order (``generated`` is stream 0)."""
        g = self._fork_groups.get(gid)
        if g is None:
            return
        g["streams"][idx] = toks
        s = g["streams"]
        if len(s) < g["k"]:
            return
        base = s.get(0, [])
        streams = [list(base) if s.get(i, []) is _FORK_MIRROR
                   else list(s.get(i, [])) for i in range(g["k"])]
        parent = g["req"]
        parent.nbest = streams
        parent.generated = streams[0]
        parent.done = True
        del self._fork_groups[gid]
        finished.append(parent)

    def _cow_barrier(self, active: List[int]) -> List[int]:
        """The pre-tick write barrier: every block the coming tick may
        write (positions ``[pos, pos + spec_k]`` of each decoding slot)
        must be private to its slot. A shared (forked) or published page
        is replaced by ``PagePool.cow_write``; a block with committed
        content is copied (billed as copy-on-write traffic), one without it
        moves in the table only. All events go in one ``cow_pages`` call. A
        slot whose copy finds the pool exhausted has its device lane
        deactivated first (so the tick cannot write the shared page) and is
        then quarantined. Returns the decoding slots that remain."""
        ps, k, sink = self.scfg.page_size, self._cur_spec_k, self.pool.sink
        events: List[Tuple[int, int, int, int, int]] = []
        drop: List[int] = []
        for slot in active:
            pages = self._slot_pages[slot]
            pos = len(self.slot_req[slot].prompt) + self._host_gen[slot] - 1
            for blk in range(pos // ps,
                             min((pos + k) // ps, len(pages) - 1) + 1):
                p = pages[blk]
                if self.pool.writable(p):
                    continue
                res = self.pool.cow_write(p)
                if res is None:
                    drop.append(slot)
                    break
                new, copied = res
                pages[blk] = new
                if copied:
                    self._tick_cow_copies += 1
                    self._tick_cow_bytes += 2.0 * ps * self._kv_token_bytes
                # committed content below pos is copied; a later block holds
                # nothing yet, so only its table entry moves
                if blk * ps < pos:
                    events.append((p, new, slot, blk, new))
                else:
                    events.append((sink, sink, slot, blk, new))
        for slot in drop:
            self.state.active[slot] = False
            self._quarantine_slot(slot)
        if drop:
            events = [e for e in events if e[2] not in drop]
            active = [s for s in active if s not in drop]
        if events:
            self._cow_call(events)
        return active

    def _prepare_tree(self, active: List[int]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stage this tick's branch windows: each greedy decoding slot's
        ``spec_tree_m - 1`` extra branches each get a forked table row
        whose write-window blocks are fresh private pages. Only the
        boundary block holds committed KV (the barrier just made it
        private), so at most one page a branch is copied, in one
        ``cow_pages`` call, billed as copy-on-write traffic. A pool race
        drops that branch's lane. Returns the device ``(btables, bvalid)``;
        the staged pages wait in ``_tree_branches`` for ``_commit_tree``."""
        scfg = self.scfg
        m, k, ps = scfg.spec_tree_m, self._cur_spec_k, scfg.page_size
        nslots, nb = scfg.max_slots, self._blocks_per_slot
        sink = self.pool.sink
        btables = np.full((nslots, m - 1, nb), sink, np.int32)
        bvalid = np.zeros((nslots, m - 1), bool)
        self._tree_branches = {}
        events: List[Tuple[int, int, int, int, int]] = []
        for slot in active:
            if self._host_temp[slot] > 0.0:
                # temperature slots keep the distribution-exact linear path
                # on branch 0
                continue
            pages = self._slot_pages[slot]
            pos = len(self.slot_req[slot].prompt) + self._host_gen[slot] - 1
            wlo = pos // ps
            whi = min((pos + k) // ps, len(pages) - 1)
            row = (pages + [sink] * nb)[:nb]
            branches: List[Optional[List[int]]] = []
            for i in range(m - 1):
                bp = self.pool.alloc(whi - wlo + 1)
                branches.append(bp)
                if bp is None:
                    continue
                btables[slot, i] = row[:wlo] + bp + row[whi + 1:]
                bvalid[slot, i] = True
                if pos > wlo * ps:
                    # the boundary block's committed KV, which the branch
                    # attends through its own table (no table row owns
                    # branch pages: an out-of-range slot id)
                    events.append((pages[wlo], bp[0], nslots + 1, 0, sink))
                    self._tick_cow_copies += 1
                    self._tick_cow_bytes += 2.0 * ps * self._kv_token_bytes
            self._tree_branches[slot] = (wlo, whi, branches)
        if events:
            self._cow_call(events)
        return (torch.from_numpy(btables).to(self.device),
                torch.from_numpy(bvalid).to(self.device))

    def _commit_tree(self, bad_mask: np.ndarray, winners: np.ndarray
                     ) -> None:
        """Resolve the staged branches from the packed winner row: the
        winner's window pages join the slot's page list (the device table
        switched inside the tick), the pages they replace (private and
        unpublished after the barrier) free, and every losing branch is
        released. A sentinel-flagged slot adopts nothing, and its branch
        pages are scrubbed before release: the bad verify pass wrote non-
        finite KV into them."""
        for slot, (wlo, whi, branches) in self._tree_branches.items():
            w, bad = int(winners[slot]), bool(bad_mask[slot])
            for i, bp in enumerate(branches):
                if bp is None:
                    continue
                if not bad and w == i + 1:
                    pages = self._slot_pages[slot]
                    old = pages[wlo:whi + 1]
                    pages[wlo:whi + 1] = bp
                    self.pool.release_all(old)
                else:
                    if bad:
                        self._scrub_pages(bp)
                    self.pool.release_all(bp)
        self._tree_branches = {}

    # -- the decode tick ------------------------------------------------------

    def _tick(self, sampled: bool, poison: torch.Tensor) -> torch.Tensor:
        """One decode step over every slot plus sampling and bookkeeping, all
        on the device; ``poison`` (B,) is added to each slot's logits (zeros
        unless a logit fault fires). Returns the packed (2, B) int32
        ``[done, bad]``."""
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
        logits = logits1[:, 0] + poison[:, None]            # (B, V) fp32
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

    def _spec_tick(self, sampled: bool, poison: torch.Tensor
                   ) -> torch.Tensor:
        """One speculative tick on the device: draft ``spec_k`` tokens per
        slot, verify them with the pending token in ONE
        ``paged_verify_step``, accept a prefix plus a correction or bonus
        token, clamp the run at the budget, the context cap and EOS, and
        write the output buffer and the history. Returns the packed (3, B)
        int32 ``[done, emitted, bad]``."""
        scfg, st = self.scfg, self.state
        k = self._cur_spec_k
        active = st.active
        if scfg.spec_drafter == "oracle":
            # the target model drafts itself greedily: k plain decode
            # passes; the verify pass rewrites the same positions with the
            # same values
            d_list = []
            tok_j, pos_j = st.tok, st.pos
            for _ in range(k):
                lg, _ = tf_lib.paged_decode_step(
                    self.params, self.cfg, tok_j[:, None], pos_j,
                    st.page_table, st.caches, active=active)
                nxt = torch.argmax(lg[:, 0], dim=-1)
                d_list.append(nxt)
                tok_j = torch.where(active, nxt, tok_j)
                pos_j = pos_j + active
            drafts = torch.stack(d_list, dim=1)             # (B, K)
        else:
            drafts = spec_lib.ngram_draft(st.hist, st.pos, k)
        chunk = torch.cat([st.tok[:, None], drafts], dim=1)
        logits, _ = tf_lib.paged_verify_step(
            self.params, self.cfg, chunk, st.pos, st.page_table, st.caches,
            active=active)                                   # (B, K+1, V)
        logits = logits + poison[:, None, None]
        # numerics sentinel over the whole q-block: a non-finite logit in
        # any lane voids the slot's tick
        bad = active & ~torch.isfinite(logits).flatten(1).all(dim=1)
        ok = active & ~bad
        n_acc, fix_tok = spec_lib.speculative_accept(
            logits, drafts, st.temp, seed=scfg.seed, uid=st.uid, gen=st.gen,
            sampled=sampled)
        emitted, n_emit = self._runs(n_acc, fix_tok, drafts)
        done, n_step = self._commit_run(emitted, n_emit, ok, bad)
        return torch.stack([done.to(torch.int32), n_step.to(torch.int32),
                            bad.to(torch.int32)])

    def _tree_tick(self, sampled: bool, poison: torch.Tensor,
                   btables: torch.Tensor, bvalid: torch.Tensor
                   ) -> torch.Tensor:
        """One tree-speculative tick on the device: draft ``m`` branches
        per slot, fold them into rows ``b * m + j`` of ONE
        ``paged_verify_step`` over the branch tables (branch 0 on the
        slot's own table; the others valid only where the host staged pages
        and the slot is greedy), accept per branch, and commit the branch
        that emits the most (the first such, so a tie is the linear tick),
        with its table swapped in. Returns the packed (4, B) int32
        ``[done, emitted, bad, winner]``."""
        scfg, st = self.scfg, self.state
        k, m = self._cur_spec_k, scfg.spec_tree_m
        b = st.tok.shape[0]
        active = st.active
        drafts = spec_lib.ngram_draft_tree(st.hist, st.pos, k, m)  # (B,M,K)
        valid = torch.cat([torch.ones_like(bvalid[:, :1]),
                           bvalid & (st.temp <= 0.0)[:, None]], dim=1)
        tables = torch.cat([st.page_table[:, None], btables], dim=1)
        chunk = torch.cat([st.tok[:, None, None].expand(b, m, 1), drafts],
                          dim=2)                              # (B, M, K+1)
        logits, _ = tf_lib.paged_verify_step(
            self.params, self.cfg, chunk.reshape(b * m, k + 1),
            st.pos.repeat_interleave(m), tables.reshape(b * m, -1),
            st.caches, active=(active[:, None] & valid).reshape(b * m))
        # a slot's poison reaches every one of its branch rows
        logits = logits + poison.repeat_interleave(m)[:, None, None]
        # sentinel: a non-finite logit in ANY valid branch voids the slot's
        # tick (committed-KV corruption hits every branch alike)
        fin = torch.isfinite(logits).flatten(1).all(dim=1).view(b, m)
        bad = active & (valid & ~fin).any(dim=1)
        ok = active & ~bad
        # per-branch accept: branch 0 keeps the slot's temperature, the
        # extra branches are greedy and draw nothing
        temp_f = torch.cat([st.temp[:, None],
                            torch.zeros_like(st.temp)[:, None].expand(
                                b, m - 1)], dim=1)
        n_acc, fix = spec_lib.speculative_accept(
            logits, drafts.reshape(b * m, k), temp_f.reshape(b * m),
            seed=scfg.seed, uid=st.uid.repeat_interleave(m),
            gen=st.gen.repeat_interleave(m), sampled=sampled)
        emitted, n_emit = self._runs(n_acc.view(b, m), fix.view(b, m),
                                     drafts)
        w = torch.where(valid, n_emit, 0).argmax(dim=1)         # (B,)
        rows = torch.arange(b, device=self.device)
        done, n_step = self._commit_run(emitted[rows, w], n_emit[rows, w],
                                        ok, bad)
        # the winner's window pages become the slot's in the tick; the
        # host mirrors the swap from the packed winner row
        st.page_table.copy_(torch.where(ok[:, None], tables[rows, w],
                                        st.page_table))
        return torch.stack([done.to(torch.int32), n_step.to(torch.int32),
                            bad.to(torch.int32),
                            torch.where(ok, w, 0).to(torch.int32)])

    def _runs(self, n_acc: torch.Tensor, fix: torch.Tensor,
              drafts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The run each slot (or branch: leading dims (B, M)) would emit,
        (..., K+1), and its length: the accepted drafts plus the correction
        or bonus token, never past the token budget or the context cap
        (exactly where the plain tick would have stopped), cut after an
        EOS."""
        st, k = self.state, self._cur_spec_k
        rem = torch.minimum(st.budget - st.gen,
                            self.scfg.max_len - 1 - st.pos)
        rem = rem.view(rem.shape + (1,) * (n_acc.dim() - 1))
        n_emit = torch.minimum(n_acc + 1, rem).clamp(1, k + 1)
        t_idx = torch.arange(k + 1, device=self.device)
        drafts_pad = torch.cat([drafts, torch.zeros_like(drafts[..., :1])],
                               dim=-1)
        emitted = torch.where(t_idx < n_acc[..., None], drafts_pad,
                              fix[..., None])
        eos_id = self.scfg.eos_id
        if eos_id >= 0:
            # an EOS anywhere in the emitted run ends it there
            eos_lane = torch.where(emitted == eos_id, t_idx,
                                   k + 1).amin(dim=-1)
            n_emit = torch.minimum(n_emit, eos_lane + 1)
        return emitted, n_emit

    def _commit_run(self, emitted: torch.Tensor, n_emit: torch.Tensor,
                    ok: torch.Tensor, bad: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Write each good slot's run (B, K+1) of ``n_emit`` tokens to the
        output buffer and the history, advance the slot, set its done flag
        and deactivate done and bad slots. Returns ``(done, n_step)``."""
        st, k = self.state, self._cur_spec_k
        n_step = torch.where(ok, n_emit, torch.zeros_like(n_emit))

        def commit(buf, first):
            # columns [first, first + n_step) of each row take the run
            c = torch.arange(buf.shape[1], device=self.device)[None]
            rel = c - first[:, None]
            run = emitted.gather(1, rel.clamp(0, k))
            buf.copy_(torch.where((rel >= 0) & (rel < n_step[:, None]), run,
                                  buf))

        commit(st.out_buf, st.gen)
        commit(st.hist, st.pos + 1)
        last = emitted.gather(1, (n_emit - 1).clamp(min=0)[:, None])[:, 0]
        tok_new = torch.where(ok, last, st.tok)
        st.pos += n_step
        st.gen += n_step
        hit_eos = (tok_new == self.scfg.eos_id if self.scfg.eos_id >= 0
                   else torch.zeros_like(ok))
        done = ok & (hit_eos | (st.gen >= st.budget)
                     | (st.pos >= self.scfg.max_len - 1))
        st.tok = tok_new
        st.active &= ~done & ~bad
        return done, n_step

    # -- the degradation ladder's rungs ---------------------------------------

    def _maybe_spec_backoff(self, accepted: int, n_ok: int) -> None:
        """The acceptance-collapse rung: EWMA the tick's draft acceptance
        rate; when it sinks below the threshold, halve spec-k. It never
        climbs back within a run."""
        guard = self.guard
        if guard.spec_backoff_threshold <= 0.0 or self._cur_spec_k <= 1:
            return
        if n_ok <= 0:
            return
        self._accept_ewma.update(accepted / float(self._cur_spec_k * n_ok))
        if (self._accept_ewma.n >= guard.spec_backoff_window
                and self._accept_ewma.value < guard.spec_backoff_threshold):
            self._cur_spec_k = max(1, self._cur_spec_k // 2)
            self.spec_backoffs += 1
            self._accept_ewma = Ewma(alpha=guard.ewma_alpha)

    def _maybe_pause_compaction(self, wall_s: float) -> None:
        """The latency-pressure rung: EWMA the tick's wall time; a tick
        slower than ``stall_factor`` x the smoothed baseline pauses
        compaction (the tick's one deferrable piece of work) for a
        window."""
        guard = self.guard
        prev = self._tick_wall_ewma.value
        seen = self._tick_wall_ewma.n
        self._tick_wall_ewma.update(wall_s)
        if guard.stall_factor <= 0.0 or seen < 3 or prev is None:
            return
        if (wall_s > guard.stall_factor * prev
                and self._tick_idx + 1 >= self._compact_pause_until):
            self._compact_pause_until = (self._tick_idx + 1
                                         + guard.compact_pause_ticks)
            self.compaction_pauses += 1

    def _drift_check(self) -> None:
        """The quantization-drift rung: replay ONE decoding greedy slot's
        last token through the fp oracle (a teacher-forced prefill of the
        prompt and the committed tokens but the last) and compare its
        argmax with what the engine emitted. A disagreement EWMA above
        ``drift_threshold`` triggers the fp fallback."""
        guard = self.guard
        cands = [i for i, r in enumerate(self.slot_req)
                 if r is not None and i not in self._prefilling
                 and self._host_gen[i] >= 2
                 and (r.temperature if r.temperature is not None
                      else self.scfg.temperature) == 0.0]
        if not cands:
            return
        slot = cands[self._drift_rr % len(cands)]
        self._drift_rr += 1
        req = self.slot_req[slot]
        g = self._host_gen[slot]
        toks = self._readback(self.state.out_buf[slot, :g])
        o_params, o_cfg = self._oracle
        seq = np.concatenate([np.asarray(req.prompt, np.int64),
                              toks[:-1].astype(np.int64)])
        lg, _ = tf_lib.prefill(o_params, o_cfg,
                               torch.from_numpy(seq[None]).to(self.device),
                               cache_dtype=torch.float32)
        want = int(torch.argmax(lg[0, -1]))
        self.drift_checks += 1
        self._drift_ewma.update(0.0 if want == int(toks[-1]) else 1.0)
        if (self._drift_ewma.n >= guard.drift_min_checks
                and self._drift_ewma.value > guard.drift_threshold):
            self._fallback_to_fp()

    def _fallback_to_fp(self) -> None:
        """The int8 -> fp fallback: capture every live slot as a
        continuation, requeue them at the head of the queue, and rebuild the
        runtime (pool, caches, slot state) from the fp oracle pair. One-way:
        quantization drift makes every later token suspect. The int8 pool,
        caches and weights are dropped before the fp runtime allocates."""
        if self._fell_back:
            return
        conts: List[Request] = []
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            conts.append(self._capture_slot(slot))
        self.scheduler.requeue_front(conts)
        self.fp_fallbacks += 1
        self._fell_back = True
        self._drift_ewma = Ewma(alpha=self.guard.ewma_alpha)
        self.state = self.params = self.pool = None
        self._init_runtime(*self._oracle)

    def _run_audit(self) -> None:
        """The pool auditor: the pool's own invariants plus the ownership
        reconciliation (every page's refcount covers its appearances across
        the slots' page lists and the injector's spike holds; no slot lists
        a page twice). Violations are recorded, never raised."""
        violations = self.pool.audit()
        violations += reconcile_ownership(self.pool, self._slot_pages,
                                          self._spike_holds)
        if violations:
            self.audit_failures += len(violations)
            self.audit_log.extend(
                f"tick {self._tick_idx}: {v}" for v in violations)

    # -- the engine tick ------------------------------------------------------

    def _tick_poison(self, tick: int, active: List[int]) -> torch.Tensor:
        """This tick's logit poison: the resident buffer, which holds zeros
        unless a logit fault fires now (then the injector's vector is
        copied in, and the buffer is zeroed on the device after the
        tick)."""
        if self._poison_dirty:
            self._poison.zero_()
            self._poison_dirty = False
        if self._injector is not None:
            pv = self._injector.logit_poison(tick, active,
                                             self.scfg.max_slots)
            if pv is not None:
                self._poison.copy_(torch.from_numpy(pv))
                self._poison_dirty = True
        return self._poison

    def step(self) -> List[Request]:
        """Admit + one decode tick. Returns finished requests."""
        t0 = time.monotonic()
        tick = self._tick_idx
        finished: List[Request] = []
        self._tick_shed = 0
        self._tick_quarantined = 0
        self._rb_retries_tick = 0
        self._tick_cow_bytes = 0.0
        self._tick_cow_copies = 0
        self._tick_forks = 0
        self._tick_fork_saved_bytes = 0.0
        self._tick_fork_saved_flops = 0.0
        inj0 = (self._injector.faults_injected
                if self._injector is not None else 0)
        # deadline shedding: queued requests whose wait passed their
        # deadline complete failed-fast before any admission work
        for req in self.scheduler.drop(
                lambda r: (r.deadline_ticks is not None
                           and r.submit_tick >= 0
                           and tick - r.submit_tick > r.deadline_ticks)):
            self._shed_request(req, finished)
        # host-side faults land before admission
        self._apply_host_faults(tick)
        paged = self.pool is not None
        adm = (self._admit_paged(finished) if paged
               else self._admit_dense(finished))
        # admission retries spent: shed what _defer_admission queued
        for req in self._pending_shed:
            self._shed_request(req, finished)
        self._pending_shed = []
        moves = self._maybe_compact()
        # decoding slots only: a mid-prefill paged slot and a fork child
        # reserved for a parent still in prefill hold a slot but decode
        # nothing yet
        active = [i for i, r in enumerate(self.slot_req)
                  if r is not None and i not in self._prefilling
                  and i not in self._fork_wait]
        if paged and active:
            # the copy-on-write barrier: every page this tick writes is
            # private to its slot before the tick runs
            active = self._cow_barrier(active)
        # live context per decoding slot (prompt + generated so far),
        # captured before finishes clear the slot: the paged KV read bill
        ctx = sum(len(self.slot_req[i].prompt) + self._host_gen[i]
                  for i in active) if paged else 0
        spec_k, tree_m = self._cur_spec_k, self.scfg.spec_tree_m
        emitted = len(active)       # decode tokens this tick (plain: 1/slot)
        accepted = 0
        if active:
            sampled = any(self._host_temp[i] > 0 for i in active)
            poison = self._tick_poison(tick, active)
            # the ONE hot-path transfer, validated: a garbled or dropped
            # copy is read again from the unchanged device buffer. Rows:
            # [done, bad] plain; [done, emitted, bad] speculative;
            # [done, emitted, bad, winner] on a tree
            if tree_m > 1:
                # stage the branch windows, run the folded verify, then
                # resolve the winners' pages on the host
                packed = self._tree_tick(sampled, poison,
                                         *self._prepare_tree(active))
                arr = self._checked_readback(
                    packed, self._validate_tree_packed, tick)
            elif spec_k > 0:
                packed = self._spec_tick(sampled, poison)
                arr = self._checked_readback(
                    packed, self._validate_spec_packed, tick)
            else:
                packed = self._tick(sampled, poison)
                arr = self._checked_readback(
                    packed, self._validate_plain_packed, tick)
            done_mask = arr[0].astype(bool)
            bad_mask = arr[1 if spec_k == 0 else 2].astype(bool)
            if tree_m > 1:
                self._commit_tree(bad_mask, arr[3])
            if spec_k > 0:
                # a bad slot's emitted count is 0: it made no progress
                n_emit = arr[1]
                emitted = int(n_emit.sum())
                accepted = int(np.maximum(n_emit - 1, 0).sum())
            else:
                n_emit = (~bad_mask).astype(np.int64)
                emitted = int(sum(n_emit[i] for i in active))
            for i in active:
                self._host_gen[i] += int(n_emit[i])
            for i in np.nonzero(done_mask)[0]:
                if (self.slot_req[int(i)] is not None
                        and int(i) not in self._prefilling):
                    self._finish_slot(int(i), finished)
            # flagged slots made no progress and deactivated themselves on
            # the device: quarantine them (teardown and a continuation at
            # the head of the queue); the other slots' streams are untouched
            n_bad = int(sum(1 for i in active if bad_mask[i]))
            for i in np.nonzero(bad_mask)[0]:
                if (self.slot_req[int(i)] is not None
                        and int(i) not in self._prefilling):
                    self._quarantine_slot(int(i))
            if spec_k > 0:
                self._maybe_spec_backoff(accepted, len(active) - n_bad)
        # modeled traffic/compute: the decode tick streams the weight tree
        # once; the dense tick reads the whole resident KV payload (every
        # slot billed at max_len, as the JAX dense path bills it), the paged
        # tick only the decoding slots' live context, page-granular;
        # admission adds its own prefill bill. The speculative tick bills
        # draft and verify apart: the verify pass streams the weights ONCE
        # for k + 1 lanes per slot and reads the live context plus the
        # lanes' write and read-back; the ngram drafter scans one int32
        # history row per slot, the oracle streams the weights k times. A
        # tree folds m branch rows per slot into the one verify pass: m
        # times the row compute and KV traffic, still one weight stream
        na = len(active)
        wb = kvb = fl = 0.0
        d_fl = d_by = v_fl = v_by = 0.0
        if active and spec_k > 0:
            width = spec_k + 1
            v_fl = costing.spec_verify_flops(
                self._matmul_elems, self._n_attn, self._attn_dims,
                ctx * tree_m, na * tree_m, width)
            v_kv = self._kv_token_bytes * (ctx + 2.0 * width * na) * tree_m
            v_by = self.weight_bytes + v_kv
            if self.scfg.spec_drafter == "oracle":
                d_fl = costing.spec_oracle_draft_flops(
                    self._matmul_elems, self._n_attn, self._attn_dims, ctx,
                    na, spec_k)
                d_kv = self._kv_token_bytes * (
                    spec_k * ctx + na * spec_k * (spec_k - 1) / 2.0)
                d_wb = spec_k * self.weight_bytes
            else:
                d_kv = 4.0 * self.scfg.max_len * na * tree_m
                d_wb = 0.0
            d_by = d_wb + d_kv
            wb += self.weight_bytes + d_wb
            kvb += v_kv + d_kv
            fl += v_fl + d_fl
        elif active:
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
        # copy-on-write copies (barrier and tree boundary) are page traffic,
        # also broken out on their own channel
        kvb += self._tick_cow_bytes
        # the periodic detection rungs (rare paths, off the hot tick and
        # bounded by their intervals)
        guard = self.guard
        if (guard.drift_check_interval > 0 and not self._fell_back
                and self.scfg.quant == "int8"
                and tick % guard.drift_check_interval == 0):
            self._drift_check()
        if (guard.audit_interval > 0 and paged
                and tick % guard.audit_interval == 0):
            self._run_audit()
        degraded = int(self._cur_spec_k != self.scfg.spec_k
                       or self._fell_back
                       or tick < self._compact_pause_until)
        wall = time.monotonic() - t0
        self._maybe_pause_compaction(wall)
        m = StepMetrics(tokens=emitted, active_slots=na, wall_s=wall,
                        prefill_tokens=adm.prefill_tokens,
                        admitted=adm.admitted,
                        queue_depth=len(self.scheduler),
                        weight_bytes=wb, kv_bytes=kvb, flops=fl,
                        prefix_hit_tokens=adm.prefix_hit_tokens,
                        saved_bytes=adm.saved_bytes,
                        saved_flops=adm.saved_flops,
                        spec_draft_tokens=spec_k * na,
                        spec_accepted_tokens=accepted,
                        draft_flops=d_fl, draft_bytes=d_by,
                        verify_flops=v_fl, verify_bytes=v_by,
                        prefill_gather_bytes=adm.gather_bytes,
                        compaction_moves=moves,
                        faults_injected=(
                            self._injector.faults_injected - inj0
                            if self._injector is not None else 0),
                        quarantined=self._tick_quarantined,
                        shed=self._tick_shed,
                        recovery_tokens=adm.recovery_tokens,
                        recovery_flops=adm.recovery_flops,
                        recovery_bytes=adm.recovery_bytes,
                        degraded=degraded,
                        readback_retries=self._rb_retries_tick,
                        cow_bytes=self._tick_cow_bytes,
                        cow_copies=self._tick_cow_copies,
                        forks=self._tick_forks,
                        fork_saved_bytes=self._tick_fork_saved_bytes,
                        fork_saved_flops=self._tick_fork_saved_flops)
        self.last_metrics = m
        self.metrics_log.append(m)
        if self.accountant is not None:
            self.accountant.observe_serve(m)
        self._tick_idx += 1
        if self._replaying:
            # replayed recompute is real work, already billed through
            # observe_serve; restore_j breaks the same joules out as the
            # recovery cost of a crash
            self.replayed_ticks += 1
            self.restore_flops += m.flops
            self.restore_bytes += m.bytes_moved
            if self.accountant is not None:
                self.accountant.observe_durability(
                    restore_flops=m.flops, restore_bytes=m.bytes_moved,
                    replayed_ticks=1)
        elif self._journal is not None:
            # the tick record first (replay needs every tick, idle ones
            # too: fault schedules and deadlines key on the absolute tick),
            # THEN the snapshot, whose journal_seq cut must sit after this
            # tick's record so that replay resumes exactly at _tick_idx
            d_journal = self._journal.append_tick(
                tick=tick,
                finished=[[r.uid,
                           [int(t) for t in r.generated],
                           ([[int(t) for t in s] for s in r.nbest]
                            if r.nbest is not None else None)]
                          for r in finished])
            self.journal_bytes_total += d_journal
            d_snapshot = 0
            if (self.scfg.checkpoint_interval > 0
                    and self._tick_idx % self.scfg.checkpoint_interval
                    == 0):
                d_snapshot = self._write_snapshot()
            if self.accountant is not None:
                self.accountant.observe_durability(
                    journal_bytes=d_journal, snapshot_bytes=d_snapshot,
                    snapshots=1 if d_snapshot else 0)
        return finished

    def run_until_drained(self, max_ticks: int = 10000) -> List[Request]:
        """Step until nothing is queued or live. Always steps once before
        it looks, as the JAX engine does: an engine with no work left gets
        one idle tick."""
        done: List[Request] = []
        for _ in range(max_ticks):
            done.extend(self.step())
            if not len(self.scheduler) and all(r is None
                                               for r in self.slot_req):
                break
        return done

    # -- durability: crash-consistent snapshot and journal replay -------------

    def _device_tree(self) -> Dict[str, Any]:
        """The device state as a dict of the live tensors under stable
        names (``caches/<block>/k``, ``.../v``, ``.../k_scale``,
        ``.../v_scale``, ``.../pos``; an SSD block's ``.../conv_x``,
        ``.../conv_b``, ``.../conv_c``, ``.../ssm``; ``tok``,
        ``page_table``, ``hist``, ...): the checkpoint manager's tree."""
        st = self.state
        caches = {}
        for block, entry in st.caches.items():
            if "ssd" in entry:
                caches[block] = dict(zip(ssd_lib.SSD_LEAVES,
                                         entry["ssd"].tensors()))
                continue
            leaves = {"k": entry["kv"].k, "v": entry["kv"].v}
            if "kv_scale" in entry:
                leaves["k_scale"] = entry["kv_scale"].k
                leaves["v_scale"] = entry["kv_scale"].v
            if "pos" in entry:
                leaves["pos"] = entry["pos"]
            caches[block] = leaves
        tree: Dict[str, Any] = {"caches": caches}
        for f in dataclasses.fields(DeviceState):
            if f.name != "caches":
                tree[f.name] = getattr(st, f.name)
        return tree

    def _write_snapshot(self) -> int:
        """Persist a crash-consistent checkpoint of the whole engine: the
        device tensors plus every host mirror (``host_state_dict``) in one
        atomic CheckpointManager save. ``journal_seq`` marks the replay
        cut: journal records below it are baked into this snapshot, and
        restore replays everything from it on. Returns the bytes written
        (billed as durability DRAM traffic)."""
        step = self._tick_idx
        extra = host_state_dict(self)
        extra["journal_seq"] = self._journal.seq
        self._ckpt_mgr.save(step, self._device_tree(), extra=extra)
        d = self._ckpt_mgr._step_dir(step)
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for f in os.listdir(d))
        self.snapshots_taken += 1
        self.snapshot_bytes_total += nbytes
        return nbytes

    def _load_snapshot(self, step: int) -> Dict[str, Any]:
        """Load snapshot ``step`` into the live device tensors (``copy_``:
        the tensors other structures hold, such as the split kernels'
        cached workspace's users, are never rebound) and install its host
        state. The loaded host copy is dropped afterwards. Returns the
        manifest's ``extra``."""
        live = self._device_tree()
        _, loaded, extra = self._ckpt_mgr.restore(step, target=live,
                                                  device="cpu")

        def copy_into(dst, src):
            if isinstance(dst, dict):
                for key in dst:
                    copy_into(dst[key], src[key])
            else:
                dst.copy_(src)

        with torch.no_grad():
            copy_into(live, loaded)
        temps = loaded["temp"].tolist()
        del loaded
        install_host_state(self, extra)
        # the sampling mode's host mirror, from the slots' device
        # temperatures (zero for an empty slot, as a finish leaves it)
        self._host_temp = [float(t) if r is not None else 0.0
                           for t, r in zip(temps, self.slot_req)]
        return extra

    def restore(self) -> List[Request]:
        """Warm restart from disk: load the latest snapshot (if any), then
        replay the journal's tail deterministically. Must be called on a
        FRESH engine built with the same ServeConfig and ``checkpoint_dir``
        as the dead one. Replayed ticks repeat the original run (seeded
        sampler, sorted host iteration, seeded fault plans); a divergence
        or a corrupted snapshot raises rather than serving other streams.

        Returns every request finished up to now: the pre-crash finishes
        rebuilt from the journal and those the replay produced. Delivery is
        at-least-once: a caller that already streamed pre-crash results
        dedupes by uid."""
        if self._ckpt_mgr is None or self._journal is None:
            raise RuntimeError("restore() requires checkpoint_dir")
        if self._tick_idx != 0 or self.metrics_log or len(self.scheduler):
            raise RuntimeError("restore() must run on a fresh engine — "
                               "this one has already ticked or admitted")
        journal_seq = 0
        step = self._ckpt_mgr.latest_step()
        if step is not None:
            extra = self._ckpt_mgr.peek_extra(step)
            # the config gate FIRST: a snapshot of another configuration is
            # diagnosed as such, not as a shape mismatch halfway through
            check_fingerprint(self.scfg, extra.get("fingerprint", {}))
            if extra.get("fell_back") and not self._fell_back:
                # the snapshot's device tensors are the fp runtime's:
                # rebuild it from the fp oracle before loading, as the
                # fallback does (the int8 pool and caches dropped first)
                self._fell_back = True
                self.state = self.params = self.pool = None
                gc.collect()
                self._init_runtime(*self._oracle)
            extra = self._load_snapshot(step)
            journal_seq = int(extra.get("journal_seq", 0))
            if self.scfg.paged:
                # snapshot load shares the auditor's reconciliation, but
                # here a violation refuses: restoring inconsistent
                # ownership would corrupt streams
                violations = self.pool.audit()
                violations += reconcile_ownership(
                    self.pool, self._slot_pages, self._spike_holds)
                if violations:
                    raise RuntimeError(
                        "snapshot failed consistency check: "
                        + "; ".join(violations))
        recovered: List[Request] = []
        submits: Dict[int, dict] = {}
        post: List[dict] = []
        for rec in self._journal.records():
            if rec["kind"] == "submit":
                submits[int(rec["uid"])] = rec
            if rec["seq"] < journal_seq:
                if rec["kind"] == "tick":
                    # pre-snapshot finishes: rebuild the completed requests
                    # so the caller sees every result as the dead engine
                    # emitted it
                    for uid, gen, nbest in rec["finished"]:
                        s = submits[int(uid)]
                        recovered.append(Request(
                            int(uid),
                            np.asarray(s["prompt"], np.int32),
                            max_tokens=int(s["max_tokens"]),
                            temperature=s["temperature"],
                            generated=[int(t) for t in gen],
                            done=True,
                            deadline_ticks=s["deadline_ticks"],
                            submit_tick=int(s["tick"]),
                            n_best=int(s["n_best"]),
                            nbest=([[int(t) for t in st] for st in nbest]
                                   if nbest is not None else None)))
            else:
                post.append(rec)
        self._replaying = True
        try:
            for rec in post:
                if rec["kind"] == "submit":
                    uid = self.submit(
                        np.asarray(rec["prompt"], np.int32),
                        max_tokens=int(rec["max_tokens"]),
                        temperature=rec["temperature"],
                        deadline_ticks=rec["deadline_ticks"],
                        n_best=int(rec["n_best"]))
                    if uid != int(rec["uid"]):
                        raise RuntimeError(
                            f"replay diverged: journaled submit uid "
                            f"{rec['uid']}, replay assigned {uid}")
                else:
                    if int(rec["tick"]) != self._tick_idx:
                        raise RuntimeError(
                            f"replay diverged: journal at tick "
                            f"{rec['tick']}, engine at {self._tick_idx}")
                    fins = self.step()
                    got = {int(r.uid): ([int(t) for t in r.generated],
                                        ([[int(t) for t in st]
                                          for st in r.nbest]
                                         if r.nbest is not None else None))
                           for r in fins}
                    want = {int(u): ([int(t) for t in g],
                                     ([[int(t) for t in st] for st in nb]
                                      if nb is not None else None))
                            for u, g, nb in rec["finished"]}
                    if got != want:
                        raise RuntimeError(
                            f"replay diverged at tick {rec['tick']}: "
                            f"journaled finishes {sorted(want)} vs "
                            f"replayed {sorted(got)} (or streams differ)")
                    recovered.extend(fins)
        finally:
            self._replaying = False
        # kills at or before this tick already happened before the crash; a
        # surviving fault plan must not fire them again (a crash loop)
        self._restore_boundary = self._tick_idx
        return recovered

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
            # the fork economy: copies are paid traffic, fork_saved_* the
            # duplicate-KV bill the forks did not pay
            for key in ("cow_bytes", "cow_copies", "forks",
                        "fork_saved_bytes", "fork_saved_flops"):
                out[key] = sum(getattr(m, key) for m in self.metrics_log)
            out["pool_forked_pages"] = self.pool.stats.forked_pages
            out["pool_cow_copies"] = self.pool.stats.cow_copies
        if self.scfg.spec_k > 0:
            drafted = sum(m.spec_draft_tokens for m in self.metrics_log)
            accepted = sum(m.spec_accepted_tokens for m in self.metrics_log)
            slot_ticks = sum(m.active_slots for m in self.metrics_log)
            out["spec_draft_tokens"] = drafted
            out["spec_accepted_tokens"] = accepted
            out["accept_rate"] = accepted / drafted if drafted > 0 else 0.0
            # emitted decode tokens per slot-tick (plain decode: 1.0)
            out["accepted_tokens_per_tick"] = (
                toks / slot_ticks if slot_ticks > 0 else 0.0)
            out["spec_backoffs"] = self.spec_backoffs
            out["spec_k_current"] = self._cur_spec_k
        # the chaos tier: every ratio guards its denominator (0.0 on an
        # empty or fully shed run)
        n_ticks = len(self.metrics_log)
        done_total = self.n_shed + self.n_finished_ok
        rec_fl = sum(m.recovery_flops for m in self.metrics_log)
        rec_by = sum(m.recovery_bytes for m in self.metrics_log)
        out["faults_injected"] = sum(m.faults_injected
                                     for m in self.metrics_log)
        out["quarantined"] = self.n_quarantined
        out["quarantine_rate"] = (self.n_quarantined / n_ticks
                                  if n_ticks > 0 else 0.0)
        out["shed"] = self.n_shed
        out["shed_rate"] = (self.n_shed / done_total
                            if done_total > 0 else 0.0)
        out["recovery_tokens"] = sum(m.recovery_tokens
                                     for m in self.metrics_log)
        out["recovery_j"] = (energy.compute_energy_j(rec_fl)
                             + energy.dram_energy_j(rec_by))
        out["recovery_j_per_token"] = (out["recovery_j"] / toks
                                       if toks > 0 else 0.0)
        out["degraded_ticks"] = sum(m.degraded for m in self.metrics_log)
        out["readback_retries"] = self.readback_retries_total
        out["fp_fallbacks"] = self.fp_fallbacks
        out["compaction_pauses"] = self.compaction_pauses
        out["audit_failures"] = self.audit_failures
        # the durability tier: all 0.0 on an engine that never checkpoints
        out["snapshots_taken"] = self.snapshots_taken
        out["snapshot_bytes"] = self.snapshot_bytes_total
        out["journal_bytes"] = self.journal_bytes_total
        out["replayed_ticks"] = self.replayed_ticks
        out["restore_j"] = (energy.compute_energy_j(self.restore_flops)
                            + energy.dram_energy_j(self.restore_bytes))
        out["restore_j_per_token"] = (out["restore_j"] / toks
                                      if toks > 0 else 0.0)
        out["durability_write_j"] = energy.dram_energy_j(
            self.snapshot_bytes_total + self.journal_bytes_total)
        return out
