"""Device-resident continuous-batching serve core of the PyTorch port
(mirror of the dense path of ``repro.serve.engine``).

submit -> ``Scheduler`` -> padded admission prefill -> one decode tick ->
one host readback -> ``StepMetrics`` -> ``CarbonAccountant``.

The decode tick runs the batched decode step over the shared slot-major KV
cache (per-slot positions, so decode attention is the K1 kernel on the
card), samples, advances tokens and positions, sets EOS/budget/length done
flags and writes a device-side output buffer. The host reads back ONE
packed (2, B) ``[done, bad]`` array per tick; generated tokens leave the
device only when a request finishes. Where the JAX engine donates its
``DeviceState`` to a jitted tick, this engine updates the same tensors in
place; PyTorch runs eagerly, so there is no trace to count.

Not ported yet (ROADMAP queue 1): the paged pool, int8, speculative decode,
copy-on-write forks, the chaos tier and durability. A slot whose logits go
non-finite therefore raises instead of being quarantined.
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
from repro_torch.models import transformer as tf_lib
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
        self._init_runtime(params, cfg)

    def _init_runtime(self, params: PyTree, cfg: tf_lib.LMConfig) -> None:
        """Build the device-resident state and the cost-model scalars."""
        scfg, dev = self.scfg, self.device
        self.params = params
        self.cfg = cfg
        b, cap = scfg.max_slots, scfg.max_len

        def zeros(dtype=torch.int64):
            return torch.zeros(b, dtype=dtype, device=dev)

        self.state = DeviceState(
            caches=tf_lib.init_caches(cfg, b, cap, scfg.cache_dtype,
                                      device=dev),
            tok=zeros(), pos=zeros(), gen=zeros(), budget=zeros(),
            active=zeros(torch.bool), temp=zeros(torch.float32), uid=zeros(),
            out_buf=torch.zeros((b, cap), dtype=torch.int64, device=dev))
        # host mirrors (admission + finished-mask readbacks keep them exact)
        self.slot_req: List[Optional[Request]] = [None] * b
        self._host_gen = [0] * b
        self._host_temp = [0.0] * b
        # modeled per-tick traffic/compute from the resident tensors' sizes
        self.weight_bytes = costing.tree_bytes(self.params)
        self.kv_cache_bytes = costing.kv_bytes(self.state.caches)
        self._matmul_elems = costing.matmul_weight_elems(self.params, cfg)
        self._n_attn = costing.attn_layers(cfg)
        self._attn_dims = cfg.n_heads * cfg.resolved_head_dim

    # -- queue API ------------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_tokens: int = 16,
               temperature: Optional[float] = None) -> int:
        prompt = np.asarray(prompt, np.int32)
        if prompt.size >= self.scfg.max_len:
            raise ValueError(f"prompt length {prompt.size} >= max_len "
                             f"{self.scfg.max_len}")
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

    def _finish_slot(self, slot: int, finished: List[Request]) -> None:
        req = self.slot_req[slot]
        n = self._host_gen[slot]
        toks = self._readback(self.state.out_buf[slot, :n])
        req.generated = [int(t) for t in toks]
        req.done = True
        self.slot_req[slot] = None
        self._host_gen[slot] = 0
        self._host_temp[slot] = 0.0
        finished.append(req)
        self.n_finished_ok += 1

    # -- the decode tick ------------------------------------------------------

    def _tick(self, sampled: bool) -> torch.Tensor:
        """One decode step over every slot plus sampling and bookkeeping, all
        on the device. Returns the packed (2, B) int32 ``[done, bad]``."""
        scfg, st = self.scfg, self.state
        logits1, _ = tf_lib.decode_step(self.params, self.cfg,
                                        st.tok[:, None], st.pos, st.caches)
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
        adm = self._admit_dense(finished)
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
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
                if self.slot_req[int(i)] is not None:
                    self._finish_slot(int(i), finished)
        # modeled traffic/compute: the decode tick streams the weight tree
        # once and reads the whole resident KV payload (every slot billed at
        # max_len, as the JAX dense path bills it); admission adds its own
        # prefill bill
        na = len(active)
        wb = kvb = fl = 0.0
        if active:
            wb += self.weight_bytes
            kvb += self.kv_cache_bytes
            fl += costing.decode_tick_flops(
                self._matmul_elems, self._n_attn, self._attn_dims,
                na * self.scfg.max_len, na)
        if adm.weight_passes:
            wb += self.weight_bytes * adm.weight_passes
        kvb += adm.kv_bytes
        fl += adm.flops
        m = StepMetrics(tokens=na, active_slots=na,
                        wall_s=time.monotonic() - t0,
                        prefill_tokens=adm.prefill_tokens,
                        admitted=adm.admitted,
                        queue_depth=len(self.scheduler),
                        weight_bytes=wb, kv_bytes=kvb, flops=fl)
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
        return {"ticks": len(self.metrics_log),
                "decode_tokens": toks,
                "prefill_tokens": sum(m.prefill_tokens
                                      for m in self.metrics_log),
                "wall_s": wall,
                "prefill_wall_s": self.prefill_wall_s,
                "decode_tokens_per_s": toks / wall if wall > 0 else 0.0}


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
