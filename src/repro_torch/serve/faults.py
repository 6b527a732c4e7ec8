"""Deterministic fault injection for the port's paged serve engine (mirror
of ``repro.serve.faults``).

An unattended edge deployment meets faults the lab never sees: a NaN
logit from a marginal accelerator, a flipped bit in an int8 KV page, a
pool briefly exhausted by a co-tenant, a straggling tick, a dropped
readback. This module makes each of them a reproducible input: a
:class:`FaultPlan` is a seeded schedule of :class:`FaultEvent` s threaded
through ``ServeConfig.faults``, and the engine consults one
:class:`FaultInjector` per run. The same seed and plan give the same
corruption tick for tick, and the same choices as the JAX package's
injector (one ``np.random.default_rng(plan.seed)`` stream).

Detection and recovery (the numerics sentinel, quarantine, the degradation
ladder) live in ``serve/engine.py``; :class:`GuardrailConfig`
(``ServeConfig.guard``) arms them. Every default keeps the fault-free
behavior: no plan means no injection, and the all-default guard adds only
the sentinel, which rides the tick's one packed readback.

Fault classes and where they land:

* ``nan_logits`` / ``inf_logits``: a poison vector added to the victim
  slot's decode (or verify) logits inside the tick; the sentinel flags the
  slot, which makes no progress that tick and is quarantined by the host.
* ``kv_bitflip``: host-side corruption of one private (refcount 1,
  unpublished) KV page of the victim: NaN in float pools (the sentinel
  catches the next tick), XOR'd codes in int8 pools (finite garbage, the
  drift rung's case). Shared prefix pages are never touched.
* ``pool_spike``: ``magnitude`` pages allocated out from under the engine
  and held for ``duration`` ticks; exercises deferral, backpressure and
  deadline shedding.
* ``stall``: the host sleeps ``STALL_BASE_S * magnitude`` seconds before
  the tick; the tick-wall EWMA sees the spike and the compaction-pause
  rung reacts.
* ``readback_garble`` / ``readback_drop``: the tick's one packed readback
  arrives out of range or not at all on its first attempt; the engine
  validates ranges and reads again. An in-range flip is undetectable
  without ECC, a documented limit.
* ``process_kill``: the engine dies at the scheduled tick
  (:class:`ProcessKilled` propagates out of ``step()``). Recovery is the
  durability tier's restart from a snapshot, not any in-tick rung.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

FAULT_KINDS = ("nan_logits", "inf_logits", "kv_bitflip", "pool_spike",
               "stall", "readback_garble", "readback_drop",
               "process_kill")

# the kinds the in-tick ladder recovers from without a restart; a chaos
# matrix that drains one engine iterates these
TRANSIENT_FAULT_KINDS = tuple(k for k in FAULT_KINDS
                              if k != "process_kill")


class ProcessKilled(RuntimeError):
    """Raised out of ``ServeEngine.step()`` when a ``process_kill`` fault
    fires: the simulated process death. The engine object is dead; a
    restart from disk is the durability tier's."""


# host sleep per unit of a stall event's magnitude
STALL_BASE_S = 0.02

# the value a garbled readback element is overwritten with: outside every
# packed field's valid range ({0, 1} flags, 0..k+1 emission counts, the
# winning branch), so validation must reject it
GARBLE_VALUE = 1 << 20


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault. ``slot == -1`` resolves to the first active
    decoding slot at fire time; ``magnitude`` is pages for ``pool_spike``
    and the sleep multiplier for ``stall``; ``duration`` is hold ticks for
    ``pool_spike``."""
    tick: int
    kind: str
    slot: int = -1
    magnitude: float = 1.0
    duration: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected "
                             f"one of {FAULT_KINDS}")
        if self.tick < 0:
            raise ValueError(f"fault tick must be >= 0, got {self.tick}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, immutable fault schedule. ``events`` fire at exact ticks;
    the seed also decides every in-event random choice (which readback
    element to garble), so one ``(seed, events)`` pair replays bit for
    bit."""
    seed: int = 0
    events: Tuple[FaultEvent, ...] = ()

    @staticmethod
    def single(kind: str, tick: int = 1, *, seed: int = 0,
               slot: int = -1, magnitude: float = 1.0,
               duration: int = 1) -> "FaultPlan":
        return FaultPlan(seed=seed, events=(
            FaultEvent(tick=tick, kind=kind, slot=slot,
                       magnitude=magnitude, duration=duration),))

    @staticmethod
    def matrix(seed: int, n_ticks: int,
               kinds: Sequence[str] = FAULT_KINDS,
               events_per_kind: int = 1) -> "FaultPlan":
        """One deterministic schedule covering every kind: fire ticks are
        drawn from ``default_rng(seed)`` in ``[1, n_ticks)``; tick 0 is
        skipped so the first admission lands cleanly."""
        rng = np.random.default_rng(seed)
        events = []
        for kind in kinds:
            for _ in range(events_per_kind):
                t = int(rng.integers(1, max(n_ticks, 2)))
                events.append(FaultEvent(tick=t, kind=kind))
        return FaultPlan(seed=seed, events=tuple(events))

    def for_tick(self, tick: int) -> List[FaultEvent]:
        return [e for e in self.events if e.tick == tick]

    @property
    def max_tick(self) -> int:
        return max((e.tick for e in self.events), default=-1)


@dataclasses.dataclass
class GuardrailConfig:
    """Detection and degradation knobs (``ServeConfig.guard``). Every rung
    is off until its knob arms it; the numerics sentinel has no knob (it
    rides the packed readback) and is always on."""
    # walk PagePool.audit() and the engine's ownership mirror every N
    # ticks (0 = off); violations are counted (summary: audit_failures),
    # never raised
    audit_interval: int = 0
    # paged admission deferrals per request before it is shed (0 =
    # unlimited retries)
    admit_max_retries: int = 0
    # exponential admission backoff: after its n-th deferral a request
    # waits base * 2^(n-1) ticks (capped at 32) before it is considered
    # again (0 = retry every tick)
    admit_backoff: int = 0
    # spec-k backoff: halve spec_k (floor 1) when the acceptance-rate EWMA
    # sits below this threshold with at least ``spec_backoff_window``
    # observed spec ticks (0.0 = off)
    spec_backoff_threshold: float = 0.0
    spec_backoff_window: int = 8
    # int8 drift watch: every N ticks re-decode one live slot's last
    # emitted token through the fp oracle and update a disagreement EWMA;
    # above ``drift_threshold`` the engine falls back to fp serving (0 =
    # off)
    drift_check_interval: int = 0
    drift_threshold: float = 0.5
    drift_min_checks: int = 3
    # straggler rung: a tick whose wall time exceeds ``stall_factor`` x
    # the tick-wall EWMA pauses compaction for ``compact_pause_ticks``
    # ticks (0.0 = off)
    stall_factor: float = 0.0
    compact_pause_ticks: int = 4
    # re-reads of a dropped or garbled packed readback before giving up
    readback_max_retries: int = 2
    # smoothing of every guardrail EWMA (train/ft.py's Ewma: the weight on
    # history)
    ewma_alpha: float = 0.9

    def __post_init__(self):
        for name in ("audit_interval", "admit_max_retries", "admit_backoff",
                     "drift_check_interval", "compact_pause_ticks"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")
        if not (0.0 <= self.spec_backoff_threshold <= 1.0):
            raise ValueError("spec_backoff_threshold must be in [0, 1]")
        if not (0.0 <= self.drift_threshold <= 1.0):
            raise ValueError("drift_threshold must be in [0, 1]")
        if self.readback_max_retries < 1:
            raise ValueError("readback_max_retries must be >= 1")


def corrupt_kv_page(caches, page: int) -> None:
    """Poison physical ``page`` in every layer's K pool, in place: NaN in
    float storage (the sentinel fires on the next tick that attends the
    page), codes XOR 0x55 in int8 storage (finite garbage that only the
    drift rung can see; the XOR can write -128, which the quantizer never
    produces). V and the int8 scale pools are left as they are: one
    corrupted projection taints the victim's logits, and the smallest
    corruption makes the blast-radius check (other slots bit-identical)
    the strongest."""
    for name, entry in caches.items():
        k = entry["kv"].k
        # pattern pools carry the stacked layer dim first; tails are flat
        rows = k[:, page] if name.startswith("pat") else k[page]
        if k.dtype.is_floating_point:
            rows.fill_(float("nan"))
        else:
            rows.bitwise_xor_(0x55)


class FaultInjector:
    """Per-run dispatcher of one :class:`FaultPlan`.

    The injector owns the randomness and the ledger (``counts`` per kind;
    a fault counts when it is applied, so a ``kv_bitflip`` scheduled while
    no slot decodes counts zero). The engine owns the mutations that need
    its internals (pool allocation for spikes, cache surgery for flips)
    and calls ``count()``."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._rng = np.random.default_rng(plan.seed)
        self.counts: Dict[str, int] = {k: 0 for k in FAULT_KINDS}

    @property
    def faults_injected(self) -> int:
        return sum(self.counts.values())

    def count(self, kind: str, n: int = 1) -> None:
        self.counts[kind] += n

    def events_for(self, tick: int) -> List[FaultEvent]:
        return self.plan.for_tick(tick)

    # -- host-side faults -----------------------------------------------------

    def stall_seconds(self, tick: int) -> float:
        """Total straggler sleep scheduled for this tick (0.0 = none)."""
        secs = 0.0
        for e in self.events_for(tick):
            if e.kind == "stall":
                secs += STALL_BASE_S * float(e.magnitude)
                self.count("stall")
        return secs

    def logit_poison(self, tick: int, active_slots: Sequence[int],
                     n_slots: int) -> Optional[np.ndarray]:
        """(B,) float32 poison for this tick's decode or verify logits
        (``logits + poison[:, None]``): NaN or +inf at each victim slot,
        0.0 elsewhere. None when no logit fault fires: the engine then
        passes its zero buffer, with no host-to-device copy."""
        vec = None
        for e in self.events_for(tick):
            if e.kind not in ("nan_logits", "inf_logits") or not active_slots:
                continue
            victim = e.slot if e.slot in active_slots else active_slots[0]
            if vec is None:
                vec = np.zeros(n_slots, np.float32)
            vec[victim] = np.nan if e.kind == "nan_logits" else np.inf
            self.count(e.kind)
        return vec

    # -- readback faults ------------------------------------------------------

    def filter_readback(self, arr: np.ndarray, tick: int,
                        attempt: int = 0) -> Optional[np.ndarray]:
        """Pass the tick's packed readback through this tick's readback
        faults. Only the first attempt is corrupted (a torn transfer, not a
        persistently bad link): a retry sees the true array, so the
        engine's validate-and-retry loop converges."""
        if attempt > 0:
            return arr
        for e in self.events_for(tick):
            if e.kind == "readback_drop":
                self.count("readback_drop")
                return None
            if e.kind == "readback_garble":
                bad = np.array(arr, copy=True)
                flat = bad.reshape(-1)
                flat[int(self._rng.integers(flat.size))] = GARBLE_VALUE
                self.count("readback_garble")
                return bad
        return arr

