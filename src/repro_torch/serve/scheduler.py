"""Admission scheduling policy for the continuous-batching serve core.

Copy of ``repro.serve.scheduler`` for the PyTorch port, which imports
nothing of ``repro``; only the typing import differs from the original.

The engine owns device state (caches, slot arrays); the scheduler owns the
*policy* of which queued requests enter freed slots:

* ``fifo`` — arrival order (the seed engine's implicit policy);
* ``longest_prompt`` — longest-prompt-first. Long prompts dominate both the
  padded batched-prefill cost and the per-tick KV footprint; admitting them
  together groups similar lengths into one pad-and-stack prefill call
  (less padding waste) and starts the expensive requests earliest, which
  lowers mean slot residency under a deep queue.

Requests picked in one ``select`` call are prefilled as ONE padded batch
(engine._admit), so the policy also controls prefill batch composition.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, List, Optional, TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.serve.engine import Request


@dataclasses.dataclass
class SchedulerConfig:
    policy: str = "fifo"               # "fifo" | "longest_prompt"
    # queue aging (DESIGN.md §17): under ``longest_prompt`` every
    # ``age_boost_ticks`` ticks a request has waited count as one extra
    # prompt token of priority, so short prompts cannot starve behind a
    # steady stream of long ones. 0 = off (pure length order). The engine
    # passes the current tick via ``select(..., now=)``; without it aging
    # is inert.
    age_boost_ticks: int = 0


class Scheduler:
    def __init__(self, config: SchedulerConfig | None = None):
        self.config = config or SchedulerConfig()
        if self.config.policy not in ("fifo", "longest_prompt"):
            raise ValueError(f"unknown policy {self.config.policy!r}")
        self._q: Deque["Request"] = deque()

    def submit(self, req: "Request") -> None:
        self._q.append(req)

    def __len__(self) -> int:
        return len(self._q)

    @property
    def pending(self) -> List["Request"]:
        return list(self._q)

    def select(self, n_free: int,
               fits: Optional[Callable[["Request"], bool]] = None,
               now: Optional[int] = None) -> List["Request"]:
        """Pop up to ``n_free`` requests for admission, per policy.

        ``fits`` is the engine's capacity gate (the paged engine passes its
        page-pool estimate; it may consume budget as a side effect, so it
        is called at most once per candidate). FIFO stops at the first
        non-fitting request — head-of-line order is the policy's contract —
        while ``longest_prompt`` skips non-fitting candidates (it already
        reorders, so admitting a shorter prompt that fits is in-policy).

        ``now`` is the engine's tick counter; with
        ``config.age_boost_ticks`` set it feeds the anti-starvation aging
        term under ``longest_prompt``.
        """
        if n_free <= 0 or not self._q:
            return []
        if self.config.policy == "fifo":
            out: List["Request"] = []
            while self._q and len(out) < n_free:
                if fits is not None and not fits(self._q[0]):
                    break
                out.append(self._q.popleft())
            return out

        def rank(r: "Request") -> float:
            n = float(len(r.prompt))
            boost_every = self.config.age_boost_ticks
            if boost_every > 0 and now is not None:
                submitted = getattr(r, "submit_tick", -1)
                if submitted >= 0:
                    n += (now - submitted) // boost_every
            return -n

        # longest_prompt: stable pick of the n longest pending prompts
        # (aging-adjusted length when armed)
        ranked = sorted(self._q, key=rank)
        picked: List["Request"] = []
        for r in ranked:
            if len(picked) >= n_free:
                break
            if fits is None or fits(r):
                picked.append(r)
        chosen = set(id(r) for r in picked)
        self._q = deque(r for r in self._q if id(r) not in chosen)
        return picked

    def load(self, reqs: List["Request"]) -> None:
        """Replace the queue wholesale, in order — snapshot restore
        (DESIGN.md §19) rebuilds the exact pending sequence so replayed
        admission decisions repeat bit-identically."""
        self._q = deque(reqs)

    def requeue_front(self, reqs: List["Request"]) -> None:
        """Return selected-but-not-admitted requests to the queue head
        (e.g. SSD archs admit only equal-length groups per prefill call)."""
        self._q.extendleft(reversed(reqs))

    def drop(self, pred: Callable[["Request"], bool]) -> List["Request"]:
        """Remove and return every queued request matching ``pred``, in
        queue order. The paged engine's never-fittable guard: a request
        whose worst-case page demand (which books speculative-decode
        growth too) exceeds the whole pool would pin a FIFO queue's head
        forever — the engine drops it and fails it fast instead. ``pred``
        is called exactly once per queued request."""
        kept: Deque["Request"] = deque()
        dropped: List["Request"] = []
        for r in self._q:
            (dropped if pred(r) else kept).append(r)
        if dropped:
            self._q = kept
        return dropped
