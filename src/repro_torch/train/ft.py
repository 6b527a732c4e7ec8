"""Fleet fault-tolerance: heartbeats, straggler detection, elastic planning.

Copy of ``repro.train.ft`` for the PyTorch port, which imports nothing of
``repro``; the module is plain files and math, and the code is unchanged
(``tests/test_torch_copies.py`` holds it equal to its original).

At thousands of nodes the failure modes the launcher must absorb are:
  * **dead host** — heartbeat older than ``dead_after_s`` -> exclude, replan;
  * **straggler** — step time EWMA > ``straggler_factor`` x fleet median ->
    flag; policy: warn first, exclude after ``strikes`` consecutive flags
    (hot-spare swap on a real fleet);
  * **shrink/grow** — ElasticPlanner picks the largest valid mesh from the
    healthy host set (model-parallel degree fixed by the arch; DP shrinks),
    the checkpoint reshards on restore (checkpoint.manager), and the data
    pipeline re-slices deterministically (data.pipeline.reshard).

Everything is plain files + math — simulated multi-host tests drive it
(tests/test_ft.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class Ewma:
    """Exponentially-weighted moving average with the heartbeat smoothing
    convention (``alpha`` is the weight on history, first observation
    seeds the average). Shared by the fleet straggler detector below and
    the serve engine's tick-latency / accept-rate / numerics-drift
    monitors (serve/faults.py, DESIGN.md §17) so every "is this run
    degrading" question uses the same estimator."""
    alpha: float = 0.9
    value: Optional[float] = None
    n: int = 0

    def update(self, x: float) -> float:
        self.n += 1
        if self.value is None:
            self.value = float(x)
        else:
            self.value = self.alpha * self.value + (1 - self.alpha) * float(x)
        return self.value


@dataclasses.dataclass
class HostStatus:
    host_id: str
    step: int
    step_time_ewma: float
    last_beat: float           # unix time

    def age(self, now: Optional[float] = None) -> float:
        return (now if now is not None else time.time()) - self.last_beat


class HeartbeatWriter:
    """Each host writes {host_id}.json on every step."""

    def __init__(self, directory: str, host_id: str, ewma: float = 0.9):
        self.dir = directory
        self.host_id = host_id
        self.ewma = ewma
        self._ewma = Ewma(alpha=ewma)
        os.makedirs(directory, exist_ok=True)

    @property
    def _step_time(self) -> Optional[float]:
        return self._ewma.value

    @_step_time.setter
    def _step_time(self, value: Optional[float]) -> None:
        self._ewma.value = value

    def beat(self, step: int, step_time_s: float,
             now: Optional[float] = None) -> None:
        self._ewma.update(step_time_s)
        payload = {"host_id": self.host_id, "step": step,
                   "step_time_ewma": self._step_time,
                   "last_beat": now if now is not None else time.time()}
        tmp = os.path.join(self.dir, f".{self.host_id}.tmp")
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, os.path.join(self.dir, f"{self.host_id}.json"))


@dataclasses.dataclass
class MonitorConfig:
    dead_after_s: float = 60.0
    straggler_factor: float = 2.0
    strikes_to_exclude: int = 3


class HealthMonitor:
    """Coordinator-side view over the heartbeat directory."""

    def __init__(self, directory: str, cfg: MonitorConfig = MonitorConfig()):
        self.dir = directory
        self.cfg = cfg
        self._strikes: Dict[str, int] = {}

    def read(self) -> Dict[str, HostStatus]:
        out = {}
        if not os.path.isdir(self.dir):
            return out
        for name in os.listdir(self.dir):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.dir, name)) as f:
                    d = json.load(f)
                out[d["host_id"]] = HostStatus(**d)
            except (json.JSONDecodeError, KeyError, TypeError):
                continue   # torn read of a non-atomic writer; skip this cycle
        return out

    def assess(self, now: Optional[float] = None
               ) -> Tuple[List[str], List[str], List[str]]:
        """-> (healthy, dead, stragglers) host-id lists."""
        statuses = self.read()
        now = now if now is not None else time.time()
        dead = [h for h, s in statuses.items()
                if s.age(now) > self.cfg.dead_after_s]
        alive = {h: s for h, s in statuses.items() if h not in dead}
        stragglers: List[str] = []
        if len(alive) >= 2:
            times = sorted(s.step_time_ewma for s in alive.values())
            median = times[len(times) // 2]
            for h, s in alive.items():
                if s.step_time_ewma > self.cfg.straggler_factor * median:
                    self._strikes[h] = self._strikes.get(h, 0) + 1
                    if self._strikes[h] >= self.cfg.strikes_to_exclude:
                        stragglers.append(h)
                else:
                    self._strikes[h] = 0
        healthy = [h for h in alive if h not in stragglers]
        return sorted(healthy), sorted(dead), sorted(stragglers)


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    n_hosts_used: int
    dp_size: int
    restart_required: bool


class ElasticPlanner:
    """Choose the largest valid mesh from the healthy host set.

    The model axis is fixed by the architecture (TP degree must divide
    heads/ffn); DP absorbs all elasticity. Pods shrink to 1 when the healthy
    set no longer fills a pod.
    """

    def __init__(self, chips_per_host: int, model_parallel: int,
                 chips_per_pod: int = 256):
        self.chips_per_host = chips_per_host
        self.model_parallel = model_parallel
        self.chips_per_pod = chips_per_pod

    def plan(self, n_healthy_hosts: int,
             current: Optional[ElasticPlan] = None) -> ElasticPlan:
        chips = n_healthy_hosts * self.chips_per_host
        mp = self.model_parallel
        if chips < mp:
            raise RuntimeError(
                f"{chips} chips cannot fit model-parallel degree {mp}")
        pods = max(chips // self.chips_per_pod, 1)
        per_pod = chips // pods
        dp = per_pod // mp
        while dp < 1 and pods > 1:
            pods -= 1
            per_pod = chips // pods
            dp = per_pod // mp
        if pods > 1:
            shape: Tuple[int, ...] = (pods, dp, mp)
            axes: Tuple[str, ...] = ("pod", "data", "model")
        else:
            shape = (dp, mp)
            axes = ("data", "model")
        used_hosts = (pods * dp * mp) // self.chips_per_host
        restart = current is None or shape != current.mesh_shape
        return ElasticPlan(shape, axes, used_hosts, pods * dp, restart)
