"""Indifference / break-even sustainability analysis (paper Eq. 1 + Fig. 2).

Copy of ``repro.core.sustain`` for the PyTorch port, which imports nothing of
``repro``; only its imports differ from the original.

Implements the GreenChip [8] holistic-energy machinery the paper uses:

* Eq. 1:  t_I = (M1 - M0) / (P0 - P1)   and   t_B = M1 / (P0 - P1)
* the activity-ratio x sleep-ratio duty-cycle average-power model,
* *iso-throughput* normalization: when two platforms have different
  throughput on the same workload, the faster platform duty-cycles down to
  deliver the same work per unit time (this is what makes the paper's
  "GPU needs >=40 % activity to beat RM" claim come out — see
  tests/test_sustain.py::test_paper_claims_indifference_alexnet).

All energies are Joules, powers Watts, times seconds unless suffixed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import hw

SECONDS_PER_DAY = 86400.0
SECONDS_PER_YEAR = 365.0 * SECONDS_PER_DAY


# ----------------------------------------------------------------------------
# Eq. 1
# ----------------------------------------------------------------------------

def indifference_time_s(m1_j: float, m0_j: float, p0_w: float, p1_w: float) -> float:
    """t_I of Eq. 1: time at which system 1's extra embodied energy is amortized.

    System 1 has higher embodied (M1 > M0) and lower operational (P1 < P0).
    Returns +inf when system 1 never catches up (P1 >= P0), and 0 when system 1
    dominates (lower embodied AND lower operational — indifference analysis
    not needed, per the paper).
    """
    dm = m1_j - m0_j
    dp = p0_w - p1_w
    if dp <= 0.0:
        return math.inf if dm > 0 else 0.0
    return max(dm / dp, 0.0)


def breakeven_time_s(m1_j: float, p0_w: float, p1_w: float) -> float:
    """t_B of Eq. 1: replacement case (deployed incumbent => M0 = 0)."""
    return indifference_time_s(m1_j, 0.0, p0_w, p1_w)


def total_energy_j(m_j: float, p_w: float, t_s: float) -> float:
    """Holistic energy = embodied + operational over service time."""
    return m_j + p_w * t_s


# ----------------------------------------------------------------------------
# GreenChip duty-cycle model
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Duty:
    """GreenChip usage scenario.

    activity: fraction of wall-clock the *workload demand* keeps the reference
        platform busy (the paper's x-axis "activity ratio" = compute:idle).
    sleep_ratio: fraction of the non-active time spent in sleep rather than
        idle (the paper's y-axis "sleep ratio").
    """
    activity: float
    sleep_ratio: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.activity <= 1.0:
            raise ValueError(f"activity {self.activity} not in [0,1]")
        if not 0.0 <= self.sleep_ratio <= 1.0:
            raise ValueError(f"sleep_ratio {self.sleep_ratio} not in [0,1]")


def average_power_w(power: hw.PowerStates, busy_fraction: float,
                    sleep_ratio: float) -> float:
    """Average power of a device busy ``busy_fraction`` of the time."""
    idle_frac = 1.0 - busy_fraction
    return (busy_fraction * power.active_w
            + idle_frac * (sleep_ratio * power.sleep_w
                           + (1.0 - sleep_ratio) * power.idle_w))


def iso_throughput_busy_fraction(duty_activity: float, ref_throughput: float,
                                 dev_throughput: float) -> float:
    """Busy fraction of a device delivering the demand ``activity * ref_thr``.

    The reference platform defines the demand scale (activity=1 means demand
    equals the reference platform's full throughput). A faster device is busy
    a smaller fraction; a slower device saturates at 1.0 (it simply cannot
    serve more — flagged by callers via ``is_feasible``).
    """
    if dev_throughput <= 0:
        raise ValueError("device throughput must be positive")
    return min(duty_activity * ref_throughput / dev_throughput, 1.0)


@dataclasses.dataclass(frozen=True)
class Platform:
    """A candidate system for the indifference comparison."""
    name: str
    embodied_j: float
    power: hw.PowerStates
    throughput: float          # workload throughput when active (FPS/GFLOPS/...)

    def average_power_w(self, duty: Duty, ref_throughput: float) -> float:
        busy = iso_throughput_busy_fraction(duty.activity, ref_throughput,
                                            self.throughput)
        return average_power_w(self.power, busy, duty.sleep_ratio)

    def is_feasible(self, duty: Duty, ref_throughput: float) -> bool:
        return duty.activity * ref_throughput <= self.throughput * (1 + 1e-12)


def platform_from_hw(device: str, benchmark: str, phase: str, *,
                     embodied_j: Optional[float] = None,
                     per_module: bool = False) -> Platform:
    """Build a Platform from the hw/lca databases and a Table-3 point."""
    from repro_torch.core import lca   # local import to avoid cycle at module load
    spec = hw.DEVICES[device]
    point = hw.workload_points(benchmark, phase)[device]
    if embodied_j is None:
        embodied_j = lca.embodied_energy_mj(spec, per_module=per_module) * 1e6
    # Active power is workload-dependent (Table 3 measured); idle/sleep are
    # device properties from the spec.
    power = hw.PowerStates(active_w=point.power_w, idle_w=spec.power.idle_w,
                           sleep_w=spec.power.sleep_w)
    return Platform(name=device, embodied_j=embodied_j, power=power,
                    throughput=point.throughput)


# ----------------------------------------------------------------------------
# Pairwise analysis & Fig.2 surfaces
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Comparison:
    challenger: str
    incumbent: str
    duty: Duty
    p_challenger_w: float
    p_incumbent_w: float
    indifference_s: float
    breakeven_s: float
    challenger_dominates: bool   # lower embodied AND lower operational
    feasible: bool


def compare(challenger: Platform, incumbent: Platform, duty: Duty,
            ref_throughput: Optional[float] = None) -> Comparison:
    """Full Eq.-1 comparison under a duty scenario.

    ``ref_throughput`` sets the demand scale; defaults to the slower platform
    (so activity=1 is the largest demand both can possibly serve).
    """
    ref = ref_throughput if ref_throughput is not None else min(
        challenger.throughput, incumbent.throughput)
    pc = challenger.average_power_w(duty, ref)
    pi = incumbent.average_power_w(duty, ref)
    t_i = indifference_time_s(challenger.embodied_j, incumbent.embodied_j, pi, pc)
    t_b = breakeven_time_s(challenger.embodied_j, pi, pc)
    dominates = (challenger.embodied_j <= incumbent.embodied_j) and (pc <= pi)
    feasible = challenger.is_feasible(duty, ref) and incumbent.is_feasible(duty, ref)
    return Comparison(challenger.name, incumbent.name, duty, pc, pi,
                      t_i, t_b, dominates, feasible)


def surface(challenger: Platform, incumbent: Platform,
            activities: Sequence[float], sleep_ratios: Sequence[float],
            kind: str = "breakeven",
            ref_throughput: Optional[float] = None) -> np.ndarray:
    """Fig.-2 style 2-D surface of t_B or t_I (years); inf where never."""
    if kind not in ("breakeven", "indifference"):
        raise ValueError(kind)
    out = np.empty((len(sleep_ratios), len(activities)))
    for i, s in enumerate(sleep_ratios):
        for j, a in enumerate(activities):
            c = compare(challenger, incumbent, Duty(a, s), ref_throughput)
            t = c.breakeven_s if kind == "breakeven" else c.indifference_s
            out[i, j] = t / SECONDS_PER_YEAR
    return out


def crossover_activity(challenger: Platform, incumbent: Platform,
                       sleep_ratio: float = 0.0,
                       ref_throughput: Optional[float] = None,
                       tol: float = 1e-6) -> float:
    """Smallest activity at which the challenger's operational power drops
    below the incumbent's (bisection; 1.0+ means never)."""
    def dp(a: float) -> float:
        c = compare(challenger, incumbent, Duty(a, sleep_ratio), ref_throughput)
        return c.p_incumbent_w - c.p_challenger_w
    lo, hi = 0.0, 1.0
    if dp(hi) <= 0:
        return math.inf
    if dp(lo) > 0:
        return 0.0
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        if dp(mid) > 0:
            hi = mid
        else:
            lo = mid
    return hi


def decide(platforms: List[Platform], duty: Duty, service_time_s: float,
           ref_throughput: Optional[float] = None) -> Dict[str, float]:
    """Pick the min-holistic-energy platform for a service time (advisor core)."""
    ref = ref_throughput if ref_throughput is not None else min(
        p.throughput for p in platforms)
    totals = {}
    for p in platforms:
        if not p.is_feasible(duty, ref):
            totals[p.name] = math.inf
            continue
        totals[p.name] = total_energy_j(
            p.embodied_j, p.average_power_w(duty, ref), service_time_s)
    return totals
