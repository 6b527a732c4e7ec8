"""Sustainability advisor — the paper's decision procedure as an API.

Copy of ``repro.core.advisor`` for the PyTorch port, which imports nothing of
``repro``; only its imports differ from the original.

Answers the deployment questions the paper poses:

* "Which accelerator minimizes holistic energy for this workload, duty cycle
  and service time?" (Fig. 2 / Eq. 1, incl. the FPGA-dominated case)
* "Given an already-deployed incumbent, when does replacing it break even?"
* Beyond paper: "Which mesh/fleet size minimizes carbon per token for this
  architecture?" — driven by dry-run roofline terms.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from repro_torch.core import energy, hw, roofline as rl, sustain


@dataclasses.dataclass
class Recommendation:
    winner: str
    totals_j: Dict[str, float]
    dominated: List[str]
    indifference: Dict[str, float]       # pair -> t_I (years)
    narrative: List[str]


def recommend(platforms: Sequence[sustain.Platform], duty: sustain.Duty,
              service_time_s: float,
              ref_throughput: Optional[float] = None) -> Recommendation:
    totals = sustain.decide(list(platforms), duty, service_time_s, ref_throughput)
    winner = min(totals, key=totals.get)
    narrative: List[str] = []
    by_name = {p.name: p for p in platforms}

    # dominance: platform is dominated if another has both lower embodied and
    # lower average operational power (the paper's FPGA observation).
    ref = ref_throughput if ref_throughput is not None else min(
        p.throughput for p in platforms)
    avg_p = {p.name: p.average_power_w(duty, ref) for p in platforms}
    dominated = []
    for a in platforms:
        for b in platforms:
            if b.name == a.name:
                continue
            if (b.embodied_j <= a.embodied_j and avg_p[b.name] <= avg_p[a.name]
                    and (b.embodied_j < a.embodied_j or avg_p[b.name] < avg_p[a.name])):
                dominated.append(a.name)
                narrative.append(
                    f"{a.name} is dominated by {b.name} (higher embodied and "
                    f"higher operational energy): indifference never selects it.")
                break

    indiff: Dict[str, float] = {}
    names = [p.name for p in platforms if p.name not in dominated]
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            hi, lo = (a, b) if by_name[a].embodied_j >= by_name[b].embodied_j else (b, a)
            t = sustain.indifference_time_s(
                by_name[hi].embodied_j, by_name[lo].embodied_j,
                avg_p[lo], avg_p[hi])
            indiff[f"{hi}-vs-{lo}"] = t / sustain.SECONDS_PER_YEAR
            if math.isinf(t):
                narrative.append(
                    f"{hi} never amortizes its embodied-energy premium over "
                    f"{lo} at activity={duty.activity:.0%}.")
            else:
                pick = hi if service_time_s > t else lo
                narrative.append(
                    f"{hi} vs {lo}: t_I = {t / sustain.SECONDS_PER_YEAR:.2f} yr "
                    f"at activity={duty.activity:.0%} -> choose {pick} for the "
                    f"proposed service time.")
    narrative.append(f"Minimum holistic energy: {winner}.")
    return Recommendation(winner, totals, dominated, indiff, narrative)


# ---------------------------------------------------------------------------
# Beyond paper: fleet/mesh advisor from roofline terms
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MeshOption:
    label: str
    terms: rl.RooflineTerms
    tokens_per_step: float


def fleet_recommend(options: Sequence[MeshOption], grid_mix: str,
                    service_years: float = 3.0,
                    activity: float = 1.0) -> Dict[str, Dict[str, float]]:
    """Carbon per token + embodied amortization for each mesh option.

    The paper's insight at fleet scale: more chips lower step time (operational
    energy/token roughly constant or worse due to collectives) but add embodied
    carbon; the right size is the smallest fleet that meets the service-rate
    requirement — quantified here.
    """
    from repro_torch.core import lca
    out: Dict[str, Dict[str, float]] = {}
    for opt in options:
        se = energy.step_energy(opt.terms)
        embodied_j = lca.tpu_package_embodied_mj() * 1e6 * opt.terms.n_devices
        service_s = service_years * sustain.SECONDS_PER_YEAR * activity
        steps_life = service_s / max(se.step_time_s, 1e-12)
        tokens_life = steps_life * opt.tokens_per_step
        op_j_life = se.energy_j * steps_life
        from repro_torch.core import grid
        out[opt.label] = {
            "n_devices": opt.terms.n_devices,
            "step_time_s": se.step_time_s,
            "tokens_per_s": opt.tokens_per_step / max(se.step_time_s, 1e-12),
            "energy_j_per_step": se.energy_j,
            "j_per_token": se.energy_j / max(opt.tokens_per_step, 1e-12),
            "op_gco2_per_mtoken": grid.joules_to_gco2(
                se.energy_j / max(opt.tokens_per_step, 1e-12), grid_mix) * 1e6,
            "embodied_gco2": grid.joules_to_gco2(embodied_j, grid_mix),
            "embodied_share_of_lifecycle": embodied_j / (embodied_j + op_j_life),
            "lifecycle_gco2_per_mtoken": grid.joules_to_gco2(
                (embodied_j + op_j_life) / max(tokens_life, 1e-12), grid_mix) * 1e6,
        }
    return out
