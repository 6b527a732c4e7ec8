"""Operational energy & efficiency models (paper Table 3 + fleet extension).

Copy of ``repro.core.energy`` for the PyTorch port, which imports nothing of
``repro``; only its imports differ from the original.

Two layers:

1. **Paper-faithful**: efficiency columns of Table 3 — FPS/W, MF/gCO2eq for
   ternary PIM inference and GFLOPS/W, TFLOPS/gCO2eq for FP32 training — are
   recomputed from the measured (throughput, power) points and the grid-mix
   range of Table 1.

2. **Beyond-paper (fleet)**: a dry-run roofline (core.roofline) converts to a
   per-step wall-time bound, which with the TPU power model gives energy/step,
   carbon/step per grid mix, and tokens/J — the quantities the accounting and
   advisor layers consume.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core import grid, hw, roofline

J_PER_KWH = 3.6e6


# ---------------------------------------------------------------------------
# Paper Table 3 efficiency columns
# ---------------------------------------------------------------------------

def work_per_gco2(throughput: float, power_w: float, mix: str) -> float:
    """(work-units per gCO2eq) = throughput/power * 1kWh / mix_intensity.

    For ``throughput`` in FPS this returns frames/gCO2eq; the paper's tabled
    MF/gCO2eq divides by 1e6, TFLOPS/gCO2eq divides GFLOPS-work by 1e3.
    """
    work_per_j = throughput / power_w
    work_per_kwh = work_per_j * J_PER_KWH
    return work_per_kwh / grid.mix_intensity(mix)


def table3_efficiency(benchmark: str, phase: str,
                      states: Tuple[str, ...] = ("AZ", "CA", "TX", "NY"),
                      ) -> Dict[str, Dict[str, float]]:
    """Recompute the efficiency columns of Table 3 for one benchmark/phase."""
    out: Dict[str, Dict[str, float]] = {}
    for device, point in hw.workload_points(benchmark, phase).items():
        per_g = {s: work_per_gco2(point.throughput, point.power_w, s) for s in states}
        row = {
            "throughput": point.throughput,
            "unit": point.throughput_unit,
            "power_w": point.power_w,
            "per_w": point.efficiency_per_w,
        }
        if point.throughput_unit == "FPS":
            # Mega-frames per gCO2eq (paper's MF/gCO2eq column)
            row["carbon_eff_min"] = min(per_g.values()) / 1e6
            row["carbon_eff_max"] = max(per_g.values()) / 1e6
            row["carbon_eff_unit"] = "MF/gCO2eq"
        else:
            # GFLOPS-seconds of work per gCO2eq -> TFLOPS/gCO2eq
            row["carbon_eff_min"] = min(per_g.values()) / 1e3
            row["carbon_eff_max"] = max(per_g.values()) / 1e3
            row["carbon_eff_unit"] = "TFLOPS/gCO2eq"
        out[device] = row
    return out


# Paper's published efficiency ranges (test oracles).  The RM inference row is
# internally inconsistent in the paper (~6.5% high vs. its own FPS/W); see
# DESIGN.md §10.
PAPER_TABLE3_EFF = {
    ("alexnet", "inference_ternary", "ddr3_pim"): (0.35, 0.81),
    ("alexnet", "inference_ternary", "rm_pim"): (4.6, 10.8),    # paper-inconsistent
    ("alexnet", "train_fp32", "gpu"): (521.0, 1214.0),
    ("alexnet", "train_fp32", "rm_pim"): (74.0, 172.0),
    ("alexnet", "train_fp32", "fpga"): (37.0, 85.0),
    ("vgg16", "train_fp32", "gpu"): (342.0, 797.0),
    ("vgg16", "train_fp32", "rm_pim"): (118.0, 275.0),
    ("vgg16", "train_fp32", "fpga"): (50.0, 117.0),
}


# ---------------------------------------------------------------------------
# Fleet (TPU) operational energy from roofline terms
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StepEnergy:
    """Energy/carbon accounting for one compiled step on a fleet."""
    step_time_s: float
    n_devices: int
    energy_j: float
    energy_j_no_overlap: float

    def carbon_g(self, mix: str) -> float:
        return grid.joules_to_gco2(self.energy_j, mix)


def step_energy(terms: roofline.RooflineTerms,
                power: Optional[hw.PowerStates] = None) -> StepEnergy:
    """Energy per step: bound wall-time x fleet active power.

    Uses the perfect-overlap time bound for the headline number and the
    no-overlap bound as the pessimistic bracket.
    """
    p = power or hw.TPU_V5E.power
    t, t_hi = terms.step_time_s, terms.step_time_no_overlap_s
    return StepEnergy(
        step_time_s=t,
        n_devices=terms.n_devices,
        energy_j=t * terms.n_devices * p.active_w,
        energy_j_no_overlap=t_hi * terms.n_devices * p.active_w,
    )


def tokens_per_joule(terms: roofline.RooflineTerms, n_tokens: float,
                     power: Optional[hw.PowerStates] = None) -> float:
    se = step_energy(terms, power)
    return n_tokens / se.energy_j if se.energy_j > 0 else float("inf")


def carbon_per_1k_steps(terms: roofline.RooflineTerms, mix: str,
                        power: Optional[hw.PowerStates] = None) -> float:
    """gCO2eq per 1000 steps — the fleet analogue of Table 3's carbon column."""
    return 1000.0 * step_energy(terms, power).carbon_g(mix)


# ---------------------------------------------------------------------------
# Per-byte DRAM term (quantized serving path, DESIGN.md §12)
# ---------------------------------------------------------------------------
# The paper's core claim is that per-byte data movement — not FLOPs —
# dominates edge-inference energy (hence PIM). The serving path makes that
# measurable: every engine tick reports dtype-aware bytes moved (weights +
# KV cache) and modeled FLOPs, and the accountant bills
#
#     E_modeled = flops * (P_active / peak_flops)  +  bytes * e_dram
#
# so J/token visibly drops when the int8 path halves-to-quarters the bytes
# while leaving FLOPs unchanged. Access-energy constants are literature
# order-of-magnitude values (pJ/byte): HBM2E ~3.9 pJ/bit, LPDDR4 ~8 pJ/bit
# (the edge case), DDR4 ~15 pJ/bit.

DRAM_PJ_PER_BYTE = {"hbm2e": 31.0, "lpddr4": 64.0, "ddr4": 120.0}


def dram_energy_j(n_bytes: float, kind: str = "hbm2e") -> float:
    """Energy to move ``n_bytes`` through the memory interface."""
    return float(n_bytes) * DRAM_PJ_PER_BYTE[kind] * 1e-12


def compute_energy_j(flops: float,
                     spec: Optional[hw.DeviceSpec] = None) -> float:
    """Compute-side energy at peak-rate efficiency (active power / peak
    FLOPs — ~1 pJ/FLOP on TPU v5e). Devices without a published peak fall
    back to the TPU constants."""
    spec = spec if spec is not None and spec.peak_flops else hw.TPU_V5E
    return float(flops) * spec.power.active_w / spec.peak_flops


def modeled_serve_energy_j(flops: float, n_bytes: float,
                           spec: Optional[hw.DeviceSpec] = None,
                           dram: str = "hbm2e") -> float:
    """FLOPs + per-byte DRAM energy for one serving interval."""
    return compute_energy_j(flops, spec) + dram_energy_j(n_bytes, dram)


# ---------------------------------------------------------------------------
# Training-phase energy (on-line training fast path, DESIGN.md §13)
# ---------------------------------------------------------------------------
# The paper evaluates edge platforms for inference AND on-line training, and
# the related edge-energy literature (DeepEn2023, Sobhani et al.) insists on
# *per-phase* measurement: forward and backward bill separately, because the
# backward's 2x FLOPs + grad-write traffic is exactly what a serve-only
# energy model misses. TrainStepCost carries one optimizer step's modeled
# phases; models/costing.py derives it from a live param/opt-state tree.

@dataclasses.dataclass(frozen=True)
class TrainStepCost:
    """Modeled FLOPs/bytes of ONE training step, split by phase."""
    fwd_flops: float
    bwd_flops: float
    fwd_bytes: float
    bwd_bytes: float
    opt_bytes: float = 0.0
    tokens: float = 0.0
    samples: float = 0.0

    def scaled(self, n_steps: int) -> "TrainStepCost":
        f = float(n_steps)
        return TrainStepCost(
            fwd_flops=self.fwd_flops * f, bwd_flops=self.bwd_flops * f,
            fwd_bytes=self.fwd_bytes * f, bwd_bytes=self.bwd_bytes * f,
            opt_bytes=self.opt_bytes * f, tokens=self.tokens * f,
            samples=self.samples * f)


def train_phase_energy_j(cost: TrainStepCost,
                         spec: Optional[hw.DeviceSpec] = None,
                         dram: str = "hbm2e") -> Dict[str, float]:
    """Per-phase modeled energy of one training step (J): the FLOPs term at
    peak-rate efficiency plus the per-byte DRAM term, forward and backward
    separately; the optimizer phase is pure traffic (negligible FLOPs)."""
    fwd = compute_energy_j(cost.fwd_flops, spec) + dram_energy_j(
        cost.fwd_bytes, dram)
    bwd = compute_energy_j(cost.bwd_flops, spec) + dram_energy_j(
        cost.bwd_bytes, dram)
    opt = dram_energy_j(cost.opt_bytes, dram)
    return {"fwd_j": fwd, "bwd_j": bwd, "opt_j": opt,
            "total_j": fwd + bwd + opt}
