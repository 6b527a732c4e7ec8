"""Electrical grid-mix carbon-intensity model (paper Table 1).

Copy of ``repro.core.grid`` for the PyTorch port, which imports nothing of
``repro``; only its imports differ from the original.

Carbon intensity of generation sources (gCO2eq/kWh, NREL [17]) combined with
state grid mixes [18] for the four states with significant semiconductor
fabrication activity. ``mix_intensity`` reproduces the paper's Mix row
(AZ 395 / CA 234 / TX 438 / NY 188) exactly from first principles — this is a
hard validation target in tests/test_lca.py.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

# gCO2eq per kWh by generation source (Table 1, left column; NREL [17]).
SOURCE_INTENSITY_G_PER_KWH: Dict[str, float] = {
    "coal": 980.0,
    "natural_gas": 465.0,
    "geothermal": 27.0,
    "hydroelectric": 24.0,
    "solar_pv": 65.0,
    "wind": 11.0,
    "nuclear": 27.0,
    "biopower": 54.0,
}

# State grid mixes (Table 1; fractions of generation). Rows absent from the
# paper's table are 0.
GRID_MIXES: Dict[str, Dict[str, float]] = {
    "AZ": {"coal": 0.20, "natural_gas": 0.40, "hydroelectric": 0.05,
           "solar_pv": 0.07, "nuclear": 0.28},
    "CA": {"coal": 0.03, "natural_gas": 0.39, "geothermal": 0.05,
           "hydroelectric": 0.18, "solar_pv": 0.20, "wind": 0.07,
           "nuclear": 0.07, "biopower": 0.03},
    "TX": {"coal": 0.19, "natural_gas": 0.53, "solar_pv": 0.02,
           "wind": 0.17, "nuclear": 0.09},
    "NY": {"natural_gas": 0.37, "hydroelectric": 0.22, "solar_pv": 0.02,
           "wind": 0.04, "nuclear": 0.33},
}

# The paper's published Mix row, used only as a test oracle.
PAPER_MIX_ROW = {"AZ": 395.0, "CA": 234.0, "TX": 438.0, "NY": 188.0}


def mix_intensity(mix: Mapping[str, float] | str) -> float:
    """gCO2eq/kWh of a grid mix (state name or explicit source->fraction map)."""
    if isinstance(mix, str):
        try:
            mix = GRID_MIXES[mix]
        except KeyError as e:
            raise KeyError(f"unknown grid mix {mix!r}; have {sorted(GRID_MIXES)}") from e
    total_frac = sum(mix.values())
    # The paper's own columns sum to 98-102% (rounded percentages); accept that.
    if not 0.0 < total_frac <= 1.05:
        raise ValueError(f"grid mix fractions sum to {total_frac}, expected (0, 1.05]")
    return sum(SOURCE_INTENSITY_G_PER_KWH[src] * frac for src, frac in mix.items())


def all_mix_intensities(states: Iterable[str] = ("AZ", "CA", "TX", "NY")) -> Dict[str, float]:
    return {s: mix_intensity(s) for s in states}


def intensity_range(states: Iterable[str] = ("AZ", "CA", "TX", "NY")) -> tuple[float, float]:
    """(min, max) gCO2eq/kWh over the given states — the paper's range columns."""
    vals = [mix_intensity(s) for s in states]
    return min(vals), max(vals)


def kwh_to_gco2(kwh: float, mix: Mapping[str, float] | str) -> float:
    return kwh * mix_intensity(mix)


def joules_to_gco2(joules: float, mix: Mapping[str, float] | str) -> float:
    return kwh_to_gco2(joules / 3.6e6, mix)
