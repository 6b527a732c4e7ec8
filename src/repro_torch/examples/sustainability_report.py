"""Sustainability report: the paper's tables (mirror of
``examples/sustainability_report.py``).

Regenerates Table 1/2/3 and the Figure-2 analyses from first principles.
The reference's second section, the fleet extension, reads TPU dry-run
roofline records that ``launch/dryrun.py`` writes; the port has no dry-run
yet (ROADMAP item 13), so that section says so and stops.

    PYTHONPATH=src python -m repro_torch.examples.sustainability_report
"""

from repro_torch.core import energy, grid, lca, sustain
from repro_torch.core.sustain import Duty


def paper_tables():
    print("=" * 72)
    print("PAPER REPRODUCTION")
    print("=" * 72)
    print("\nTable 1 — grid mixes (gCO2eq/kWh):")
    for s, v in grid.all_mix_intensities().items():
        print(f"  {s}: {v:6.1f}   (paper: {grid.PAPER_MIX_ROW[s]:.0f})")

    print("\nTable 2 — embodied energy/carbon per die:")
    for label, row in lca.table2().items():
        ref = lca.PAPER_TABLE2[label]
        print(f"  {label:18s} PE={row['pe_kwh']:6.0f} kWh/wafer  "
              f"E={row['mj_die']:6.2f} MJ (paper {ref['mj_die']:5.2f})  "
              f"NY={row['ny']:5.0f} g (paper {ref['ny']})")

    print("\nTable 3 — operational efficiency:")
    for bench, phase in (("alexnet", "inference_ternary"),
                         ("alexnet", "train_fp32"), ("vgg16", "train_fp32")):
        for dev, row in energy.table3_efficiency(bench, phase).items():
            print(f"  {bench:8s} {phase:17s} {dev:9s} "
                  f"{row['per_w']:7.2f}/W  "
                  f"{row['carbon_eff_min']:7.2f}-{row['carbon_eff_max']:7.2f} "
                  f"{row['carbon_eff_unit']}")

    print("\nFigure 2 — break-even / indifference claims:")
    rm = sustain.platform_from_hw("rm_pim", "alexnet", "inference_ternary",
                                  per_module=True)
    ddr = sustain.platform_from_hw("ddr3_pim", "alexnet", "inference_ternary",
                                   per_module=True)
    for a in (1.0, 0.5):
        c = sustain.compare(rm, ddr, Duty(a), ref_throughput=ddr.throughput)
        print(f"  2a: RM replaces DDR3 @ {a:.0%} activity: "
              f"{c.breakeven_s/86400:.0f} days")
    for bench in ("alexnet", "vgg16"):
        gpu = sustain.platform_from_hw("gpu", bench, "train_fp32")
        rmt = sustain.platform_from_hw("rm_pim", bench, "train_fp32")
        cr = sustain.crossover_activity(gpu, rmt, ref_throughput=rmt.throughput)
        print(f"  2b/2c: GPU beats RM ({bench}) above activity {cr:.0%}")


def fleet_report():
    print("\n(fleet section: it reads the TPU dry-run records of "
          "launch/dryrun.py, which the port does not have yet: ROADMAP "
          "item 13)")


def main(argv=None):
    paper_tables()
    fleet_report()


if __name__ == "__main__":
    main()
