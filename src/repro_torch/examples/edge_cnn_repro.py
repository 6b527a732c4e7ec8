"""Paper-faithful edge workload: AlexNet ternary inference + FP32 training,
with the full Table-2/3 + Figure-2 sustainability analysis (mirror of
``examples/edge_cnn_repro.py``).

This is the paper's experiment end-to-end: quantize the CNN the way the PIM
engine does (TWN ternary, multiplication-free execution contract), compare
platform efficiencies from the measured Table-3 points, and decide between
accelerators with Eq. 1. Unlike the reference, whose ternary logits come
from the dequantized weights, the ternary FC layers run through the
ternary matmul (K11) by way of ``matmul_fn``; the dequantized forward is
computed beside it and the largest difference between the two routes is
printed.

    PYTHONPATH=src python -m repro_torch.examples.edge_cnn_repro [--device cpu]
"""

import argparse

import torch

from repro_torch import device as device_lib
from repro_torch.configs import base as cfgbase
from repro_torch.core import advisor, energy, sustain
from repro_torch.core.sustain import Duty, SECONDS_PER_DAY, SECONDS_PER_YEAR
from repro_torch.kernels import ops as kops
from repro_torch.models import cnn
from repro_torch.quant import ternary


def ternary_mm(x: torch.Tensor, w) -> torch.Tensor:
    """The FC matmul of the ternary route: K11 for ternary leaves."""
    if isinstance(w, ternary.TernaryWeight):
        return kops.ternary_matmul(x, w)
    return x @ w.to(x.dtype)


def fc_predicate(name: str, x: torch.Tensor) -> bool:
    """Only the FC weights become ternary, as in the reference example."""
    return x.ndim == 2 and "fc" in name


@torch.no_grad()
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)

    # -- 1. the workload: AlexNet (reduced), fp32 vs ternary ----------------
    cfg = cfgbase.get("alexnet").make_smoke()
    params = cnn.init_cnn(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    imgs = torch.randn((8, cfg.image_size, cfg.image_size, cfg.in_channels),
                       generator=gen, device=dev)
    logits_fp32 = cnn.forward(params, cfg, imgs)

    qparams = ternary.quantize_tree(params, predicate=fc_predicate)
    logits_tern = cnn.forward(qparams, cfg, imgs, matmul_fn=ternary_mm)
    logits_deq = cnn.forward(ternary.dequantize_tree(qparams), cfg, imgs)
    route_diff = float((logits_tern - logits_deq).abs().max())
    agree = float((logits_fp32.argmax(-1) == logits_tern.argmax(-1))
                  .float().mean())
    print(f"AlexNet ternary-FC inference: top-1 agreement with fp32 = "
          f"{agree:.0%}")
    print(f"  ternary route (K11) vs dequantized forward: max |diff| = "
          f"{route_diff:.3e} (max |logit| "
          f"{float(logits_deq.abs().max()):.3e})")
    print("  (paper: ternary model reduction keeps reasonable accuracy; "
          "training stays FP32)\n")

    # -- 2. Table 3: who executes it most efficiently? -----------------------
    print("Table 3 (inference, ternary PIM):")
    for name, row in energy.table3_efficiency("alexnet",
                                              "inference_ternary").items():
        print(f"  {name:10s} {row['throughput']:7.1f} FPS @ "
              f"{row['power_w']:.2f} W -> {row['per_w']:6.1f} FPS/W, "
              f"{row['carbon_eff_min']:.2f}-{row['carbon_eff_max']:.2f} "
              f"MF/gCO2eq")

    # -- 3. Fig 2a: replace deployed DDR3-PIM with RM-PIM? --------------------
    rm = sustain.platform_from_hw("rm_pim", "alexnet", "inference_ternary",
                                  per_module=True)
    ddr = sustain.platform_from_hw("ddr3_pim", "alexnet", "inference_ternary",
                                   per_module=True)
    print("\nFig 2a break-even (RM-PIM replacing deployed DDR3-PIM):")
    for a in (1.0, 0.5, 0.25):
        c = sustain.compare(rm, ddr, Duty(a), ref_throughput=ddr.throughput)
        print(f"  activity {a:4.0%}: t_B = "
              f"{c.breakeven_s / SECONDS_PER_DAY:5.0f} days")

    # -- 4. Fig 2b + Eq.1 decision: GPU vs RM for on-line training -----------
    gpu = sustain.platform_from_hw("gpu", "alexnet", "train_fp32")
    rmt = sustain.platform_from_hw("rm_pim", "alexnet", "train_fp32")
    fpga = sustain.platform_from_hw("fpga", "alexnet", "train_fp32")
    print("\nFig 2b indifference (GPU vs RM-PIM, FP32 training):")
    cross = sustain.crossover_activity(gpu, rmt, ref_throughput=rmt.throughput)
    print(f"  GPU beats RM above activity ratio {cross:.0%} "
          f"(paper: 'at least 40%')")
    for a in (0.3, 0.6, 0.9):
        rec = advisor.recommend([gpu, rmt, fpga], Duty(a),
                                5 * SECONDS_PER_YEAR,
                                ref_throughput=rmt.throughput)
        print(f"  activity {a:4.0%}: winner={rec.winner} "
              f"(dominated: {rec.dominated})")
    return {"route_max_abs_diff": route_diff, "top1_agreement": agree}


if __name__ == "__main__":
    main()
