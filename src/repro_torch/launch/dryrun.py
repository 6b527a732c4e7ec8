"""Dry-run of the mesh cells on meta tensors: no device at all (the
counterpart of ``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --arch starcoder2-7b \\
        [--shape decode_32k] [--mesh single|multi|both|one] \\
        [--out records.jsonl] [--override '{"_weights_int8": true}']

For each (arch x shape x mesh) cell it builds the cell on meta tensors
(``launch.cells``) and records:

* the bytes of a device's shards of the arguments, from the placements
  (``memory.argument``), beside the analytic live-bytes estimate, each
  judged against ``core.hw.H100_SXM.mem_bytes`` (the reference judges
  fit against a v5e's 16 GiB);
* FLOPs and traffic from ``core.flops`` (one step run on the meta
  tensors: the aten ops it dispatches and the kernels' own counts), per
  device assuming an even split over the mesh;
* roofline terms at the ``h100_sxm`` peaks (``core.roofline``), marked
  ``modeled``: compute and memory only. The reference reads collective
  bytes from the compiled HLO; eager torch on meta tensors has no HLO, so
  ``collective_bytes_per_device`` is null, with the reason beside it,
  and the bound is the larger of the two terms it has.

Meshes: ``single`` 16 x 16, ``multi`` 2 x 16 x 16 (the production meshes,
as descriptions), ``one`` 1 x 1 (one card). A failing cell is recorded,
not raised. The process exits 1 if any record failed.
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from typing import Dict, Optional

from repro_torch.configs import base as cfgbase
from repro_torch.core import flops as flops_lib
from repro_torch.core import hw
from repro_torch.core import roofline as rl
from repro_torch.launch import cells as cells_lib
from repro_torch.launch.mesh import make_mesh, make_production_mesh

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "one": ((1, 1), ("data", "model"))}

NO_COLLECTIVES = ("not counted: the reference parses collective bytes from "
                  "the compiled HLO, and eager torch on meta tensors has "
                  "none")


def mesh_named(name: str):
    if name in ("single", "multi"):
        return make_production_mesh(multi_pod=name == "multi")
    return make_mesh(*MESHES[name])


def run_cell(arch_id: str, shape_name: str, multi_pod: bool = False,
             overrides: Optional[dict] = None, *, mesh_name: Optional[str]
             = None, shape: Optional[cfgbase.ShapeSpec] = None) -> Dict:
    """The record of one cell (``mesh_name`` overrides ``multi_pod``;
    ``shape`` a cut of ``SHAPES[shape_name]``)."""
    mesh_name = mesh_name or ("multi" if multi_pod else "single")
    mesh = mesh_named(mesh_name)
    n_dev = mesh.size
    label = f"{arch_id}/{shape_name}/{mesh_name}"
    rec: Dict = {"arch": arch_id, "shape": shape_name,
                 "mesh": "x".join(str(n) for n in mesh.sizes),
                 "n_devices": n_dev, "label": label,
                 "overrides": overrides or {}}
    if shape is not None:
        rec["shape_spec"] = {"seq_len": shape.seq_len,
                             "global_batch": shape.global_batch}
    t0 = time.time()
    try:
        cell = cells_lib.build_cell(arch_id, shape_name, mesh, overrides,
                                    shape=shape)
        t_build = time.time() - t0
        analytic = flops_lib.cost_of_fn(cell.step_fn, *cell.args_meta,
                                        n_devices=n_dev)
        t_cost = time.time() - t0 - t_build
        arg_dev = sum(cells_lib.local_bytes(a, pl, mesh)
                      for a, pl in zip(cell.args_meta, cell.in_shardings))
        dev = hw.H100_SXM
        terms = rl.RooflineTerms(
            flops_per_device=analytic["flops_per_device"],
            bytes_per_device=analytic["traffic_per_device"],
            collective_bytes_per_device=0.0, n_devices=n_dev,
            peak_flops=dev.peak_flops, hbm_bw=dev.hbm_bw,
            link_bw=dev.link_bw, label=label)
        model_flops = (
            rl.model_flops_train(cell.n_params_active, cell.tokens_per_step)
            if cell.kind == "train" else
            rl.model_flops_infer(cell.n_params_active, cell.tokens_per_step))
        step_s = max(terms.compute_s, terms.memory_s)
        rec.update(
            ok=True, kind=cell.kind, device=dev.name, modeled=True,
            build_s=round(t_build, 1), cost_s=round(t_cost, 1),
            n_params_total=cell.n_params_total,
            n_params_active=cell.n_params_active,
            tokens_per_step=cell.tokens_per_step,
            model_flops=model_flops,
            memory=dict(
                argument=arg_dev,
                analytic_live=cell.analytic_live_bytes,
                hbm_bytes=dev.mem_bytes,
                fits_hbm=bool(arg_dev <= dev.mem_bytes),
                fits_hbm_analytic=bool(cell.analytic_live_bytes
                                       <= dev.mem_bytes),
            ),
            flops_per_device=terms.flops_per_device,
            bytes_per_device=terms.bytes_per_device,
            flops_by_prim=analytic["by_prim"],
            collective_bytes_per_device=None,
            collective_note=NO_COLLECTIVES,
            compute_s=terms.compute_s, memory_s=terms.memory_s,
            collective_s=None,
            bound="compute" if terms.compute_s >= terms.memory_s
            else "memory",
            step_time_s=step_s,
            useful_flops_ratio=terms.useful_flops_ratio(model_flops),
            roofline_fraction=(model_flops / n_dev / (step_s
                                                      * dev.peak_flops)
                               if step_s > 0 else 0.0),
            notes=cell.notes,
        )
    except Exception as e:  # recorded, not raised: the table shows the bug
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    rec["wall_s"] = round(time.time() - t0, 1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True,
                    help="arch id or 'all' (LM/enc-dec archs)")
    ap.add_argument("--shape", default="all",
                    help="shape name or 'all' (arch-applicable shapes)")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both", "one"])
    ap.add_argument("--out", default=None, help="append-JSONL output path")
    ap.add_argument("--override", default=None,
                    help="JSON dict of LMConfig overrides and cell flags")
    args = ap.parse_args(argv)

    arch_ids = (cfgbase.all_arch_ids(lm_only=True) if args.arch == "all"
                else [args.arch])
    overrides = json.loads(args.override) if args.override else None
    meshes = {"both": ["single", "multi"]}.get(args.mesh, [args.mesh])

    results = []
    for arch_id in arch_ids:
        arch = cfgbase.get(arch_id)
        shapes = arch.shapes if args.shape == "all" else [args.shape]
        for shape_name in shapes:
            for mesh_name in meshes:
                rec = run_cell(arch_id, shape_name, overrides=overrides,
                               mesh_name=mesh_name)
                results.append(rec)
                status = "OK " if rec.get("ok") else "FAIL"
                extra = (f"bound={rec.get('bound')} "
                         f"t={rec.get('step_time_s', 0):.4f}s "
                         f"fit={rec.get('memory', {}).get('fits_hbm')}"
                         if rec.get("ok") else rec.get("error"))
                print(f"[{status}] {rec['label']:45s} "
                      f"wall={rec['wall_s']:6.1f}s {extra}", flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    n_ok = sum(1 for r in results if r.get("ok"))
    print(f"\n{n_ok}/{len(results)} cells OK")
    if n_ok < len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
