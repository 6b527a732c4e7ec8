"""Multi-rank runs of the port's parallel layer on gloo CPU process groups.

``run_ranks(world, task, workdir, inputs)`` spawns ``world`` processes,
each one torch thread, that meet through a ``FileStore`` under
``workdir`` (no TCP port: parallel test workers share the host), run
``task`` (a function of this module) on the numpy ``inputs`` and return
one dict of numpy arrays per rank. The process group and the join each
have a timeout, so a hang fails the test instead of stalling the run.
This module imports no JAX: the ranks start light.
"""

from __future__ import annotations

import datetime
import os
import pickle

GROUP_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 120


def _worker(rank: int, world: int, workdir: str, task: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group(
        "gloo", store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        out = globals()[task](rank, world, inputs)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, task: str, workdir, inputs: dict) -> list:
    import torch.multiprocessing as tmp
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    ctx = tmp.start_processes(_worker, args=(world, workdir, task),
                              nprocs=world, join=False,
                              start_method="spawn")
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=JOIN_TIMEOUT_S)
    try:
        while not ctx.join(timeout=1):
            if datetime.datetime.now() > deadline:
                raise TimeoutError(f"{task}: {world} ranks did not finish "
                                   f"in {JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    outs = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


# -- tasks: (rank, world, inputs) -> dict of numpy arrays ----------------------

def ring_task(rank, world, inputs):
    import torch
    from repro_torch.parallel import compression
    x = torch.from_numpy(inputs["ring_x"][rank])
    return {"ring": compression.ring_allreduce_int8(x).numpy()}


def stages_task(rank, world, inputs):
    """The pipeline (output and the stage weights' gradient) and moe_ep at
    each capacity factor, on one spawn of ``world`` ranks."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as moe_lib
    from repro_torch.parallel import pipeline

    ws = torch.from_numpy(inputs["pipe_w"]).requires_grad_(True)
    x = torch.from_numpy(inputs["pipe_x"])
    run = pipeline.make_pipelined_fn(lambda w, h: torch.tanh(h @ w),
                                     make_mesh((world,), ("pipe",)),
                                     n_micro=inputs["pipe_micro"])
    y = run(ws, x)
    (y ** 2).sum().backward()
    out = {"pipe_y": y.detach().numpy(), "pipe_g": ws.grad[rank].numpy()}

    p = {k: torch.from_numpy(v) for k, v in inputs["moe_params"].items()}
    e_loc = p["w_in"].shape[0] // world
    local = {k: (v if k == "router" else v[rank * e_loc:(rank + 1) * e_loc])
             for k, v in p.items()}
    xm = torch.from_numpy(inputs["moe_x"])
    for cf in inputs["moe_cfs"]:
        cfg = moe_lib.MoEConfig(**inputs["moe_cfg"], capacity_factor=cf)
        y, aux = moe_lib.moe_ep(local, cfg, xm)
        out[f"moe_y_{cf}"] = y.numpy()
        out[f"moe_aux_{cf}"] = aux.numpy()
    return out

