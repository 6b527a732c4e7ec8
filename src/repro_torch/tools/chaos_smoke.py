"""Quick chaos smoke of the port (mirror of ``tools/chaos_smoke.py``):
every transient fault kind must drain with streams identical to the
fault-free run's.

    python -m repro_torch.tools.chaos_smoke [--device cpu]

Runs on the card unless ``--device cpu`` is given. ``process_kill`` has no
in-tick recovery (its restart is the durability tier's), so it is not in
the loop. The gates are ``tests/test_torch_faults.py``,
``tests/test_torch_ladder.py`` and chip_smoke.py's chaos phases.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.serve import (TRANSIENT_FAULT_KINDS, FaultPlan, ServeConfig,
                               ServeEngine)

PROMPTS = [np.arange(15), np.arange(11) + 7, np.arange(8) + 30]


def run(params, cfg, device, plan=None):
    eng = ServeEngine(params, cfg, ServeConfig(
        max_slots=2, max_len=64, paged=True, page_size=4, faults=plan,
        device=device))
    for p in PROMPTS:
        eng.submit(p, max_tokens=8)
    done = eng.run_until_drained(max_ticks=400)
    return eng, {r.uid: list(r.generated) for r in done}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)
    cfg = tf_lib.LMConfig(name="t", d_model=48, n_heads=4, n_kv_heads=2,
                          d_ff=96, vocab=61, pattern=(tf_lib.BlockSpec(),),
                          repeats=2, vocab_pad_multiple=1)
    params = tf_lib.init_lm(cfg, seed=0, dtype=torch.float32, device=dev)
    _, base = run(params, cfg, str(dev))
    print("baseline:", base)
    for kind in TRANSIENT_FAULT_KINDS:
        plan = FaultPlan.single(kind, tick=2, seed=11, slot=1)
        eng, got = run(params, cfg, str(dev), plan)
        s = eng.summary()
        ident = got == base
        print(f"{kind:16s} inj={s['faults_injected']} "
              f"quar={s['quarantined']} shed={s['shed']} "
              f"retries={s['readback_retries']} "
              f"rec_j={s['recovery_j']:.3e} identical={ident}")
        if not ident:
            raise SystemExit(f"{kind}: streams {got} differ from the "
                             f"fault-free run's {base}")
    print("ALL PASS")


if __name__ == "__main__":
    main()
