"""Flash-attention timings of the PyTorch port on the card, for a
before/after comparison of two checkouts: K6 (``flash_attention_fwd``), K7
(``flash_attention_bwd_dq``) and K8 (``flash_attention_bwd_dkv``) against
their plain versions and against the SDPA forward and backward at the
training path's shapes (B = 2, S = 2048, H = 36, Hkv = 4, D = 128,
causal), fp32 and bf16, windows -1 and 256, and K10 (``flash_attention``)
in each of its modes against the SDPA forward; the kernels and the SDPA
calls by device time (torch.profiler), their CUDA-event times beside.

    PYTHONPATH=src python src/repro_torch/benchmarks/flash_bwd_bench.py \\
        [--dims]
    PYTHONPATH=<older checkout>/src \\
        python src/repro_torch/benchmarks/flash_bwd_bench.py

The measurement is chip_smoke.py's own, loaded from the checkout this file
lies in: its ``phase_device`` (the card's name and power limit, TF32 off),
``phase_flash_kernels`` (K6-K8 against their plain versions, two calls of
each equal bit for bit) and ``phase_flash_infer`` (K10, two calls equal
bit for bit). Those call only the kernels' public
wrappers, so the second command times an older checkout's kernels on the
same inputs. ``--dims`` adds ``phase_flash_ragged``,
``phase_flash_small_dims`` and ``phase_flash_wide_dims`` (K6-K8 and K10 at
the ragged shapes and at head dims 8, 16, 24, 112 and 168, checked and
timed), which assert this checkout's routes. Prints JSON lines, with the
flash source's ptxas lines (registers and spills) by kernel instance.
Needs a card.
"""

from __future__ import annotations

import importlib.util
import re
import sys
from pathlib import Path

import torch


def _chip_smoke():
    """chip_smoke.py of the checkout this file lies in, as a module."""
    path = Path(__file__).resolve().parents[3] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _template_args(tail: str) -> str:
    """The template arguments at the head of ``tail``, the rest of a
    mangled kernel name after its identifier (``ILi168ELb0ELb1EEEv..``:
    ``<168, 0, 1>``): literals, named types, one-letter builtins."""
    if not tail.startswith("I"):
        return ""
    args, i = [], 1
    while i < len(tail) and tail[i] != "E":
        if tail[i] == "L":                  # a literal: L <type> <value> E
            j = tail.index("E", i)
            args.append(tail[i + 2:j])
            i = j + 1
        elif tail[i].isdigit():             # a named type: <length> <name>
            n = re.match(r"\d+", tail[i:]).group()
            start = i + len(n)
            args.append(tail[start:start + int(n)])
            i = start + int(n)
        else:
            args.append({"f": "float", "a": "int8_t"}.get(tail[i], tail[i]))
            i += 1
    return "<" + ", ".join(args) + ">"


def ptxas_by_kernel(log: str) -> dict:
    """ptxas's register and spill lines of an nvcc log (``-Xptxas -v``) by
    kernel instance: ``flash_fwd_bf16_kernel<168, 0, 1>`` and the like,
    from each line "Compiling entry function" that precedes them."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = key = m.group(1)
            for n in re.finditer(r"\d+", name):
                word = name[n.end():n.end() + int(n.group())]
                if word.endswith("_kernel"):
                    key = word + _template_args(
                        name[n.end() + int(n.group()):])
                    break
        elif key and ("registers" in line or "spill" in line):
            out.setdefault(key, []).append(line.strip())
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_bench: needs a CUDA device")
    cs = _chip_smoke()
    from repro_torch.kernels import build
    cs.phase_device()
    build.build(["flash_attention"])
    cs.emit({"phase": "checkout", "src": str(Path(build.__file__).parents[2]),
             "flash_attention_ptxas": ptxas_by_kernel(
                 build.build_log("flash_attention"))})
    cs.phase_flash_kernels()
    cs.phase_flash_infer()
    if "--dims" in sys.argv[1:]:
        cs.phase_flash_ragged()
        cs.phase_flash_small_dims()
        cs.phase_flash_wide_dims()


if __name__ == "__main__":
    main()
