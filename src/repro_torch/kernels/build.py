"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C entry point (no PyTorch headers, so a build
takes seconds, not minutes). Libraries land in ``build/kernels/`` at the
repository root, named by a hash of the source, the ``csrc/`` headers it
includes and the flags, so an edited source or header rebuilds and an
unchanged one is reused. ``build()`` starts one
``nvcc`` per source, all at once, and waits for all of them.

Nothing here runs at import: the CPU tests import every module, and the CPU
machine has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("decode_attention", "paged_decode_attention",
           "paged_prefill_attention")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return str(path)


def sources_of(name: str) -> List[Path]:
    """``name``'s ``.cu`` and every file of ``csrc/`` it includes, directly
    or through another include, in the order first met."""
    found: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            if (CSRC / inc).is_file():
                todo.append(CSRC / inc)
    return found


def library_path(name: str) -> Path:
    """Keyed on the source, the headers it includes and the flags: an edit
    to a shared header rebuilds every library that includes it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources_of(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source that has no library yet, one ``nvcc``
    each, all started together. Returns name -> library path; raises with
    the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {name: library_path(name) for name in names}
    procs = {}
    for name, lib in out.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log = open(lib.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, lib, log)
    failed = []
    for name, (proc, tmp, lib, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{name} (nvcc exit {rc}):\n{build_log(name)}")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


def build_log(name: str) -> str:
    """What nvcc printed for ``name``'s current library (ptxas registers,
    shared memory and spills, from ``-Xptxas -v``)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    return ctypes.CDLL(str(build([name])[name]))
