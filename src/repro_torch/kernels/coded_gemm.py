"""Shape rules of the coded GEMM (``csrc/coded_gemm.cuh``), the tensor-core
body that K9 (``int8_matmul.int8_matmul_dx``) and K11 at M > 8
(``ternary_matmul.ternary_matmul``) launch, and the per-stream counters
that every split kernel of the port meets through.

In the body's terms the output (M, N_out) is an activation (M, K_c) times
int8 codes, contracted over K_c: for K9 N_out is dx's K and K_c the
cotangent's N; for K11 N_out is y's N and K_c x's K. A block computes a
64 x 256 output tile over 64-deep stages of the contraction; ``plan``
splits the stages across blocks where the tiles alone would leave SMs idle.
Nothing here launches anything, so the CPU tests check it directly.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

# the kernel's shape (kBM, kBN, kBK): rows of A and output columns a block,
# contraction a stage; a split block's partial is its tile in fp32
BM = 64
BN = 256
BK = 64
TILE_FLOATS = BM * BN
# the planner's rules: a split at least this many stages long, at most this
# many splits
MIN_SPLIT_STAGES = 4
MAX_SPLITS = 64

_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def tiles(m: int, n_out: int) -> int:
    """Output tiles (blocks of one split) for an (m, n_out) output."""
    return -(-n_out // BN) * -(-m // BM)


def stages(kc: int) -> int:
    return -(-kc // BK)


def plan(m: int, n_out: int, kc: int, sms: int) -> int:
    """The contraction's splits: one where the tiles cover the ``sms`` SMs
    (one block an SM at a time), else as many as fit beside the tiles in
    one wave, each at least MIN_SPLIT_STAGES stages long, at most
    MAX_SPLITS: the last block of a tile adds every split's partial, so
    short splits cost more in that sum than they save."""
    t = tiles(m, n_out)
    if t >= sms:
        return 1
    return max(1, min(sms // t, stages(kc) // MIN_SPLIT_STAGES, MAX_SPLITS))


def split_stages(kc: int, splits: int, z: int) -> Tuple[int, int]:
    """(first, end) stage of split z, as the kernel takes them (stage s:
    contraction rows 64 s .. 64 s + 63)."""
    n = stages(kc)
    return z * n // splits, (z + 1) * n // splits


def ws_floats(m: int, n_out: int, splits: int) -> int:
    """fp32 workspace of the splits' partial tiles (none for one split)."""
    return splits * tiles(m, n_out) * TILE_FLOATS if splits > 1 else 0


def counter_buffer(device: torch.device, stream: int,
                   count: int) -> torch.Tensor:
    """One int per output tile of a split launch, zero between launches
    (the last block of a tile resets it). One buffer per (device, stream),
    so launches on one stream, which run in turn, share it, and never
    launches that may run beside them."""
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < count:
        buf = torch.zeros(max(count, 256), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf
