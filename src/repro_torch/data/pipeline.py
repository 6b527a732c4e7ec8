"""Deterministic, shardable, resumable token pipeline.

Copy of ``repro.data.pipeline`` for the PyTorch port, which imports
nothing of ``repro``; the module is numpy only and the code is unchanged.

Properties the trainer depends on (all tested):

* **Determinism**: batch at global step s is a pure function of
  (seed, step, shard) — restarts and elastic re-sharding reproduce the
  exact token stream with no iterator state beyond the step counter.
* **Sharding**: each DP rank reads only its slice (host-sharded loading);
  re-sharding to a different DP size re-slices the same global batch.
* **Resumability**: state is {step}; checkpointing it costs 8 bytes.

Sources: "synthetic" (seeded uniform tokens), "lm1b-like" Markov-chain tokens
(learnable structure — used by the loss-goes-down tests), or a binary token
file (np.memmap) for real corpora.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"      # "synthetic" | "markov" | "file"
    path: Optional[str] = None     # token file (uint16/uint32 binary)
    markov_order: int = 1
    dp_rank: int = 0
    dp_size: int = 1

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.dp_size == 0, (
            self.global_batch, self.dp_size)
        return self.global_batch // self.dp_size


class TokenPipeline:
    """Stateless-per-step batch generator; ``state`` is just the step."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._step = 0
        self._mm = None
        self._markov_T: Optional[np.ndarray] = None
        if cfg.source == "file":
            if not cfg.path:
                raise ValueError("source='file' needs cfg.path")
            self._mm = np.memmap(cfg.path, dtype=np.uint32, mode="r")
        elif cfg.source == "markov":
            rng = np.random.default_rng(cfg.seed ^ 0x5EED)
            t = rng.dirichlet(np.full(cfg.vocab, 0.05), size=cfg.vocab)
            self._markov_T = np.cumsum(t, axis=1)

    # -- state ---------------------------------------------------------------

    @property
    def state(self) -> Dict[str, int]:
        return {"step": self._step}

    def restore(self, state: Dict[str, int]) -> None:
        self._step = int(state["step"])

    # -- batch synthesis -------------------------------------------------------

    def _rng_for(self, step: int, row: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.cfg.seed * 0x9E3779B1 + step) * 0x85EBCA6B + row)

    def _row(self, step: int, global_row: int) -> np.ndarray:
        cfg = self.cfg
        n = cfg.seq_len + 1
        if cfg.source == "file":
            total = len(self._mm) - n
            off = int(self._rng_for(step, global_row).integers(0, total))
            return np.asarray(self._mm[off:off + n], dtype=np.int32) % cfg.vocab
        rng = self._rng_for(step, global_row)
        if cfg.source == "markov":
            out = np.empty(n, np.int32)
            out[0] = rng.integers(0, cfg.vocab)
            u = rng.random(n - 1)
            for i in range(1, n):
                out[i] = np.searchsorted(self._markov_T[out[i - 1]], u[i - 1])
            return np.clip(out, 0, cfg.vocab - 1)
        return rng.integers(0, cfg.vocab, size=n, dtype=np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        lo = cfg.dp_rank * cfg.local_batch
        rows = np.stack([self._row(step, lo + i) for i in range(cfg.local_batch)])
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self._step)
        self._step += 1
        return b

    def reshard(self, dp_rank: int, dp_size: int) -> "TokenPipeline":
        """Elastic re-sharding: same global stream, new slice, same step."""
        new = TokenPipeline(dataclasses.replace(self.cfg, dp_rank=dp_rank,
                                                dp_size=dp_size))
        new._step = self._step
        return new


def make_pipeline(cfg: DataConfig) -> TokenPipeline:
    return TokenPipeline(cfg)


def write_token_file(path: str, tokens: np.ndarray) -> None:
    tokens.astype(np.uint32).tofile(path)
