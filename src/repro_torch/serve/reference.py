"""Host-loop reference serving engine of the PyTorch port (mirror of
``repro.serve.reference``): the correctness oracle.

Per-prompt prefill, one single-row decode step per active slot with a
scalar position (so decode attention takes the masked-``sdpa`` branch, not
the K1 kernel), and host-side sampling with one ``int(tok)`` device sync
per slot per tick. Under greedy decoding the fused engine must be
token-identical to this. Given an int8 engine's ``params`` and ``cfg``
(``INT8_QUANT``) it runs the int8 mode too: projections through
``ops.int8_matmul``, an int8 cache dequantized at use. SSD and hybrid
archs run here too: each prompt is prefilled alone, so there is no
padding for an SSM state to integrate.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import accounting
from repro_torch.models import transformer as tf_lib
from repro_torch.models.layers import KVCache
from repro_torch.models.ssd import SSDState
from repro_torch.serve.engine import (PyTree, Request, ServeConfig,
                                      StepMetrics, cache_tensors)
from repro_torch.serve.sampling import _sample


def _row(caches: PyTree, slot: int) -> PyTree:
    """Slot ``slot`` of the batched cache as a batch-1 view (pattern caches
    carry batch at axis 1, behind the stacked layers; tail caches at 0),
    int8 scales and SSD states included; writes through it land in the
    batched cache."""
    out = {}
    for key, entry in caches.items():
        ax = 1 if key.startswith("pat") else 0
        if "ssd" in entry:
            out[key] = {"ssd": SSDState(*(t.narrow(ax, slot, 1)
                                          for t in entry["ssd"].tensors()))}
            continue
        out[key] = {"kv": KVCache(k=entry["kv"].k.narrow(ax, slot, 1),
                                  v=entry["kv"].v.narrow(ax, slot, 1)),
                    "pos": entry["pos"].narrow(ax, slot, 1)}
        if "kv_scale" in entry:
            sc = entry["kv_scale"]
            out[key]["kv_scale"] = KVCache(k=sc.k.narrow(ax, slot, 1),
                                           v=sc.v.narrow(ax, slot, 1))
    return out


class ReferenceEngine:
    """Slot-based continuous batching with a host-driven control loop."""

    def __init__(self, params: PyTree, cfg: tf_lib.LMConfig,
                 serve_cfg: ServeConfig,
                 accountant: Optional[accounting.CarbonAccountant] = None):
        self.device = device_lib.resolve(serve_cfg.device)
        self.params = params
        self.cfg = cfg
        self.scfg = serve_cfg
        self.accountant = accountant
        b = serve_cfg.max_slots
        self.caches = tf_lib.init_caches(cfg, b, serve_cfg.max_len,
                                         serve_cfg.cache_dtype,
                                         device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * b
        self.slot_pos = np.zeros(b, np.int64)
        self.slot_tok = np.zeros(b, np.int64)
        self.queue: Deque[Request] = deque()
        self._uid = 0
        self.metrics_log: List[StepMetrics] = []
        self._admit_finished: List[Request] = []

    def submit(self, prompt: np.ndarray, max_tokens: int = 16,
               temperature: Optional[float] = None) -> int:
        self._uid += 1
        self.queue.append(Request(self._uid, np.asarray(prompt, np.int32),
                                  max_tokens, temperature))
        return self._uid

    def _sample(self, logits: torch.Tensor, req: Request) -> int:
        """The engine's sampler on one row: the same (seed, uid, token
        index) key, so sampled streams match the engine's too."""
        temp = (self.scfg.temperature if req.temperature is None
                else req.temperature)
        dev = self.device
        tok = _sample(logits[None], self.scfg.seed,
                      torch.tensor([req.uid], device=dev),
                      torch.tensor([len(req.generated)], device=dev),
                      torch.tensor([temp], dtype=torch.float32, device=dev),
                      sampled=temp > 0)
        return int(tok[0])

    def _admit(self) -> None:
        for slot in range(self.scfg.max_slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            prompt = torch.from_numpy(req.prompt.astype(np.int64)).to(
                self.device)[None]
            logits, row_cache = tf_lib.prefill(
                self.params, self.cfg, prompt, max_len=self.scfg.max_len,
                cache_dtype=self.scfg.cache_dtype)
            row = _row(self.caches, slot)
            for key, entry in row.items():
                for dst, src in zip(cache_tensors(entry),
                                    cache_tensors(row_cache[key])):
                    dst.copy_(src)
            tok = self._sample(logits[0, -1], req)
            req.generated.append(tok)
            # the fused engine's admission-time finish rules
            if (req.max_tokens <= 1
                    or len(req.prompt) >= self.scfg.max_len - 1
                    or (self.scfg.eos_id >= 0 and tok == self.scfg.eos_id)):
                req.done = True
                self._admit_finished.append(req)
                continue
            self.slot_req[slot] = req
            self.slot_pos[slot] = len(req.prompt)
            self.slot_tok[slot] = tok

    def step(self) -> List[Request]:
        """Admit + one decode step per active slot. Returns finished."""
        t0 = time.monotonic()
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        finished: List[Request] = self._admit_finished
        self._admit_finished = []
        for i in active:
            req = self.slot_req[i]
            token = torch.tensor([[self.slot_tok[i]]], device=self.device)
            pos = torch.tensor(self.slot_pos[i], device=self.device)
            logits, _ = tf_lib.decode_step(self.params, self.cfg, token, pos,
                                           _row(self.caches, i))
            tok = self._sample(logits[0, 0], req)
            req.generated.append(tok)
            self.slot_pos[i] += 1
            self.slot_tok[i] = tok
            hit_eos = self.scfg.eos_id >= 0 and tok == self.scfg.eos_id
            if (len(req.generated) >= req.max_tokens or hit_eos
                    or self.slot_pos[i] >= self.scfg.max_len - 1):
                req.done = True
                finished.append(req)
                self.slot_req[i] = None
        m = StepMetrics(tokens=len(active), active_slots=len(active),
                        wall_s=time.monotonic() - t0,
                        queue_depth=len(self.queue))
        self.metrics_log.append(m)
        if self.accountant is not None:
            self.accountant.observe_serve(m)
        return finished

    def run_until_drained(self, max_ticks: int = 10000) -> List[Request]:
        done: List[Request] = []
        for _ in range(max_ticks):
            done.extend(self.step())
            if not self.queue and all(r is None for r in self.slot_req):
                break
        return done
