"""Durability layer of the port's serve engine (mirror of
``repro.serve.snapshot``).

A process death loses every live stream's device state, the paged pool,
the prefix registry and the queue. This module supplies the host-side
halves of a crash-consistent warm restart:

* **Write-ahead journal** (:class:`Journal`): an append-only JSONL file of
  sequence-numbered records. A ``submit`` record is fsync'd before the
  request is acknowledged (an acked request survives any crash); one
  ``tick`` record per engine tick holds which requests finished and with
  exactly which tokens. The engine is seeded and deterministic end to end
  (the counter-based sampler keyed on seed, uid and token index, seeded
  fault injection, deterministic scheduling), so *replaying* the journaled
  admissions and ticks from a snapshot reproduces every stream; the tick
  records double as a divergence detector during replay. The records are
  the JAX package's, byte for byte.
* **Host state (de)serialization**: ``host_state_dict`` /
  ``install_host_state`` round-trip every host mirror the engine keeps
  beside its device tensors (slot tables, page ownership, prefix registry,
  fork groups, recovery ledgers, guardrail EWMAs, the injector's RNG
  state, accountant ledgers) as a JSON-able dict that rides the checkpoint
  manifest's ``extra`` field. The device tensors go through
  ``repro_torch/checkpoint/manager.py`` (atomic rename, keep-k, checksum).
* **Shared consistency checker** (:func:`reconcile_ownership`): the
  refcount and ownership reconciliation that ``ServeEngine._run_audit``
  runs every audit interval and that snapshot load runs before serving: a
  tampered or bit-rotted checkpoint fails loudly with the violated
  invariant named.

Torn writes are handled at both ends: the checkpoint directory appears
atomically (manager), and ``Journal`` truncates a torn trailing record on
open, so a crash mid-append costs at most the unacked record being written.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.train.ft import Ewma

# the JSON spelling of a fork stream resolved as a mirror of stream 0
# (engine._FORK_MIRROR is an object())
_MIRROR_TAG = "__mirror__"


# -- write-ahead journal ------------------------------------------------------


class Journal:
    """Append-only, crash-tolerant JSONL journal.

    Record framing is one JSON object per ``\\n``-terminated line with a
    monotonically increasing ``seq``. On open, any torn tail (bytes after
    the last parsable newline-terminated record: a crash mid-append) is
    truncated so later appends can never merge into a half-written line;
    ``seq`` continues from the last good record. ``submit`` records are
    fsync'd (the ack must be durable); ``tick`` records are flushed only:
    a lost trailing tick record just means that tick replays live.
    """

    def __init__(self, path: str):
        self.path = path
        self.seq = 0
        self.bytes_written = 0
        if os.path.exists(path):
            with open(path, "rb") as f:
                raw = f.read()
            good_end, last_seq, pos = 0, -1, 0
            while True:
                nl = raw.find(b"\n", pos)
                if nl < 0:
                    break
                try:
                    rec = json.loads(raw[pos:nl])
                    last_seq = int(rec["seq"])
                except (ValueError, KeyError, TypeError):
                    break
                good_end = nl + 1
                pos = nl + 1
            if good_end < len(raw):
                with open(path, "r+b") as f:
                    f.truncate(good_end)
            self.seq = last_seq + 1
            self.bytes_written = good_end
        self._f = open(path, "a", encoding="utf-8")

    def _append(self, rec: Dict[str, Any], fsync: bool) -> int:
        rec["seq"] = self.seq
        line = json.dumps(rec, sort_keys=True) + "\n"
        data = line.encode("utf-8")
        self._f.write(line)
        self._f.flush()
        if fsync:
            os.fsync(self._f.fileno())
        self.seq += 1
        self.bytes_written += len(data)
        return len(data)

    def append_submit(self, *, uid: int, prompt: List[int], max_tokens: int,
                      temperature: Optional[float],
                      deadline_ticks: Optional[int], n_best: int,
                      tick: int) -> int:
        """Durably record one admission BEFORE it is acked. Returns bytes
        written (billed as durability write traffic)."""
        return self._append({
            "kind": "submit", "uid": uid, "prompt": prompt,
            "max_tokens": max_tokens, "temperature": temperature,
            "deadline_ticks": deadline_ticks, "n_best": n_best,
            "tick": tick}, fsync=True)

    def append_tick(self, *, tick: int,
                    finished: List[List[Any]]) -> int:
        """Record one completed tick and its finished streams
        (``[[uid, generated, nbest-or-null], ...]``). Every tick gets a
        record, idle ones too: fault schedules and deadlines key on the
        absolute tick index, so replay must count them."""
        return self._append({"kind": "tick", "tick": tick,
                             "finished": finished}, fsync=False)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def records(self) -> List[Dict[str, Any]]:
        """Parse the journal from disk, stopping at the first unparsable
        line (a torn tail that raced the truncating open)."""
        out: List[Dict[str, Any]] = []
        if not os.path.exists(self.path):
            return out
        with open(self.path, "rb") as f:
            for line in f:
                if not line.endswith(b"\n"):
                    break
                try:
                    out.append(json.loads(line))
                except ValueError:
                    break
        return out


# -- shared refcount/ownership reconciliation ---------------------------------


def reconcile_ownership(pool, slot_pages: List[List[int]],
                        spike_holds: List[Tuple[int, List[int]]]
                        ) -> List[str]:
    """Reconcile the engine's page-ownership mirrors against the pool's
    refcounts: every page the engine holds (slot page lists plus the
    injector's spike holds) must carry at least that many pool references,
    and no slot may list a page twice. Returns violation strings (empty =
    consistent). Shared by the periodic audit and snapshot load, so a
    bit-rotted checkpoint fails the same invariants a live corruption
    would."""
    violations: List[str] = []
    owned: Dict[int, int] = {}
    for slot, pages in enumerate(slot_pages):
        if len(set(pages)) != len(pages):
            violations.append(f"slot {slot} lists a page twice")
        for p in pages:
            owned[p] = owned.get(p, 0) + 1
    for _, pages in spike_holds:
        for p in pages:
            owned[p] = owned.get(p, 0) + 1
    for p in sorted(owned):
        n = owned[p]
        ref = pool.refcount(p)
        if ref < n:
            violations.append(
                f"page {p}: engine holds {n} refs, pool says {ref}")
    return violations


# -- request (de)serialization ------------------------------------------------


def request_to_dict(req) -> Dict[str, Any]:
    return {
        "uid": int(req.uid),
        "prompt": [int(t) for t in np.asarray(req.prompt).tolist()],
        "max_tokens": int(req.max_tokens),
        "temperature": req.temperature,
        "generated": [int(t) for t in req.generated],
        "done": bool(req.done),
        "deadline_ticks": req.deadline_ticks,
        "submit_tick": int(req.submit_tick),
        "n_best": int(req.n_best),
        "nbest": ([[int(t) for t in s] for s in req.nbest]
                  if req.nbest is not None else None),
        "fork_group": req.fork_group,
        "fork_idx": int(req.fork_idx),
    }


def request_from_dict(d: Dict[str, Any]):
    from repro_torch.serve.engine import Request
    req = Request(
        int(d["uid"]), np.asarray(d["prompt"], np.int32),
        max_tokens=int(d["max_tokens"]), temperature=d["temperature"],
        deadline_ticks=d["deadline_ticks"],
        submit_tick=int(d["submit_tick"]), n_best=int(d["n_best"]),
        fork_group=d["fork_group"], fork_idx=int(d["fork_idx"]))
    req.generated = [int(t) for t in d["generated"]]
    req.done = bool(d["done"])
    if d["nbest"] is not None:
        req.nbest = [[int(t) for t in s] for s in d["nbest"]]
    return req


def _ewma_to_list(e: Ewma) -> List[Any]:
    return [e.value, int(e.n)]


def _ewma_from_list(v: List[Any], alpha: float) -> Ewma:
    e = Ewma(alpha=alpha)
    e.value = v[0]
    e.n = int(v[1])
    return e


# ServeConfig fields that must match between the snapshotting and the
# restoring process: a mismatch would silently change replay semantics
_FINGERPRINT_FIELDS = (
    "max_slots", "max_len", "eos_id", "temperature", "seed", "quant",
    "paged", "page_size", "num_pages", "prefix_cache", "prefill_chunk",
    "spec_k", "spec_drafter", "spec_tree_m", "compact_threshold",
    "evict_policy")


def _dtype_name(dtype) -> str:
    """A cache dtype as numpy spells it (``"float32"``, ``"bfloat16"``):
    the JAX package's fingerprint spelling, for a torch dtype or anything
    numpy knows."""
    name = str(dtype)
    if name.startswith("torch."):
        return name[len("torch."):]
    return str(np.dtype(dtype))


def config_fingerprint(scfg) -> Dict[str, Any]:
    fp = {f: getattr(scfg, f) for f in _FINGERPRINT_FIELDS}
    fp["cache_dtype"] = _dtype_name(scfg.cache_dtype)
    return fp


def check_fingerprint(scfg, fp: Dict[str, Any]) -> None:
    """Refuse (RuntimeError naming the field) when a snapshot was taken
    under a different serve config. Runs BEFORE the device tensors are
    touched: a shape mismatch must surface as a config diagnosis, not a
    loading error."""
    want = config_fingerprint(scfg)
    for field in want:
        if fp.get(field) != want[field]:
            raise RuntimeError(
                f"snapshot config mismatch: {field} = {fp.get(field)!r} "
                f"in snapshot, {want[field]!r} in this engine")


# -- engine host state --------------------------------------------------------


def host_state_dict(eng) -> Dict[str, Any]:
    """Everything the engine keeps host-side, as one JSON-able dict (plain
    ints, floats, strings, lists and dicts only: the manifest's checksum
    hashes its canonical JSON). The device tensors travel separately
    through the checkpoint manager; this dict rides the manifest's
    ``extra`` field and is covered by the same checksum."""
    from repro_torch.serve.engine import _FORK_MIRROR
    d: Dict[str, Any] = {
        "fingerprint": config_fingerprint(eng.scfg),
        "uid": int(eng._uid),
        "tick_idx": int(eng._tick_idx),
        "cur_spec_k": int(eng._cur_spec_k),
        "fell_back": bool(eng._fell_back),
        "fit_checked": sorted(int(u) for u in eng._fit_checked),
        "queue": [request_to_dict(r) for r in eng.scheduler.pending],
        "slot_req": [request_to_dict(r) if r is not None else None
                     for r in eng.slot_req],
        "host_gen": [int(g) for g in eng._host_gen],
        "slot_pages": [[int(p) for p in pages]
                       for pages in eng._slot_pages],
        "prefilling": {
            str(slot): {"plen": int(w["plen"]), "next": int(w["next"]),
                        "blocks": [[int(t) for t in b]
                                   for b in w["blocks"]]}
            for slot, w in eng._prefilling.items()},
        "fork_wait": {str(k): int(v) for k, v in eng._fork_wait.items()},
        "fork_children": {str(k): [int(x) for x in v]
                          for k, v in eng._fork_children.items()},
        "fork_groups": {
            str(gid): {
                "req": request_to_dict(g["req"]), "k": int(g["k"]),
                "streams": {
                    str(i): (_MIRROR_TAG if s is _FORK_MIRROR
                             else [int(t) for t in s])
                    for i, s in g["streams"].items()}}
            for gid, g in eng._fork_groups.items()},
        "recovery": {
            str(uid): {
                "prompt": [int(t)
                           for t in np.asarray(rec["prompt"]).tolist()],
                "max_tokens": int(rec["max_tokens"]),
                "tokens": [int(t) for t in rec["tokens"]]}
            for uid, rec in eng._recovery.items()},
        "recovering": sorted(int(u) for u in eng._recovering),
        "defer_counts": {str(k): int(v)
                         for k, v in eng._defer_counts.items()},
        "retry_after": {str(k): int(v)
                        for k, v in eng._retry_after.items()},
        "spike_holds": [[int(exp), [int(p) for p in pages]]
                        for exp, pages in eng._spike_holds],
        "ewmas": {"wall": _ewma_to_list(eng._tick_wall_ewma),
                  "accept": _ewma_to_list(eng._accept_ewma),
                  "drift": _ewma_to_list(eng._drift_ewma)},
        "compact_pause_until": int(eng._compact_pause_until),
        "drift_rr": int(eng._drift_rr),
        "restore_boundary": int(eng._restore_boundary),
        "counters": {
            "n_quarantined": eng.n_quarantined,
            "n_shed": eng.n_shed,
            "n_finished_ok": eng.n_finished_ok,
            "spec_backoffs": eng.spec_backoffs,
            "fp_fallbacks": eng.fp_fallbacks,
            "compaction_pauses": eng.compaction_pauses,
            "audit_failures": eng.audit_failures,
            "readback_retries_total": eng.readback_retries_total},
        "audit_log": list(eng.audit_log),
        "durability": {
            "snapshots_taken": eng.snapshots_taken,
            "snapshot_bytes_total": eng.snapshot_bytes_total,
            "journal_bytes_total": eng.journal_bytes_total,
            "replayed_ticks": eng.replayed_ticks,
            "restore_flops": eng.restore_flops,
            "restore_bytes": eng.restore_bytes},
        "metrics_log": [dataclasses.asdict(m) for m in eng.metrics_log],
        "pool": eng.pool.state_dict() if eng.pool is not None else None,
        "injector": None,
        "accountant": (eng.accountant.state_dict()
                       if eng.accountant is not None else None),
    }
    if eng._injector is not None:
        d["injector"] = {
            "counts": dict(eng._injector.counts),
            "rng_state": eng._injector._rng.bit_generator.state}
    return d


def install_host_state(eng, d: Dict[str, Any]) -> None:
    """Inverse of :func:`host_state_dict`: rebuild every host mirror on a
    freshly constructed engine whose device tensors were just restored.
    Raises RuntimeError (naming the mismatch) when the snapshot was taken
    under a different serve config."""
    from repro_torch.serve.engine import _FORK_MIRROR, StepMetrics
    check_fingerprint(eng.scfg, d["fingerprint"])
    eng._uid = int(d["uid"])
    eng._tick_idx = int(d["tick_idx"])
    eng._cur_spec_k = int(d["cur_spec_k"])
    eng._fell_back = bool(d["fell_back"])
    eng._fit_checked = set(int(u) for u in d["fit_checked"])
    eng.scheduler.load([request_from_dict(r) for r in d["queue"]])
    eng.slot_req = [request_from_dict(r) if r is not None else None
                    for r in d["slot_req"]]
    eng._host_gen = [int(g) for g in d["host_gen"]]
    eng._slot_pages = [[int(p) for p in pages]
                       for pages in d["slot_pages"]]
    # _prefilling["req"] / ["pages"] alias slot_req / _slot_pages in the
    # live engine (one object, two views): relink instead of deserializing
    eng._prefilling = {}
    for slot_s, w in d["prefilling"].items():
        slot = int(slot_s)
        eng._prefilling[slot] = {
            "req": eng.slot_req[slot], "plen": int(w["plen"]),
            "next": int(w["next"]),
            "blocks": [tuple(int(t) for t in b) for b in w["blocks"]],
            "pages": eng._slot_pages[slot]}
    eng._fork_wait = {int(k): int(v) for k, v in d["fork_wait"].items()}
    eng._fork_children = {int(k): [int(x) for x in v]
                          for k, v in d["fork_children"].items()}
    # fork-group parents alias the slot or queue request of their uid
    by_uid: Dict[int, Any] = {}
    for r in list(eng.scheduler.pending) + [r for r in eng.slot_req
                                            if r is not None]:
        by_uid.setdefault(r.uid, r)
    eng._fork_groups = {}
    for gid_s, g in d["fork_groups"].items():
        req = by_uid.get(int(g["req"]["uid"]))
        if req is None:
            req = request_from_dict(g["req"])
        eng._fork_groups[int(gid_s)] = {
            "req": req, "k": int(g["k"]),
            "streams": {
                int(i): (_FORK_MIRROR if s == _MIRROR_TAG
                         else [int(t) for t in s])
                for i, s in g["streams"].items()}}
    eng._recovery = {
        int(uid): {"prompt": np.asarray(rec["prompt"], np.int32),
                   "max_tokens": int(rec["max_tokens"]),
                   "tokens": [int(t) for t in rec["tokens"]]}
        for uid, rec in d["recovery"].items()}
    eng._recovering = set(int(u) for u in d["recovering"])
    eng._defer_counts = {int(k): int(v)
                         for k, v in d["defer_counts"].items()}
    eng._retry_after = {int(k): int(v)
                        for k, v in d["retry_after"].items()}
    eng._spike_holds = [(int(exp), [int(p) for p in pages])
                        for exp, pages in d["spike_holds"]]
    alpha = eng.guard.ewma_alpha
    eng._tick_wall_ewma = _ewma_from_list(d["ewmas"]["wall"], alpha)
    eng._accept_ewma = _ewma_from_list(d["ewmas"]["accept"], alpha)
    eng._drift_ewma = _ewma_from_list(d["ewmas"]["drift"], alpha)
    eng._compact_pause_until = int(d["compact_pause_until"])
    eng._drift_rr = int(d["drift_rr"])
    eng._restore_boundary = int(d["restore_boundary"])
    c = d["counters"]
    eng.n_quarantined = int(c["n_quarantined"])
    eng.n_shed = int(c["n_shed"])
    eng.n_finished_ok = int(c["n_finished_ok"])
    eng.spec_backoffs = int(c["spec_backoffs"])
    eng.fp_fallbacks = int(c["fp_fallbacks"])
    eng.compaction_pauses = int(c["compaction_pauses"])
    eng.audit_failures = int(c["audit_failures"])
    eng.readback_retries_total = int(c["readback_retries_total"])
    eng.audit_log = list(d["audit_log"])
    dur = d["durability"]
    eng.snapshots_taken = int(dur["snapshots_taken"])
    eng.snapshot_bytes_total = float(dur["snapshot_bytes_total"])
    eng.journal_bytes_total = float(dur["journal_bytes_total"])
    eng.replayed_ticks = int(dur["replayed_ticks"])
    eng.restore_flops = float(dur["restore_flops"])
    eng.restore_bytes = float(dur["restore_bytes"])
    eng.metrics_log = [StepMetrics(**m) for m in d["metrics_log"]]
    eng.last_metrics = eng.metrics_log[-1] if eng.metrics_log else None
    if d["pool"] is not None:
        if eng.pool is None:
            raise RuntimeError("snapshot config mismatch: snapshot is "
                               "paged, this engine is dense")
        eng.pool.load_state(d["pool"])
    if d["injector"] is not None:
        if eng._injector is None:
            raise RuntimeError(
                "snapshot config mismatch: snapshot carries fault-injector "
                "state but this engine has no fault plan")
        eng._injector.counts = {k: int(v)
                                for k, v in d["injector"]["counts"].items()}
        eng._injector._rng.bit_generator.state = d["injector"]["rng_state"]
    if d["accountant"] is not None and eng.accountant is not None:
        eng.accountant.load_state(d["accountant"])
