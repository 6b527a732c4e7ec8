"""Serve-engine snapshot support of the PyTorch port (mirror of
``repro.serve.snapshot``). It holds the ownership reconciliation that the
chaos tier's pool auditor runs; the snapshot, journal and restore of the
durability tier are not ported yet."""

from __future__ import annotations

from typing import Dict, List, Tuple


def reconcile_ownership(pool, slot_pages: List[List[int]],
                        spike_holds: List[Tuple[int, List[int]]]
                        ) -> List[str]:
    """Reconcile the engine's page-ownership mirrors against the pool's
    refcounts: every page the engine holds (slot page lists plus the
    injector's spike holds) must carry at least that many pool references,
    and no slot may list a page twice. Returns violation strings (empty =
    consistent)."""
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
