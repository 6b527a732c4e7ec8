"""Paged KV subsystem: host-side block pool + exact-match prefix cache.

Copy of ``repro.serve.pages`` for the PyTorch port, which imports
nothing of ``repro``; the module is numpy only, and only the docstring
differs from the original.

The paper's argument is that DRAM bytes — not FLOPs — dominate edge
inference energy, and the serve benchmark confirmed it. The dense serve core
still books one ``max_len`` KV region per slot and re-prefills every prompt
from scratch, so the common serving pattern (a shared system prompt +
distinct user tails) pays its DRAM/FLOP bill once per request. This module
is the host half of the fix (DESIGN.md §14):

* **PagePool** — the allocator/refcount ledger for a device-resident block
  pool (``transformer.init_paged_caches``). Physical page ``num_pages`` is
  a reserved *sink*: device-side writes from dead/padded lanes land there,
  so freed pages can be reused without any device-side page-table scrub.
* **Prefix cache** — full prompt blocks are published under the key
  ``(parent page id, block token tuple)``. Because the parent page is
  itself content-verified by induction (block 0's parent is the root
  sentinel), a registry hit proves *exact* token equality of the entire
  prefix — there is no hash involved and therefore no collision mode that
  could serve another request's KV pages. A later admission whose prompt
  starts with the same blocks *retains* those pages instead of recomputing
  and re-storing their K/V: the page-table copy replaces the prefill.
* **Copy-on-write forks** (DESIGN.md §18) — ``fork()`` clones a slot's
  committed page run by *retaining* the shared pages instead of copying
  their bytes, so k n-best streams (or the branches of a speculation
  tree) share one physical prefix. A page is ``writable()`` only while
  its holder is the sole referent AND it is unpublished — the same
  predicate as ``movable_suffix`` — and the first write to a shared page
  goes through ``cow_write()``: allocate a private page, copy the shared
  one's bytes (billed by the engine as COW bytes), release the shared
  reference. The *last* co-owner to diverge finds itself sole referent
  again and writes in place, so a k-way fork costs at most k - 1 page
  copies, all on the partial boundary page — full committed blocks are
  never copied, which is the entire point.
* **Eviction** — pages whose refcount drops to zero but that are published
  in the prefix cache park in an LRU; ``alloc`` reclaims from it only when
  the free list runs dry, so cached prefixes survive as long as capacity
  allows.

The device half (pool tensors, page-table-indirect attention) lives in
models/transformer.py and kernels/paged_decode_attention.py; the admission
logic that ties them together in serve/engine.py.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# parent id of a prompt's first block in the prefix registry
ROOT = -1


def fragmentation(pages: Sequence[int]) -> float:
    """Scatter score of one slot's page run: 1 minus the fraction of
    adjacent table entries that are physically contiguous ascending.
    0.0 = a perfect run (every gather is one long DMA), -> 1.0 = fully
    scattered (every page is its own transfer). The engine compares this
    against ``ServeConfig.compact_threshold`` to trigger compaction."""
    if len(pages) < 2:
        return 0.0
    adj = sum(1 for a, b in zip(pages, pages[1:]) if b == a + 1)
    return 1.0 - adj / (len(pages) - 1)

BlockKey = Tuple[int, Tuple[int, ...]]          # (parent page, block tokens)


def block_tokens(tokens: Sequence[int], page_size: int
                 ) -> List[Tuple[int, ...]]:
    """Token tuples of the *full* blocks of ``tokens``. The trailing
    partial block (if any) is never returned: only full, frozen blocks are
    shareable."""
    toks = np.asarray(tokens, np.int64)
    return [tuple(int(t) for t in toks[j * page_size:(j + 1) * page_size])
            for j in range(len(toks) // page_size)]


@dataclasses.dataclass
class PoolStats:
    """Cumulative prefix-cache/allocator counters (block granularity)."""
    hit_blocks: int = 0
    missed_blocks: int = 0      # full blocks that were not cached
    evicted_blocks: int = 0
    alloc_failures: int = 0
    # contiguous-run allocation failures (compaction starvation): booked by
    # ``alloc_run`` returning None, the satellite ``alloc`` always booked
    alloc_run_failures: int = 0
    # COW channels (DESIGN.md §18): pages copied on first write to a shared
    # page, and pages whose bytes a fork *retained* instead of duplicating
    cow_copies: int = 0
    forked_pages: int = 0

    @property
    def hit_rate(self) -> float:
        """Block-level hit fraction; 0.0 (never NaN/raise) when no lookup
        has been booked — empty pools and drained engines report clean
        zeros (regression-locked in tests/test_serve_spec.py)."""
        n = self.hit_blocks + self.missed_blocks
        return self.hit_blocks / n if n > 0 else 0.0


class PagePool:
    """Host-side allocator + prefix registry for ``num_pages`` KV pages.

    Invariants:

    * every page is in exactly one of: the free list, the LRU park (cached,
      refcount 0), or live (refcount > 0);
    * a page carries at most one published key, and ``_key_to_page`` /
      ``_page_key`` mirror each other;
    * shared (published) pages are immutable — the engine only writes to
      pages it holds privately (allocated this admission or for decode).

    ``evict_policy`` selects how the park is reclaimed when the free list
    runs dry: ``"lru"`` pops the least-recently-parked page; ``"cost"``
    trims the parked prefix forest at its leaves, evicting the leaf that
    is *cheapest to recompute* first (scored by ``block_cost(depth)``,
    the engine's ``costing.block_recompute_flops`` closure over the
    block's chain depth — DESIGN.md §16). Under "cost" a long document's
    chain survives pressure that would LRU-evict its root (and thereby
    cascade-unpublish the whole chain): short/shallow chains go first,
    because regenerating a deep block means re-prefilling its entire
    prefix.
    """

    def __init__(self, num_pages: int, page_size: int, *,
                 evict_policy: str = "lru",
                 block_cost: Optional[Callable[[int], float]] = None):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        if evict_policy not in ("lru", "cost"):
            raise ValueError(f"unknown evict_policy {evict_policy!r}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.evict_policy = evict_policy
        self.block_cost = block_cost
        self.sink = num_pages          # reserved garbage row in the pool
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._ref: List[int] = [0] * num_pages
        self._key_to_page: Dict[BlockKey, int] = {}
        self._page_key: Dict[int, Optional[BlockKey]] = {}
        # parent page -> published child pages: when a page is evicted (or
        # otherwise unpublished) every key that names it as parent becomes
        # uncertifiable — the page id may be recycled with new content —
        # so children cascade-unpublish (no stale-chain false hits)
        self._children: Dict[int, set] = {}
        # page -> 0-based depth of its block in the prefix chain (set at
        # publish; the cost policy's recompute score grows with depth)
        self._page_depth: Dict[int, int] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self.stats = PoolStats()

    # -- capacity -------------------------------------------------------------

    @property
    def available(self) -> int:
        """Pages allocatable right now (free + evictable cached)."""
        return len(self._free) + len(self._lru)

    @property
    def live(self) -> int:
        return self.num_pages - self.available

    # -- allocation / refcounting ---------------------------------------------

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` private pages (refcount 1), evicting LRU-parked
        cached pages only if the free list runs dry. Returns None (and books
        an alloc failure) when capacity is insufficient — the caller defers
        the admission rather than corrupting live slots."""
        if n > self.available:
            self.stats.alloc_failures += 1
            return None
        pages: List[int] = []
        for _ in range(n):
            if self._free:
                p = self._free.pop()
            else:
                p = self._evict_one()
            self._ref[p] = 1
            pages.append(p)
        return pages

    def _evict_one(self) -> int:
        """Reclaim one parked page. ``lru``: least-recently-parked.
        ``cost``: trim the prefix forest at its LEAVES, cheapest leaf
        first. Candidates are parked pages with no published children —
        evicting an interior block would cascade-unpublish every
        descendant (their keys name its page id), destroying far more
        recompute value than the block's own score; a leaf cascades
        nothing. Among leaves the lowest ``block_cost(depth)`` goes first
        (shallow blocks of short chains are cheap to regenerate; a deep
        leaf implies its whole prefix must be re-prefilled), park order
        breaks ties, and a parked page whose key was already
        cascade-unpublished certifies nothing — it is worthless and
        always goes first."""
        if self.evict_policy == "cost" and self.block_cost is not None:
            best = best_score = None
            for p in self._lru:         # iteration order = park order
                if self._page_key.get(p) is None:
                    best = p
                    break
                if self._children.get(p):
                    continue            # interior: eviction would cascade
                score = self.block_cost(self._page_depth.get(p, 0))
                if best_score is None or score < best_score:
                    best, best_score = p, score
            if best is None:            # defensive: all parked are interior
                p, _ = self._lru.popitem(last=False)
            else:
                del self._lru[best]
                p = best
        else:
            p, _ = self._lru.popitem(last=False)
        self._unpublish(p)
        self.stats.evicted_blocks += 1
        return p

    def retain(self, page: int) -> None:
        if self._ref[page] == 0:
            if page in self._lru:
                del self._lru[page]
            else:
                # a free-listed page is allocatable: silently refcounting it
                # would let ``alloc`` hand the same physical page to another
                # slot (double-allocation — two writers, one page). COW
                # forks retain aggressively, so this is a raise, not a
                # debug assert.
                raise RuntimeError(
                    f"retain() on free-listed page {page}: only live or "
                    f"parked (published) pages may gain references")
        self._ref[page] += 1

    def release(self, page: int) -> None:
        assert self._ref[page] > 0, f"double release of page {page}"
        self._ref[page] -= 1
        if self._ref[page] == 0:
            if self._page_key.get(page) is not None:
                self._lru[page] = None          # parked, evictable
            else:
                self._free.append(page)

    def release_all(self, pages: Sequence[int]) -> None:
        for p in pages:
            self.release(p)

    # -- copy-on-write forks (DESIGN.md §18) ----------------------------------

    def writable(self, page: int) -> bool:
        """True iff the (sole) holder may write ``page`` in place: refcount
        exactly 1 and no published key — the ``movable_suffix`` predicate.
        A shared or published page is frozen; writes must go through
        ``cow_write``."""
        return self._ref[page] == 1 and self._page_key.get(page) is None

    def fork(self, pages: Sequence[int]) -> List[int]:
        """Clone a slot's committed page run for a fork: retain every page
        (the child holds one reference each, exactly like a prefix-cache
        hit) and return the same physical ids. No bytes move — divergence
        is paid lazily, page by page, via ``cow_write`` when a fork first
        writes into a shared page. Callers release the returned run
        through ``release_all`` like any owned pages."""
        for p in pages:
            self.retain(p)
        self.stats.forked_pages += len(pages)
        return list(pages)

    def cow_write(self, page: int) -> Optional[Tuple[int, bool]]:
        """Make ``page`` writable for its caller (one current referent).
        Sole-referent unpublished pages are returned as-is (in-place write,
        no copy). Otherwise allocate a private replacement, drop the
        caller's reference on the shared page, and return
        ``(new_page, True)`` — the *caller* owns the device-side byte copy
        old -> new and the COW-bytes bill. Returns None when the pool
        cannot supply the replacement page (the caller degrades
        gracefully; never corrupts the shared page)."""
        if self.writable(page):
            return page, False
        fresh = self.alloc(1)
        if fresh is None:
            return None
        self.release(page)
        self.stats.cow_copies += 1
        return fresh[0], True

    # -- compaction (DESIGN.md §16) -------------------------------------------

    def movable_suffix(self, pages: Sequence[int]) -> int:
        """Index into ``pages`` (one slot's live page run) where the
        *movable private suffix* begins. A page may be relocated only when
        this slot holds its sole reference AND it is unpublished — a
        published page's id is baked into registry keys (children name the
        parent page id) and possibly other slots' tables, so moving it
        would tear the certification chain. Everything from the returned
        index on is refcount-1 and unkeyed; shared prefix blocks are never
        moved."""
        i = len(pages)
        while i > 0 and self.writable(pages[i - 1]):
            i -= 1
        return i

    def alloc_run(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` physically *contiguous* ascending pages from the
        free list ONLY — compaction must never evict cached prefixes to
        make room (that would trade gather bytes for recompute FLOPs, the
        wrong direction). Returns None when no free run of length ``n``
        exists; picks the lowest-addressed run otherwise (keeps the free
        space itself defragmented)."""
        if n <= 0:
            return []
        free = sorted(self._free)
        run_start = 0
        for i in range(1, len(free) + 1):
            if i == len(free) or free[i] != free[i - 1] + 1:
                if i - run_start >= n:
                    run = free[run_start:run_start + n]
                    taken = set(run)
                    self._free = [p for p in self._free if p not in taken]
                    for p in run:
                        self._ref[p] = 1
                    return run
                run_start = i
        # book the starvation: without this counter a fragmented free list
        # silently stalls compaction forever (summary() shows nothing)
        self.stats.alloc_run_failures += 1
        return None

    # -- prefix cache ---------------------------------------------------------

    def _unpublish(self, page: int) -> None:
        stack = [page]
        while stack:
            p = stack.pop()
            self._page_depth.pop(p, None)
            key = self._page_key.pop(p, None)
            if key is not None:
                if self._key_to_page.get(key) == p:
                    del self._key_to_page[key]
                if key[0] != ROOT:
                    sibs = self._children.get(key[0])
                    if sibs is not None:
                        sibs.discard(p)
                        if not sibs:
                            # prune the emptied set: stale entries would
                            # grow the dict without bound over a long
                            # churny serve, and audit() walks every entry
                            del self._children[key[0]]
            # descendants' prefixes are no longer certifiable through p
            stack.extend(self._children.pop(p, ()))

    def publish(self, page: int, parent: int, block: Tuple[int, ...]) -> int:
        """Register a *full, frozen* block under ``(parent page, tokens)``.
        ``parent`` is the *canonical* page holding the previous block (ROOT
        for the first), so a registry hit certifies the whole prefix by
        induction. First writer wins: if the key is already published (an
        earlier admission computed the same prefix), the existing page
        stays canonical. Returns the canonical page for the key — callers
        publishing a chain MUST thread it as the next block's parent, or a
        duplicate chain would register keys no lookup can reach."""
        key: BlockKey = (parent, block)
        existing = self._key_to_page.get(key)
        if existing is not None:
            return existing
        self._unpublish(page)           # a page carries at most one key
        self._page_key[page] = key
        self._key_to_page[key] = page
        if parent != ROOT:
            self._children.setdefault(parent, set()).add(page)
            self._page_depth[page] = self._page_depth.get(parent, 0) + 1
        else:
            self._page_depth[page] = 0
        return page

    def lookup(self, blocks: Sequence[Tuple[int, ...]]) -> List[int]:
        """Longest cached chain for a prompt's full-block token tuples.
        Retains every returned page (caller owns one reference each) and
        books block-level hit/miss stats."""
        pages: List[int] = []
        parent = ROOT
        for block in blocks:
            p = self._key_to_page.get((parent, block))
            if p is None:
                break
            self.retain(p)
            pages.append(p)
            parent = p
        self.stats.hit_blocks += len(pages)
        self.stats.missed_blocks += len(blocks) - len(pages)
        return pages

    def unbook_lookup(self, n_hits: int, n_total: int) -> None:
        """Roll back one ``lookup``'s stats booking — used when the caller
        defers the admission (the retry will look up, and book, again).
        Without this, every deferral double-counts its blocks and inflates
        ``hit_rate``; with it, each admission books exactly once."""
        self.stats.hit_blocks -= n_hits
        self.stats.missed_blocks -= n_total - n_hits
        assert (self.stats.hit_blocks >= 0
                and self.stats.missed_blocks >= 0), \
            "unbook_lookup rolled back more than was booked"

    # -- integrity audit (DESIGN.md §17) --------------------------------------

    def audit(self) -> List[str]:
        """Walk every pool invariant and return the violations (empty =
        healthy). The chaos tier's integrity detector: the engine runs
        this every ``guard.audit_interval`` ticks and surfaces failures
        as a counter — a refcount drifting under fault churn is exactly
        the silent-corruption class this exists to catch. Checks:

        * partition — every page is in exactly one of free / parked (LRU)
          / live (refcount > 0);
        * refcounts are non-negative, free/parked pages hold refcount 0;
        * free pages carry no published key (release parks keyed pages);
        * the key registry mirrors are a bijection
          (``_key_to_page[_page_key[p]] == p`` and back);
        * every child edge matches its key's parent, and a child's chain
          depth is its parent's + 1;
        * no orphaned bookkeeping: ``_children`` holds no empty sets and
          no entries for unpublished parents, and ``_page_depth`` covers
          published pages only (stale entries would accumulate without
          bound and could mis-score cost eviction for a recycled page id).
        """
        v: List[str] = []
        free, parked = set(self._free), set(self._lru)
        if len(free) != len(self._free):
            v.append("free list holds duplicate pages")
        for p in range(self.num_pages):
            states = ((p in free) + (p in parked) + (self._ref[p] > 0))
            if states != 1:
                v.append(f"page {p} in {states} states "
                         f"(free={p in free}, parked={p in parked}, "
                         f"ref={self._ref[p]})")
            if self._ref[p] < 0:
                v.append(f"page {p} refcount {self._ref[p]} < 0")
            if p in free and self._page_key.get(p) is not None:
                v.append(f"free page {p} still published")
        for p, key in self._page_key.items():
            if key is None:
                continue
            if self._key_to_page.get(key) != p:
                v.append(f"page {p} key {key} not mirrored in registry")
            parent = key[0]
            if parent != ROOT:
                if p not in self._children.get(parent, ()):
                    v.append(f"page {p} missing from parent {parent}'s "
                             f"children")
                want = self._page_depth.get(parent, 0) + 1
                if self._page_depth.get(p) != want:
                    v.append(f"page {p} depth {self._page_depth.get(p)} "
                             f"!= parent depth + 1 ({want})")
        for key, p in self._key_to_page.items():
            if self._page_key.get(p) != key:
                v.append(f"registry key {key} -> page {p} not mirrored")
        for parent, kids in self._children.items():
            if not kids:
                v.append(f"empty _children set for page {parent} not "
                         f"pruned")
            if self._page_key.get(parent) is None:
                v.append(f"_children entry for unpublished page {parent}")
            for kid in kids:
                k = self._page_key.get(kid)
                if k is None or k[0] != parent:
                    v.append(f"child edge {parent}->{kid} has no matching "
                             f"key")
        for p in self._page_depth:
            if self._page_key.get(p) is None:
                v.append(f"_page_depth entry for unpublished page {p}")
        return v

    # -- snapshot serialization (DESIGN.md §19) -------------------------------

    def state_dict(self) -> Dict:
        """JSON-able snapshot of the whole allocator + registry. Order is
        semantic and preserved exactly: ``free`` is the LIFO free list
        (``alloc`` pops its tail), ``lru`` is park order (eviction pops its
        head) — a reordered restore would allocate different physical
        pages and break bit-identical replay."""
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "evict_policy": self.evict_policy,
            "free": list(self._free),
            "ref": list(self._ref),
            # the registry bijection, one entry per published page:
            # [page, parent, block tokens]
            "registry": [[p, key[0], list(key[1])]
                         for p, key in self._page_key.items()
                         if key is not None],
            "children": {str(parent): sorted(kids)
                         for parent, kids in self._children.items()},
            "page_depth": {str(p): d for p, d in self._page_depth.items()},
            "lru": list(self._lru),
            "stats": dataclasses.asdict(self.stats),
        }

    def load_state(self, d: Dict) -> None:
        """Restore :meth:`state_dict` in place (``block_cost`` and the
        identity knobs stay as constructed). Refuses a snapshot taken
        under different pool geometry — its page ids would be
        meaningless here."""
        for field in ("num_pages", "page_size", "evict_policy"):
            if d[field] != getattr(self, field):
                raise RuntimeError(
                    f"pool snapshot mismatch: {field} = {d[field]!r} in "
                    f"snapshot, {getattr(self, field)!r} in this pool")
        self._free = [int(p) for p in d["free"]]
        self._ref = [int(r) for r in d["ref"]]
        self._key_to_page = {}
        self._page_key = {}
        for page, parent, block in d["registry"]:
            key: BlockKey = (int(parent), tuple(int(t) for t in block))
            self._page_key[int(page)] = key
            self._key_to_page[key] = int(page)
        self._children = {int(parent): set(int(k) for k in kids)
                          for parent, kids in d["children"].items()}
        self._page_depth = {int(p): int(depth)
                            for p, depth in d["page_depth"].items()}
        self._lru = OrderedDict((int(p), None) for p in d["lru"])
        self.stats = PoolStats(**d["stats"])

    # -- introspection --------------------------------------------------------

    def refcount(self, page: int) -> int:
        return self._ref[page]

    def cached_pages(self) -> Tuple[int, ...]:
        return tuple(p for p, k in self._page_key.items() if k is not None)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"PagePool(pages={self.num_pages}, free={len(self._free)}, "
                f"parked={len(self._lru)}, live={self.live}, "
                f"hit_rate={self.stats.hit_rate:.2%})")
