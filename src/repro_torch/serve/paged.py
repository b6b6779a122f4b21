"""Paged KV-cache subsystem: block allocator, prefix cache, block tables.

Instead of reserving a dense ``[batch_slots, max_len]`` cache per slot,
attention caches are carved into fixed-size *pages* drawn from one shared
pool (vLLM-style PagedAttention, adapted to the HAD packed-bit K cache):

  * per layer, ``k_bits: [n_pages, Hk, W, page]`` uint32 bit-planes and
    ``v: [n_pages, Hk, page, Dh]`` (full-precision twins ``k``/``v`` with
    the same ``[n_pages, Hk, page, Dh]`` layout);
  * per slot, a block table ``block_tables[i, j]`` naming the physical
    page that holds tokens ``[j*page, (j+1)*page)`` of slot i's sequence
    (``-1`` = not allocated). The same logical table addresses every
    layer's pool, so allocation is per-token-range, not per-layer.

HBM then scales with tokens actually *resident* rather than
``batch_slots x max_len`` reserved — the regime where the paper's 16x
smaller K cache buys real concurrency.

The allocator is host-side and O(1) per operation: a free-list stack plus
per-page reference counts. Ref-counting is what makes *automatic prefix
caching* possible: a fully-written page can be mapped into several slots'
block tables at once (each holder owns one reference), and a finished
request's pages are *downgraded* to an LRU of cached-but-unreferenced
pages instead of freed, so a later request sharing the prompt prefix can
revive them without re-prefilling. Invariants (property-tested):

  * a page is on the free list iff its refcount is 0 AND it is not
    cached (registered in a prefix index);
  * a page is on the LRU iff it is cached AND its refcount is 0;
  * ``alloc`` never hands out a page twice without an interleaved final
    ``free``/``evict_lru``;
  * ``in_use + n_lru + n_free == n_pages`` at all times;
  * ``peak_in_use`` is a high-watermark over the instance's lifetime
    (reset via ``reset_watermark`` after benchmark warm-up).

Exhaustion is not an error here — ``alloc`` returns ``None`` and the
*engine* decides. Reclaim order is LRU-cached pages first (they hold no
live request's tokens), preemption of a resident only after the LRU is
dry.

``PrefixCache`` is the content-addressed index over the allocator's
cached pages. Keys are *chained* hashes — a page's key commits to every
token from sequence position 0 through its own last token — so equal keys
mean equal page content AND equal absolute positions (RoPE rides along
for free), and lookup of a prompt is longest-prefix matching over its
page-aligned chunk keys. Only FULL pages are ever registered: the
partially-filled tail page of a request is always private, which is what
makes sharing copy-on-write without any device copies (divergence can
only start in the tail page, and the tail page is never shared).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib


@dataclasses.dataclass(frozen=True)
class PoolStats:
    n_pages: int
    page_size: int
    in_use: int
    n_free: int
    n_lru: int
    peak_in_use: int
    alloc_count: int
    free_count: int


class BlockAllocator:
    """Free-list allocator over ``n_pages`` fixed-size cache pages."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        # stack: pop() returns low page ids first (deterministic layouts
        # in tests; irrelevant to correctness)
        self._free = list(range(n_pages - 1, -1, -1))
        self._ref = [0] * n_pages
        self._cached: set[int] = set()     # registered in a prefix index
        # cached pages at refcount 0, least recently used first
        self._lru: collections.OrderedDict[int, None] = collections.OrderedDict()
        self.peak_in_use = 0
        self.alloc_count = 0
        self.free_count = 0

    # ------------------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_lru(self) -> int:
        return len(self._lru)

    @property
    def in_use(self) -> int:
        """Pages holding at least one live reference."""
        return self.n_pages - len(self._free) - len(self._lru)

    def stats(self) -> PoolStats:
        return PoolStats(self.n_pages, self.page_size, self.in_use,
                         self.n_free, self.n_lru, self.peak_in_use,
                         self.alloc_count, self.free_count)

    def reset_watermark(self) -> None:
        self.peak_in_use = self.in_use

    # ------------------------------------------------------------------
    def alloc(self) -> int | None:
        """Take one page (refcount 1), or None when the free list is empty.
        LRU-cached pages are NOT taken implicitly — reclaiming one
        invalidates a prefix-index entry, so that step is explicit
        (``PrefixCache.evict_one``) and the engine orders it before
        preemption."""
        if not self._free:
            return None
        page = self._free.pop()
        self._ref[page] = 1
        self.alloc_count += 1
        if self.in_use > self.peak_in_use:
            self.peak_in_use = self.in_use
        return page

    def incref(self, page: int) -> None:
        """Add a reference to an allocated page (prefix sharing)."""
        if not 0 <= page < self.n_pages or self._ref[page] <= 0:
            raise ValueError(f"incref of unallocated page {page}")
        self._ref[page] += 1

    def free(self, page: int) -> None:
        """Drop one reference. At zero the page returns to the free list —
        unless it is cached, in which case it is *downgraded* to the LRU
        (content kept, revivable by `reuse`, reclaimable by `evict_lru`)."""
        if not 0 <= page < self.n_pages or self._ref[page] <= 0:
            raise ValueError(f"free of unallocated page {page}")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            if page in self._cached:
                self._lru[page] = None      # most recently used at the end
            else:
                self._free.append(page)
                self.free_count += 1

    def refcount(self, page: int) -> int:
        return self._ref[page]

    # ------------------------------------------------------------------
    # cached-page (prefix-sharing) transitions
    # ------------------------------------------------------------------
    def mark_cached(self, page: int) -> None:
        """Flag a *referenced* page as registered in a prefix index: its
        final `free` will park it on the LRU instead of the free list."""
        if not 0 <= page < self.n_pages or self._ref[page] <= 0:
            raise ValueError(f"mark_cached of unallocated page {page}")
        self._cached.add(page)

    def is_cached(self, page: int) -> bool:
        return page in self._cached

    def in_lru(self, page: int) -> bool:
        return page in self._lru

    def reuse(self, page: int) -> None:
        """Prefix hit: take a reference on a cached page, reviving it from
        the LRU if no live request currently holds it."""
        if page not in self._cached:
            raise ValueError(f"reuse of uncached page {page}")
        if self._ref[page] == 0:
            del self._lru[page]
            self._ref[page] = 1
            if self.in_use > self.peak_in_use:
                self.peak_in_use = self.in_use
        else:
            self._ref[page] += 1

    def evict_lru(self) -> int | None:
        """Reclaim the least-recently-used cached page (refcount 0) back to
        the free list, or None if the LRU is empty. The caller (the prefix
        index) must drop its key for the page — the content is dead."""
        if not self._lru:
            return None
        page, _ = self._lru.popitem(last=False)
        self._cached.discard(page)
        self._free.append(page)
        self.free_count += 1
        return page

    def check(self) -> None:
        """Raise AssertionError unless every accounting invariant holds:
        ``in_use + lru + free == n_pages``, the free list is duplicate-free
        and disjoint from the LRU, and each page's list membership matches
        its refcount/cached state exactly."""
        free, lru = set(self._free), set(self._lru)
        assert len(free) == len(self._free), (
            f"duplicate pages on the free list: {sorted(self._free)}")
        assert not (free & lru), f"pages on free AND lru: {sorted(free & lru)}"
        assert self.in_use + self.n_lru + self.n_free == self.n_pages, (
            f"in_use {self.in_use} + lru {self.n_lru} + free {self.n_free} "
            f"!= n_pages {self.n_pages}")
        for page in range(self.n_pages):
            ref, cached = self._ref[page], page in self._cached
            assert ref >= 0, f"page {page} refcount {ref} < 0"
            assert (page in free) == (ref == 0 and not cached), (
                f"page {page}: free-list membership inconsistent "
                f"(ref={ref}, cached={cached})")
            assert (page in lru) == (ref == 0 and cached), (
                f"page {page}: LRU membership inconsistent "
                f"(ref={ref}, cached={cached})")


# ---------------------------------------------------------------------------
# content-addressed prefix index
# ---------------------------------------------------------------------------

def chain_hash(prev: bytes, token_bytes: bytes) -> bytes:
    """Key of a page holding `token_bytes`, chained onto its prefix's key
    (`b""` for the first page). Chaining makes a key commit to the WHOLE
    sequence up to the page's last token, so two pages share a key only if
    their full prefixes — content and absolute positions — are identical."""
    h = hashlib.sha256(prev)
    h.update(token_bytes)
    return h.digest()


class PrefixCache:
    """Chained-hash index over fully-written, immutable KV pages.

    The cache holds NO allocator references of its own: a registered page
    lives on the engine's references while any sharer is resident, and on
    the allocator's LRU (via `mark_cached`) once the last sharer finishes.
    `match` turns a list of chained page keys into incref'd physical pages
    for the longest indexed prefix; `evict_one` reclaims the coldest LRU
    page and forgets its key (the engine calls it on pool exhaustion,
    BEFORE resorting to preempting a resident).
    """

    def __init__(self, allocator: BlockAllocator):
        self.allocator = allocator
        self._page_of: dict[bytes, int] = {}
        self._key_of: dict[int, bytes] = {}
        self.hits = 0          # pages served from the index
        self.misses = 0        # lookups that broke the chain
        self.registered = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._page_of)

    def reset_stats(self) -> None:
        self.hits = self.misses = self.registered = self.evictions = 0

    # ------------------------------------------------------------------
    def lookup(self, key: bytes) -> int | None:
        """One indexed page by key, incref'd on hit (the caller maps it
        into a block table and later `free`s it like any other page)."""
        page = self._page_of.get(key)
        if page is None:
            self.misses += 1
            return None
        self.allocator.reuse(page)
        self.hits += 1
        return page

    def match(self, keys) -> list[int]:
        """Longest indexed prefix of `keys` (any iterable — a lazy
        generator is never consumed past the first miss) as incref'd
        physical pages."""
        pages: list[int] = []
        for key in keys:
            page = self.lookup(key)
            if page is None:
                break
            pages.append(page)
        return pages

    def register(self, key: bytes, page: int) -> bool:
        """Publish a fully-written page under its chained key. First writer
        wins: if the key is already indexed (a concurrent request wrote
        identical content), the caller's page simply stays private —
        sharing converges on the canonical page as new requests match."""
        if key in self._page_of:
            return False
        self._page_of[key] = page
        self._key_of[page] = key
        self.allocator.mark_cached(page)
        self.registered += 1
        return True

    def evict_one(self) -> bool:
        """Reclaim the least-recently-used unreferenced cached page back to
        the allocator's free list, dropping its index entry. False iff the
        LRU is empty (every cached page is still held by a resident)."""
        page = self.allocator.evict_lru()
        if page is None:
            return False
        key = self._key_of.pop(page)
        del self._page_of[key]
        self.evictions += 1
        return True


# ---------------------------------------------------------------------------
# host-side swap pool (page-aligned swap-out preemption)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SwapStats:
    capacity: int
    page_size: int
    in_use: int
    peak_in_use: int
    reserve_count: int
    release_count: int


class SwapPool:
    """Bounded accounting for pages swapped out to host memory.

    Swap-out preemption gathers a victim's *device* pages into host RAM at
    page granularity and frees them, so re-admission restores the exact KV
    content instead of re-prefilling (recompute preemption throws away
    every computed token of the victim). This class is the *capacity
    ledger* only — the scheduler reserves/releases space per request at
    plan time, while the runner stores the actual gathered arrays keyed by
    the same request id. Keeping data out of here is what keeps the
    scheduler device-free and the plan the only policy→execution channel.

    Accounting invariants (property-tested alongside the allocator):

      * ``in_use == sum(pages held per swapped request)``;
      * ``0 <= in_use <= capacity`` — ``reserve`` past capacity raises,
        so the engine checks ``can_reserve`` first and falls back to
        recompute preemption when the pool is full;
      * a request id holds at most one reservation at a time;
      * combined with the device pool: a live request's pages are either
        device-resident (counted in ``BlockAllocator.in_use``) or in this
        pool — never both, and swapped pages never alias the prefix
        cache's index (restored pages are private copies).
    """

    def __init__(self, capacity: int, page_size: int):
        if capacity < 1:
            raise ValueError(f"swap capacity must be >= 1, got {capacity}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.capacity = capacity
        self.page_size = page_size
        self._held: dict[int, int] = {}       # request_id -> pages held
        self.peak_in_use = 0
        self.reserve_count = 0
        self.release_count = 0

    @property
    def in_use(self) -> int:
        return sum(self._held.values())

    @property
    def n_free(self) -> int:
        return self.capacity - self.in_use

    def __len__(self) -> int:
        return len(self._held)

    def holds(self, request_id: int) -> bool:
        return request_id in self._held

    def held_pages(self, request_id: int) -> int:
        return self._held.get(request_id, 0)

    def can_reserve(self, n_pages: int) -> bool:
        return 1 <= n_pages <= self.n_free

    def reserve(self, request_id: int, n_pages: int) -> None:
        """Claim swap space for a victim's pages (scheduler, plan time)."""
        if request_id in self._held:
            raise ValueError(f"request {request_id} already swapped")
        if not 1 <= n_pages <= self.n_free:
            raise ValueError(
                f"cannot reserve {n_pages} swap pages "
                f"({self.n_free} of {self.capacity} free)")
        self._held[request_id] = n_pages
        self.reserve_count += 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)

    def release(self, request_id: int) -> int:
        """Free a swapped request's reservation (swap-in admission or a
        lockstep reset); returns the page count released."""
        if request_id not in self._held:
            raise ValueError(f"request {request_id} holds no swap pages")
        self.release_count += 1
        return self._held.pop(request_id)

    def clear(self) -> None:
        self._held.clear()

    def stats(self) -> SwapStats:
        return SwapStats(self.capacity, self.page_size, self.in_use,
                         self.peak_in_use, self.reserve_count,
                         self.release_count)

    def reset_watermark(self) -> None:
        self.peak_in_use = self.in_use

    def check(self) -> None:
        """Raise AssertionError unless the capacity ledger is coherent:
        every reservation holds >= 1 page and the total fits capacity."""
        for rid, n in self._held.items():
            assert n >= 1, f"request {rid} holds {n} swap pages"
        assert 0 <= self.in_use <= self.capacity, (
            f"swap in_use {self.in_use} outside [0, {self.capacity}]")


def pages_needed(n_tokens: int, page_size: int) -> int:
    """Pages required to hold ``n_tokens`` (ceil division)."""
    return -(-n_tokens // page_size)
