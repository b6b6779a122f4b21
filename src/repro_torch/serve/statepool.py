r"""Pooled recurrent/cross state accounting for hybrid-model serving.

SSM (`h`/`conv`) and cross-attention caches are per-slot state with no
sequence axis, so they cannot ride in the KV page pools.  Instead the
runner keeps one pooled array per state-carrying layer whose leading
(post-group) axis indexes *state entries*, and the scheduler tracks which
entry each slot owns through this StatePool.  Entries are also used as
prefix-cache *checkpoints*: at a KV-page boundary during chunked prefill
the runner copies a slot's live entry into a checkpoint entry registered
under the same chained page hash the PrefixCache uses, so a warm prefix
hit can restore the recurrent state that corresponds to the matched
page-aligned prefix.

Like the rest of the scheduler layer this is device-free bookkeeping:
entry *contents* live in the runner's pooled cache arrays; this class
only decides which entry ids are live, checkpointed, or free.

Entry lifecycle::

    free --alloc()--> held --register(key)--> ckpt --evict--> free
                        \--free()--> free       \--lookup()--> ckpt (LRU bump)

Invariant: ``n_held + n_ckpt + n_free == n_entries`` at all times.
Checkpoint entries are evictable (LRU, oldest first) when ``alloc`` finds
the free list empty; held entries never are.
"""
from __future__ import annotations

from collections import OrderedDict
from collections.abc import Set
from typing import Optional

_EMPTY: frozenset = frozenset()


class StatePool:
    """Fixed pool of state entries: free list + held set + LRU checkpoints."""

    def __init__(self, n_entries: int):
        if n_entries < 1:
            raise ValueError(f"n_entries must be >= 1, got {n_entries}")
        self.n_entries = int(n_entries)
        # Pop from the tail so entries hand out in ascending order.
        self._free = list(range(self.n_entries - 1, -1, -1))
        self._held: set = set()
        self._key_of: dict = {}    # entry id -> checkpoint key
        self._entry_of: dict = {}  # checkpoint key -> entry id
        self._lru: OrderedDict = OrderedDict()  # ckpt entries, oldest first
        self.hits = 0
        self.misses = 0
        self.registered = 0
        self.evictions = 0
        self.peak_held = 0

    # -- derived counts -------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_held(self) -> int:
        return len(self._held)

    @property
    def n_ckpt(self) -> int:
        return len(self._lru)

    # -- allocation -----------------------------------------------------
    def alloc(self, evict_skip: Set = _EMPTY) -> Optional[int]:
        """Take a free entry, evicting the oldest checkpoint if needed.

        Checkpoints in ``evict_skip`` (planned restore sources for the
        current SchedulePlan) are never evicted.  Returns None only when
        the pool is exhausted: no free entry and every checkpoint pinned.
        """
        if not self._free and not self._evict_one(evict_skip):
            return None
        entry = self._free.pop()
        self._held.add(entry)
        self.peak_held = max(self.peak_held, len(self._held))
        return entry

    def free(self, entry: int) -> None:
        """Return a held entry to the free list."""
        self._held.remove(entry)
        self._free.append(entry)

    # -- checkpoints ----------------------------------------------------
    def register(self, key, entry: int) -> bool:
        """Turn a held entry into a checkpoint under ``key``.

        First writer wins: returns False (entry stays held) when the key
        is already registered — the caller should ``free`` the duplicate.
        """
        if entry not in self._held:
            raise KeyError(f"entry {entry} is not held")
        if key in self._entry_of:
            return False
        self._held.remove(entry)
        self._key_of[entry] = key
        self._entry_of[key] = entry
        self._lru[entry] = None
        self.registered += 1
        return True

    def peek(self, key) -> Optional[int]:
        """Probe for a checkpoint without touching stats or LRU order."""
        return self._entry_of.get(key)

    def lookup(self, key) -> Optional[int]:
        """Find a checkpoint by key; counts hit/miss and bumps LRU recency.

        The entry stays a checkpoint — restoring copies out of it, so one
        checkpoint can serve any number of warm admissions.
        """
        entry = self._entry_of.get(key)
        if entry is None:
            self.misses += 1
            return None
        self.hits += 1
        self._lru.move_to_end(entry)
        return entry

    def _evict_one(self, skip: Set) -> bool:
        for entry in self._lru:
            if entry in skip:
                continue
            del self._lru[entry]
            del self._entry_of[self._key_of.pop(entry)]
            self._free.append(entry)
            self.evictions += 1
            return True
        return False

    # -- maintenance ----------------------------------------------------
    def reset_stats(self) -> None:
        self.hits = self.misses = self.registered = self.evictions = 0
        self.peak_held = len(self._held)

    def check(self) -> None:
        """Assert the accounting invariant (used by tests)."""
        assert self.n_held + self.n_ckpt + self.n_free == self.n_entries, (
            self.n_held, self.n_ckpt, self.n_free, self.n_entries)
        assert self._held.isdisjoint(self._lru)
        assert self._held.isdisjoint(self._free)
        assert set(self._lru).isdisjoint(self._free)
        assert len(self._entry_of) == len(self._key_of) == len(self._lru)
