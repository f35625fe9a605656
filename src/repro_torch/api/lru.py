"""Bounded LRU mapping with hit/miss/eviction accounting.

The plan caches (``Session._plans``, ``Plan._recompiled``, and the
serving layer's cross-session :class:`~repro_torch.serve.cache.SharedPlanCache`)
all grew without bound before the serving subsystem landed — a leak once
a server replays thousands of request shapes through one session.  This
is the one bounded mapping they share: insertion-ordered, recency-updated
on :meth:`get`, evicting the least-recently-used entry past ``cap``, with
counters the observability layer surfaces through ``Session.metrics()``.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

__all__ = ["LRUCache"]


class LRUCache:
    """A dict bounded to ``cap`` entries with LRU eviction + counters.

    ``cap <= 0`` means unbounded (counters still accumulate).  Eviction
    calls ``on_evict(key, value)`` when provided — the serving cache uses
    it to drop replica lists coherently.
    """

    def __init__(self, cap: int = 0,
                 on_evict: Optional[Callable] = None):
        self.cap = int(cap)
        self.on_evict = on_evict
        self._d: dict = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- mapping surface -----------------------------------------------------
    def get(self, key, default=None):
        """Recency-updating lookup; counts a hit or a miss."""
        try:
            v = self._d.pop(key)
        except KeyError:
            self.misses += 1
            return default
        self._d[key] = v        # re-insert at most-recent position
        self.hits += 1
        return v

    def peek(self, key, default=None):
        """Lookup without touching recency or the hit/miss counters."""
        return self._d.get(key, default)

    def put(self, key, value) -> None:
        """Insert/overwrite at most-recent position; evict past cap."""
        self._d.pop(key, None)
        self._d[key] = value
        while self.cap > 0 and len(self._d) > self.cap:
            old_key = next(iter(self._d))
            old_val = self._d.pop(old_key)
            self.evictions += 1
            if self.on_evict is not None:
                self.on_evict(old_key, old_val)

    def pop(self, key, default=None):
        return self._d.pop(key, default)

    def setdefault(self, key, value):
        """Insert only if absent; returns the stored value (no counting).

        An existing key is refreshed to the most-recent position: the
        caller just used it, and leaving it at its original slot would
        let a hot entry (e.g. a Plan's recompiled successor re-fetched
        every run) be evicted at cap despite being the most-used one.
        """
        if key in self._d:
            v = self._d.pop(key)
            self._d[key] = v        # recency refresh, no hit/miss counting
            return v
        self.put(key, value)
        return value

    def __contains__(self, key) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)

    def __iter__(self):
        return iter(self._d)

    def keys(self):
        return self._d.keys()

    def values(self):
        return self._d.values()

    def items(self):
        return self._d.items()

    # -- reporting -----------------------------------------------------------
    def counters(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "size": len(self._d),
                "cap": self.cap}

    def __repr__(self) -> str:
        return (f"LRUCache(cap={self.cap}, size={len(self._d)}, "
                f"hits={self.hits}, misses={self.misses}, "
                f"evictions={self.evictions})")
