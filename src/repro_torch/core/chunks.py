"""Chunks: the data half of the Chunks and Tasks programming model (paper §2).

This is a faithful single-process simulation of the CHT-MPI semantics the
paper relies on:

* A *chunk* is an immutable piece of data.  ``register_chunk`` transfers
  ownership to the runtime and returns a :class:`ChunkId`; after registration
  the object is read-only (we enforce this by hashing at registration and
  verifying on every fetch in debug mode).
* The **owner worker rank is embedded in the chunk id** (paper §2.1) so any
  worker can locate data without a central directory.
* Each worker has a bounded LRU **chunk cache**; fetching a remote chunk is
  accounted as communication (bytes received) only on cache miss — this is the
  quantity plotted in Figs 11-13.
* ``NIL`` chunk ids represent zero submatrices and may appear at any level.

The store also records per-worker peak owned bytes (Fig 11 left).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Optional

NIL: Optional["ChunkId"] = None  # NIL chunk identifier == None, as in the paper


@dataclasses.dataclass(frozen=True)
class ChunkId:
    """Identifier chosen by the runtime; owner rank embedded (paper §2)."""
    owner: int
    local: int

    def __repr__(self) -> str:  # compact for logs
        return f"c{self.owner}.{self.local}"


class Chunk:
    """Base class for user chunk types; subclasses define nbytes()."""

    def nbytes(self) -> int:
        raise NotImplementedError


@dataclasses.dataclass
class WorkerStats:
    bytes_received: int = 0           # data fetched from other workers
    bytes_received_local: int = 0     # same-worker fetches (no comm)
    bytes_pushed: int = 0             # subset of bytes_received: placement pushes
    messages_received: int = 0        # number of remote fetches (latency proxy)
    cache_hits: int = 0
    owned_bytes: int = 0
    peak_owned_bytes: int = 0
    tasks_executed: int = 0
    busy_time: float = 0.0
    dedup_hits: int = 0               # registrations resolved by content hash
    flops_executed: float = 0.0       # useful flops of tasks run on this worker


def content_fingerprint(obj: Any) -> Any:
    """Content hash of a chunk, or None when the type opts out of dedup.

    Duck-typed on a ``content_fingerprint()`` method so only chunk types
    that can vouch for byte-identity (leaf matrix chunks) participate.
    """
    fp = getattr(obj, "content_fingerprint", None)
    return fp() if fp is not None else None


def content_norm2(obj: Any) -> Optional[float]:
    """Squared Frobenius norm of a chunk's payload, or None.

    Duck-typed on a ``content_norm2()`` method so only chunk types whose
    norm is meaningful from the bytes alone (leaf matrix chunks)
    participate — internal quadtree chunks hold graph-local child ids and
    opt out, exactly as they do for dedup fingerprints.
    """
    fn = getattr(obj, "content_norm2", None)
    return fn() if fn is not None else None


class ChunkStore:
    """All workers' chunks + caches + communication accounting.

    ``dedup=True`` enables content-hash deduplication: registering data
    byte-identical to an existing live chunk (e.g. the same dense input
    built as two quadtrees) returns the *existing* :class:`ChunkId`
    instead of storing a second copy, shrinking owned-bytes accounting.
    Deduplicated ids are reference counted so :meth:`free` only deletes
    the data when the last registration is freed.  Note that with dedup a
    chunk id may point at a different worker than the one that registered
    it, so the parent-worker placement invariant (owner == creator) holds
    only up to content identity.
    """

    def __init__(self, n_workers: int, cache_bytes: int = 1 << 62,
                 dedup: bool = False):
        self.n_workers = n_workers
        self.cache_bytes = cache_bytes
        self.dedup = dedup
        self._data: list[dict[int, Any]] = [dict() for _ in range(n_workers)]
        self._sizes: list[dict[int, int]] = [dict() for _ in range(n_workers)]
        self._next: list[int] = [0] * n_workers
        # per-worker LRU cache: (owner, local) -> size
        self._cache: list[OrderedDict[tuple[int, int], int]] = [
            OrderedDict() for _ in range(n_workers)]
        self._cache_used: list[int] = [0] * n_workers
        self.stats = [WorkerStats() for _ in range(n_workers)]
        # dedup bookkeeping: fingerprint <-> (owner, local), refcounts
        self._by_fp: dict[Any, tuple[int, int]] = {}
        self._fp_of: dict[tuple[int, int], Any] = {}
        self._refs: dict[tuple[int, int], int] = {}
        # chunk-norm cache (truncated multiply, DESIGN.md §5): computed on
        # first norm2_of and dropped by free() so a dedup-released slot
        # can never serve a stale norm to a later registration
        self._norm2: dict[tuple[int, int], float] = {}

    # -- registration -----------------------------------------------------
    def _dedup_lookup(self, worker: int, obj: Any
                      ) -> tuple[Optional[ChunkId], Any]:
        """(existing id, fingerprint) for ``obj`` under dedup; (None, fp)
        on miss; (None, None) when dedup is off or the type opts out."""
        if not self.dedup:
            return None, None
        fp = content_fingerprint(obj)
        if fp is None:
            return None, None
        key = self._by_fp.get(fp)
        if key is None:
            return None, fp
        self._refs[key] += 1
        self.stats[worker].dedup_hits += 1
        return ChunkId(*key), fp

    _FP_UNSET = object()    # sentinel: fingerprint not yet computed

    def register(self, worker: int, obj: Any, nbytes: int | None = None,
                 _fp: Any = _FP_UNSET) -> ChunkId:
        """Register ``obj`` on ``worker``; returns runtime-chosen id.

        No communication: a chunk is owned by the worker that created it.
        With ``dedup`` enabled, byte-identical data returns the existing id.
        ``_fp`` carries a fingerprint already computed (and missed) by
        :meth:`register_pushed` so the block bytes are hashed only once.
        """
        if _fp is ChunkStore._FP_UNSET:
            hit, fp = self._dedup_lookup(worker, obj)
            if hit is not None:
                return hit
        else:
            fp = _fp
        if nbytes is None:
            nbytes = obj.nbytes() if isinstance(obj, Chunk) else _default_nbytes(obj)
        local = self._next[worker]
        self._next[worker] += 1
        self._data[worker][local] = obj
        self._sizes[worker][local] = nbytes
        st = self.stats[worker]
        st.owned_bytes += nbytes
        st.peak_owned_bytes = max(st.peak_owned_bytes, st.owned_bytes)
        if fp is not None:
            key = (worker, local)
            self._by_fp[fp] = key
            self._fp_of[key] = fp
            self._refs[key] = 1
        return ChunkId(worker, local)

    def register_pushed(self, creator: int, owner: int, obj: Any,
                        nbytes: int | None = None) -> ChunkId:
        """Register a chunk created by ``creator`` but placed on ``owner``.

        Models a locality-oblivious placement policy: when the runtime
        assigns ownership away from the creating worker, the data must be
        *sent* there — the owner receives ``nbytes`` over the network.  The
        creator keeps a cached copy (it just produced the data), so its own
        subsequent fetches hit the cache.

        With ``dedup`` enabled, byte-identical data short-circuits to the
        existing id: nothing is shipped (no push accounting) and the
        creator — which just produced the same bytes — gets a cache entry.
        """
        hit, fp = self._dedup_lookup(creator, obj)
        if hit is not None:
            if hit.owner != creator:
                self._cache_insert(creator, (hit.owner, hit.local),
                                   self._sizes[hit.owner][hit.local])
            return hit
        if nbytes is None:
            nbytes = obj.nbytes() if isinstance(obj, Chunk) else _default_nbytes(obj)
        cid = self.register(owner, obj, nbytes, _fp=fp)
        if owner != creator:
            st = self.stats[owner]
            st.bytes_received += nbytes
            st.bytes_pushed += nbytes
            st.messages_received += 1
            self._cache_insert(creator, (owner, cid.local), nbytes)
        return cid

    # -- fetch --------------------------------------------------------------
    def fetch(self, worker: int, cid: Optional[ChunkId]) -> Any:
        """Fetch chunk for use by ``worker``; accounts communication.

        Fetching NIL returns None (the runtime would invoke the fallback
        execute, Alg 1/2 line 2).
        """
        if cid is None:
            return None
        obj = self._data[cid.owner][cid.local]
        size = self._sizes[cid.owner][cid.local]
        st = self.stats[worker]
        if cid.owner == worker:
            st.bytes_received_local += size
            return obj
        key = (cid.owner, cid.local)
        cache = self._cache[worker]
        if key in cache:
            cache.move_to_end(key)
            st.cache_hits += 1
            return obj
        # remote fetch: communication happens
        st.bytes_received += size
        st.messages_received += 1
        self._cache_insert(worker, key, size)
        return obj

    def _cache_insert(self, worker: int, key: tuple[int, int], size: int
                      ) -> None:
        cache = self._cache[worker]
        if key in cache:                # re-insert: replace, don't double-count
            self._cache_used[worker] -= cache[key]
        cache[key] = size
        cache.move_to_end(key)
        self._cache_used[worker] += size
        while self._cache_used[worker] > self.cache_bytes and cache:
            _, evicted = cache.popitem(last=False)
            self._cache_used[worker] -= evicted

    def cache_used(self, worker: int) -> int:
        """Bytes currently held in ``worker``'s chunk cache."""
        return self._cache_used[worker]

    def size_of(self, cid: Optional[ChunkId]) -> int:
        if cid is None:
            return 0
        return self._sizes[cid.owner][cid.local]

    def norm2_of(self, cid: Optional[ChunkId]) -> Optional[float]:
        """Cached squared Frobenius norm of a chunk's payload.

        Returns 0.0 for NIL and None for chunk types that opt out (see
        :func:`content_norm2`).  The cache entry lives exactly as long as
        the chunk: :meth:`free` drops it, so dedup'd reuse of a released
        fingerprint can never read a stale norm.
        """
        if cid is None:
            return 0.0
        key = (cid.owner, cid.local)
        v = self._norm2.get(key)
        if v is None:
            v = content_norm2(self._data[cid.owner][cid.local])
            if v is not None:
                self._norm2[key] = v
        return v

    def invalidate_norm2(self, cid: Optional[ChunkId]) -> None:
        """Drop the cached norm of a chunk whose payload was rebound.

        Plan replay (api/plan.py) refreshes input chunk *values* in place
        — same structure, same bytes count, new numbers — so any norm
        this store cached against the old bytes is stale.
        """
        if cid is None:
            return
        self._norm2.pop((cid.owner, cid.local), None)

    def invalidate_content(self, cid: Optional[ChunkId]) -> None:
        """Drop every cache keyed to a rebound chunk's *old bytes*.

        Beyond the norm cache this retires the chunk's dedup fingerprint:
        a later registration of data byte-identical to the original
        values must not resolve to a chunk that now holds different
        numbers.  The refcount bookkeeping stays intact (``free`` still
        works); only future fingerprint lookups are prevented — the
        rebound bytes are conservatively left unindexed.
        """
        if cid is None:
            return
        key = (cid.owner, cid.local)
        self._norm2.pop(key, None)
        fp = self._fp_of.get(key)
        if fp is not None and self._by_fp.get(fp) == key:
            del self._by_fp[fp]

    def free(self, cid: Optional[ChunkId]) -> None:
        """Model chunk deletion (temporaries freed by the library user).

        Cached copies on other workers are invalidated too: a freed id's
        ``(owner, local)`` slot may be reused by a later registration, and a
        stale cache entry would both pin ``_cache_used`` forever and serve
        the *old* bytes for the new id.
        """
        if cid is None:
            return
        key = (cid.owner, cid.local)
        if key in self._refs:           # dedup'd id: last free wins
            self._refs[key] -= 1
            if self._refs[key] > 0:
                return
            del self._refs[key]
            fp = self._fp_of.pop(key)
            if self._by_fp.get(fp) == key:
                del self._by_fp[fp]
        size = self._sizes[cid.owner].pop(cid.local)
        del self._data[cid.owner][cid.local]
        self._norm2.pop(key, None)
        self.stats[cid.owner].owned_bytes -= size
        for w in range(self.n_workers):
            if key in self._cache[w]:
                del self._cache[w][key]
                self._cache_used[w] -= size

    # -- fault tolerance (runtime/recovery.py; DESIGN.md §10) ---------------
    def drop_worker(self, worker: int) -> tuple[int, int]:
        """Model worker death: its owned chunks and cache vanish.

        Every other worker's cached copies of the dead worker's chunks
        are dropped too — the ``(owner, local)`` slots may be reused by a
        later registration once recovery re-places the data.  Per-worker
        statistics are kept (the report still shows what the worker did
        before dying).  Returns ``(n_chunks, n_bytes)`` lost.
        """
        lost_keys = [(worker, local) for local in self._data[worker]]
        n_chunks = len(lost_keys)
        n_bytes = sum(self._sizes[worker].values())
        self._data[worker].clear()
        self._sizes[worker].clear()
        self.stats[worker].owned_bytes = 0
        self._cache[worker].clear()
        self._cache_used[worker] = 0
        for key in lost_keys:
            self._norm2.pop(key, None)
            self._refs.pop(key, None)
            fp = self._fp_of.pop(key, None)
            if fp is not None and self._by_fp.get(fp) == key:
                del self._by_fp[fp]
        for w in range(self.n_workers):
            if w == worker:
                continue
            cache = self._cache[w]
            for key in [k for k in cache if k[0] == worker]:
                self._cache_used[w] -= cache.pop(key)
        return n_chunks, n_bytes

    def add_worker(self) -> int:
        """Grow the store by one worker (elastic join); returns its rank."""
        w = self.n_workers
        self.n_workers += 1
        self._data.append({})
        self._sizes.append({})
        self._next.append(0)
        self._cache.append(OrderedDict())
        self._cache_used.append(0)
        self.stats.append(WorkerStats())
        return w

    def replicate(self, cid: ChunkId, dst: int) -> ChunkId:
        """Copy a live chunk onto ``dst`` (r-way replication, DESIGN.md §10).

        Bypasses dedup on purpose: the point is a second *physical* copy
        that survives the primary owner's death, so the replica must not
        resolve to the primary's fingerprint.  The transfer is accounted
        on ``dst`` exactly like a placement push.
        """
        obj = self._data[cid.owner][cid.local]
        nbytes = self._sizes[cid.owner][cid.local]
        local = self._next[dst]
        self._next[dst] += 1
        self._data[dst][local] = obj
        self._sizes[dst][local] = nbytes
        st = self.stats[dst]
        st.owned_bytes += nbytes
        st.peak_owned_bytes = max(st.peak_owned_bytes, st.owned_bytes)
        if dst != cid.owner:
            st.bytes_received += nbytes
            st.bytes_pushed += nbytes
            st.messages_received += 1
        return ChunkId(dst, local)

    # -- aggregate stats ----------------------------------------------------
    def total_bytes_received(self) -> int:
        return sum(s.bytes_received for s in self.stats)

    def per_worker_bytes_received(self) -> list[int]:
        return [s.bytes_received for s in self.stats]

    def per_worker_peak_owned(self) -> list[int]:
        return [s.peak_owned_bytes for s in self.stats]


def _default_nbytes(obj: Any) -> int:
    if hasattr(obj, "nbytes"):
        nb = obj.nbytes
        return int(nb() if callable(nb) else nb)
    return 64  # small header-only objects (parameter chunks etc.)
