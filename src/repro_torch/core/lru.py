"""Thread-safe LRU cache with entry-count *and* byte-budget eviction.

Shared by the serving layer's result cache and ``ShardedIndex``'s per-shard
result caches.  Cached values here are EWAH bitmaps whose sizes span orders
of magnitude (a selective AND is a handful of words, a broad OR is most of
the index), so evicting by entry count alone lets a few giant results blow
the memory budget while thousands of tiny ones would have fit.  ``max_bytes``
+ ``sizeof`` bound the *total payload size*; eviction pops least-recently
used entries until both the entry cap and the byte budget hold.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional


def payload_nbytes(v) -> int:
    """Byte sizer for cached query results: EWAH bitmaps (``size_bytes``),
    count vectors (``nbytes``) or plain ints (0) — shared by the serving
    result cache and the shard-local result caches.

    ``size_bytes`` on a container-backed bitmap is its exact serialized
    container size (chunk directory + payloads), *not* the cost of the
    EWAH words it would lazily emit — so the byte budget tracks what the
    cache actually holds in memory.

    Aggregate results are *composite*: a scalar aggregate is a ``(sum,
    count, min, max)`` tuple, a grouped aggregate a dict of count/sum/
    min/max arrays (possibly card_a x card_b cells), and shard-pruned
    top-k reports nest arrays inside dicts.  Without the recursive tuple/
    dict branches below, every such entry would size as 0 and a result
    cache full of group-by matrices would evade its byte budget entirely."""
    size = getattr(v, "size_bytes", None)
    if size is None:
        if isinstance(v, (tuple, list)):
            return sum(payload_nbytes(x) for x in v)
        if isinstance(v, dict):
            return sum(payload_nbytes(x) for x in v.values())
        size = getattr(v, "nbytes", 0)
    return int(size)


def payload_kind(v) -> str:
    """Classifier for cached query results, keyed per container encoding:
    ``'ewah' | 'run' | 'array' | 'dense' | 'mixed' | 'empty' | 'full'``
    for bitmaps (``EWAH.container_summary``), ``'vector'`` for count
    vectors, ``'scalar'`` for plain aggregates."""
    summary = getattr(v, "container_summary", None)
    if summary is not None:
        return summary()
    if isinstance(v, dict):
        return "agg"  # grouped-aggregate / pruned top-k partials
    if isinstance(v, tuple):
        return "agg" if any(hasattr(x, "nbytes") for x in v) else "scalar"
    if hasattr(v, "nbytes"):
        return "vector"
    return "scalar"


class LRUCache:
    """LRU with hit/miss counters, optional entry cap, byte budget and TTL.

    ``capacity=None`` means unbounded entries; ``capacity=0`` disables the
    cache entirely (every ``put`` is a no-op).  ``max_bytes`` bounds
    ``sum(sizeof(value))`` over live entries; ``sizeof`` defaults to 0 per
    entry (byte budget inert unless a sizer is supplied).  ``ttl`` (seconds)
    makes entries expire *lazily*: a lookup past the deadline drops the
    entry and counts as both ``expired`` and a miss — no sweeper thread, so
    an idle cache costs nothing.  ``clock`` is injectable for tests
    (monotonic seconds).
    """

    _MISS = object()

    def __init__(self, capacity: Optional[int] = None,
                 max_bytes: Optional[int] = None,
                 sizeof: Optional[Callable[[object], int]] = None,
                 ttl: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 classify: Optional[Callable[[object], str]] = None):
        self.capacity = None if capacity is None else max(int(capacity), 0)
        self.max_bytes = None if max_bytes is None else max(int(max_bytes), 0)
        self._sizeof = sizeof or (lambda _v: 0)
        self.ttl = None if not ttl or ttl <= 0 else float(ttl)
        self._clock = clock
        # optional value classifier (e.g. ``payload_kind``): kinds are
        # computed once at put time; hits are counted per kind so /stats
        # can show which container encodings the cache actually serves
        self._classify = classify
        self._kinds: Dict = {}
        self.hits_by_type: Dict[str, int] = {}
        self._od: "OrderedDict" = OrderedDict()
        self._sizes: Dict = {}
        self._stamps: Dict = {}
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.expired = 0

    def _drop(self, key) -> None:
        del self._od[key]
        self._bytes -= self._sizes.pop(key)
        self._stamps.pop(key, None)
        self._kinds.pop(key, None)

    def get(self, key):
        with self._lock:
            val = self._od.get(key, self._MISS)
            if val is self._MISS:
                self.misses += 1
                return None
            if (self.ttl is not None
                    and self._clock() - self._stamps[key] > self.ttl):
                self._drop(key)
                self.expired += 1
                self.misses += 1
                return None
            self._od.move_to_end(key)
            self.hits += 1
            if self._classify is not None:
                kind = self._kinds.get(key, "?")
                self.hits_by_type[kind] = self.hits_by_type.get(kind, 0) + 1
            return val

    def put(self, key, val) -> None:
        if self.capacity == 0:
            return
        size = int(self._sizeof(val))
        with self._lock:
            if key in self._od:
                self._bytes -= self._sizes[key]
            self._od[key] = val
            self._sizes[key] = size
            self._stamps[key] = self._clock()
            if self._classify is not None:
                self._kinds[key] = self._classify(val)
            self._bytes += size
            self._od.move_to_end(key)
            while len(self._od) > 1 and (
                    (self.capacity is not None and len(self._od) > self.capacity)
                    or (self.max_bytes is not None and self._bytes > self.max_bytes)):
                k, _ = self._od.popitem(last=False)
                self._bytes -= self._sizes.pop(k)
                self._stamps.pop(k, None)
                self._kinds.pop(k, None)
                self.evictions += 1
            # a single entry larger than the whole byte budget is not worth
            # keeping either
            if (self.max_bytes is not None and self._bytes > self.max_bytes
                    and len(self._od) == 1):
                k, _ = self._od.popitem(last=False)
                self._bytes -= self._sizes.pop(k)
                self._stamps.pop(k, None)
                self._kinds.pop(k, None)
                self.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._od.clear()
            self._sizes.clear()
            self._stamps.clear()
            self._kinds.clear()
            self._bytes = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._od)

    def stats(self) -> Dict:
        with self._lock:
            out = {"entries": len(self._od), "capacity": self.capacity,
                   "bytes": self._bytes, "max_bytes": self.max_bytes,
                   "ttl": self.ttl, "hits": self.hits,
                   "misses": self.misses, "evictions": self.evictions,
                   "expired": self.expired}
            if self._classify is not None:
                out["hits_by_type"] = dict(self.hits_by_type)
            return out
