# Copied from src/repro/serving/cache.py (standard library only); keep the two in step.
"""Epoch-tagged LRU result cache for the online serving path.

Skewed road-graph traffic makes the same hot ``(s, t)`` pairs recur
constantly (the Zipf mixes in ``data/queries.py`` model this); an exact
distance is a single float, so caching it skips the device entirely for
the hot head of the distribution.

Correctness under live updates is the whole design: every entry is
tagged with the index **epoch** its value was computed on, and a lookup
pinned to epoch ``e`` only ever returns an entry tagged ``e``.  An
``apply_updates`` therefore needs no cache flush and no lock hand-off
with readers — the epoch bump itself invalidates every older entry,
which is counted (``stale``) and evicted lazily on first touch.  A
stale value can be *detected*, never *served* (the differential test in
``tests/test_serving.py`` asserts exactly this).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass

from ..obs.metrics import MetricsRegistry


@dataclass
class CacheStats:
    """Counter snapshot; ``stale`` counts lookups that found an entry
    from an older epoch (rejected + evicted, never served)."""
    hits: int = 0
    misses: int = 0
    stale: int = 0
    evictions: int = 0
    size: int = 0
    capacity: int = 0

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def as_record(self) -> dict:
        return {
            "cache_hits": self.hits,
            "cache_misses": self.misses,
            "cache_stale": self.stale,
            "cache_evictions": self.evictions,
            "cache_hit_rate": round(self.hit_rate, 4),
        }


class EpochCache:
    """Thread-safe LRU over ``(s, t)`` keyed by index epoch.

    ``get``/``put`` take the epoch explicitly (the serving runtime pins
    one per micro-batch flush from ``EpochedEngine.snapshot``), so the
    cache itself never races the epoch swap: an entry written for epoch
    e is simply unreachable from a flush pinned at e+1.
    """

    def __init__(self, capacity: int = 65536,
                 registry: MetricsRegistry | None = None):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive: {capacity}")
        self.capacity = capacity
        self._od: OrderedDict[tuple[int, int], tuple[int, float]] = \
            OrderedDict()
        self._lock = threading.Lock()
        # hit/miss/stale/evict tallies are registry counters (DESIGN.md
        # §16) so exporters see them live; mutated only under
        # self._lock, so stats() snapshots stay mutually consistent
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._hits = self.registry.counter("serve.cache.hits")
        self._misses = self.registry.counter("serve.cache.misses")
        self._stale = self.registry.counter("serve.cache.stale")
        self._evictions = self.registry.counter("serve.cache.evictions")

    def get(self, s: int, t: int, epoch: int) -> float | None:
        """Value for ``(s, t)`` computed on ``epoch``, else None.  An
        entry from any other epoch counts as stale and is evicted."""
        key = (s, t)
        with self._lock:
            ent = self._od.get(key)
            if ent is None:
                self._misses.inc()
                return None
            if ent[0] != epoch:
                self._stale.inc()
                self._misses.inc()
                del self._od[key]
                return None
            self._hits.inc()
            self._od.move_to_end(key)
            return ent[1]

    def put(self, s: int, t: int, epoch: int, dist: float) -> None:
        """Store only when the slot is empty or the incoming epoch is
        >= the stored one: a slow flush still pinned at epoch e must
        never clobber an (s, t) value already cached at e+1 — that
        would force a spurious stale-evict + device recompute on the
        next hot-pair lookup (and the fresher value is the one a
        current reader can actually use)."""
        key = (s, t)
        with self._lock:
            ent = self._od.get(key)
            if ent is not None and ent[0] > epoch:
                return
            self._od[key] = (epoch, dist)
            self._od.move_to_end(key)
            if len(self._od) > self.capacity:
                self._od.popitem(last=False)
                self._evictions.inc()

    def __len__(self) -> int:
        # snapshot under the lock: len(dict) mid-rehash from a
        # concurrent put is a torn read
        with self._lock:
            return len(self._od)

    def stats(self) -> CacheStats:
        with self._lock:
            return CacheStats(hits=int(self._hits.value),
                              misses=int(self._misses.value),
                              stale=int(self._stale.value),
                              evictions=int(self._evictions.value),
                              size=len(self._od),
                              capacity=self.capacity)
