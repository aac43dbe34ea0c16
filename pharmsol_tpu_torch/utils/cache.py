"""Bounded LRU caches (quick_cache equivalents, simulator/cache.rs parity).

The population paths never touch these (they recompute in one batched
march), but the single-subject API keeps the reference's
caching semantics: repeated ``estimate_predictions`` /
``estimate_log_likelihood`` calls with identical (subject, parameters) hit
the cache, cloned equations share it, and capacities are configurable.
"""

from __future__ import annotations

from collections import OrderedDict
from threading import Lock
from typing import Generic, Hashable, Optional, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")

DEFAULT_CACHE_SIZE = 100_000
DEFAULT_BOUND_ERROR_MODEL_CACHE_SIZE = 32


class LruCache(Generic[K, V]):
    def __init__(self, capacity: int = DEFAULT_CACHE_SIZE):
        self.capacity = int(capacity)
        self._map: OrderedDict = OrderedDict()
        self._lock = Lock()

    def get(self, key: K) -> Optional[V]:
        with self._lock:
            if key not in self._map:
                return None
            self._map.move_to_end(key)
            return self._map[key]

    def insert(self, key: K, value: V) -> None:
        with self._lock:
            self._map[key] = value
            self._map.move_to_end(key)
            while len(self._map) > self.capacity:
                self._map.popitem(last=False)

    def invalidate_all(self) -> None:
        with self._lock:
            self._map.clear()

    def entry_count(self) -> int:
        with self._lock:
            return len(self._map)
