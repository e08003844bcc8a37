"""mpool — the receive bounce pool and the registration cache.

The port's reduction of ``ompi_tpu.core.mpool`` (reference:
opal/mca/allocator/bucket, size-class free lists feeding the transports'
fragment pools, and opal/mca/rcache, the grdma registration cache) to
the :class:`BufferPool` ob1 draws object-message scratch from
(ob1.py:143, :699) and the :class:`Rcache` that holds the datatype
engine's tiled span tables and device index vectors, keyed by
:func:`buffer_key`. A key is invalidated through the memory-release
plane (:mod:`ompi_tpu_torch.core.memhooks`): every cache subscribes at
construction, and a keyed object's death drops its key from every cache
(reference ``core/mpool.py:114-126``, ``:182-193``).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Tuple

from ompi_tpu_torch.core import cvar, memhooks, pvar

_max_cached = cvar.register(
    "mpool_max_cached_bytes", 32 << 20, int,
    help="Upper bound on idle bytes retained per BufferPool size "
         "class set (reference: allocator/bucket caps its buckets); "
         "0 disables pooling entirely.", level=7)

_rcache_bytes = cvar.register(
    "rcache_max_bytes", 256 << 20, int,
    help="Registration-cache capacity in payload bytes before LRU "
         "eviction (reference: rcache_grdma size limits).", level=7)


def _size_class(n: int) -> int:
    """Round up to the allocation bucket: powers of two from 256 B."""
    c = 256
    while c < n:
        c <<= 1
    return c


class BufferPool:
    """Size-class byte-buffer pool: ``take(n)`` returns a ``bytearray``
    of capacity >= n; ``give(buf)`` recycles it. Idle bytes are capped
    by ``mpool_max_cached_bytes``; beyond it buffers fall to the garbage
    collector."""

    def __init__(self) -> None:
        self._classes: Dict[int, List[bytearray]] = {}
        self._idle = 0
        self._lock = threading.Lock()

    def take(self, nbytes: int) -> bytearray:
        if _max_cached.get() <= 0:
            pvar.record("mpool_misses")
            return bytearray(nbytes)
        c = _size_class(nbytes)
        with self._lock:
            free = self._classes.get(c)
            if free:
                buf = free.pop()
                self._idle -= c
                pvar.record("mpool_hits")
                return buf
        pvar.record("mpool_misses")
        return bytearray(c)

    def give(self, buf: bytearray) -> None:
        c = len(buf)
        if c & (c - 1) or c < 256:
            return  # not one of ours: let the collector have it
        with self._lock:
            if self._idle + c > _max_cached.get():
                return
            self._classes.setdefault(c, []).append(buf)
            self._idle += c

    @property
    def idle_bytes(self) -> int:
        return self._idle


#: process-wide pool for transport scratch
pool = BufferPool()


class Rcache:
    """LRU registration cache (rcache/grdma). Keys come from
    :func:`buffer_key` (an ``id()`` whose object carries a death hook,
    so a recycled id never aliases a dead entry). Values carry a byte
    cost; the total is capped by ``rcache_max_bytes`` with
    least-recently-used eviction."""

    def __init__(self) -> None:
        self._map: "OrderedDict[Any, Tuple[Any, int]]" = OrderedDict()
        self._bytes = 0
        # reentrant: a death hook can fire from a garbage collection
        # triggered while this thread is inside insert or lookup
        self._lock = threading.RLock()
        # the grdma pattern: subscribe to the release plane, weakly (the
        # hook must not keep a transient cache alive)
        memhooks.register_release(self.invalidate, weak=True)

    def insert(self, key, value, nbytes: int) -> None:
        with self._lock:
            if key in self._map:
                self._bytes -= self._map.pop(key)[1]
            self._map[key] = (value, nbytes)
            self._bytes += nbytes
            cap = _rcache_bytes.get()
            while self._bytes > cap and self._map:
                self._bytes -= self._map.popitem(last=False)[1][1]
                pvar.record("rcache_evictions")

    def lookup(self, key):
        with self._lock:
            hit = self._map.get(key)
            if hit is None:
                return None
            self._map.move_to_end(key)
        pvar.record("rcache_hits")
        return hit[0]

    def invalidate(self, key) -> None:
        with self._lock:
            hit = self._map.pop(key, None)
            if hit is not None:
                self._bytes -= hit[1]



def buffer_key(obj, cache: Rcache):
    """A cache key for ``obj``: its ``id()``, tracked on the release plane
    (one death hook per object serves every cache). None for an object
    that cannot carry a weak reference (callers then skip caching: a
    recycled id could alias a dead object's entry)."""
    return id(obj) if memhooks.track(obj) else None
