"""mpool — the receive bounce pool.

The port's reduction of ``ompi_tpu.core.mpool`` (reference:
opal/mca/allocator/bucket, size-class free lists feeding the transports'
fragment pools) to the :class:`BufferPool` ob1 draws object-message
scratch from (ob1.py:143, :699). The registration cache (``Rcache``)
has no caller in the port.
"""

from __future__ import annotations

import threading
from typing import Dict, List

from ompi_tpu_torch.core import cvar, pvar

_max_cached = cvar.register(
    "mpool_max_cached_bytes", 32 << 20, int,
    help="Upper bound on idle bytes retained per BufferPool size "
         "class set (reference: allocator/bucket caps its buckets); "
         "0 disables pooling entirely.", level=7)


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
