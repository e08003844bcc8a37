"""coll/adapt — event-driven segmented ibcast / ireduce.

The port's copy of ``ompi_tpu.coll.adapt`` (reference: ompi/mca/coll/adapt):
a nonblocking bcast or reduce split into segments, each a binomial
schedule of coll/libnbc progressing on its own, so segments pipeline and
a slow link stalls one segment rather than the whole operation. A
bounded window (``coll_adapt_max_inflight``) of segment schedules is in
flight: the progress engine resumes whichever segment's round completed,
and a finished segment admits the next; a :class:`CompositeRequest`
completes when every segment has. Opt-in, as in the reference: give
``coll_adapt_priority`` above libnbc's 20 to take the ``ibcast`` /
``ireduce`` slots; ``coll_adapt_segment_bytes`` sizes the segments.
Buffers that cannot be viewed flat (non-contiguous arrays, bytearrays)
go to libnbc.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from ompi_tpu_torch.coll import libnbc
from ompi_tpu_torch.coll.basic import IN_PLACE, _tag
from ompi_tpu_torch.core import cvar, progress, pvar, registry
from ompi_tpu_torch.pml import request as rq

_prio_var = cvar.register(
    "coll_adapt_priority", -1, int,
    help="coll/adapt selection priority; <0 disables (the reference "
         "ships adapt opt-in the same way). Must EXCEED libnbc's 20 "
         "to actually take the ibcast/ireduce slots.", level=6)
_seg_var = cvar.register(
    "coll_adapt_segment_bytes", 1 << 16, int,
    help="Segment size for adapt's pipelined ibcast/ireduce "
         "(reference: adapt segment sizing).", level=6)
_window_var = cvar.register(
    "coll_adapt_max_inflight", 32, int,
    help="Max segment schedules in flight per adapt operation (the "
         "reference bounds outstanding segments the same way; without "
         "a cap a 1 GiB bcast would post thousands of requests at "
         "once).", level=6)


class CompositeRequest(rq.Request):
    """Windowed per-segment schedules: finished segments admit new
    ones; completes when the last one has. Admission happens inside
    the ``completed`` poll, which every wait/test path drives via the
    progress engine."""

    def __init__(self, factories: List[Callable], window: int) -> None:
        super().__init__()
        self._factories = factories
        self._next = 0
        self._live: List[rq.Request] = []
        self._window = max(1, window)
        self._admit()

    def _admit(self) -> None:
        inflight = sum(1 for r in self._live if not r.completed)
        while (inflight < self._window
               and self._next < len(self._factories)):
            self._live.append(
                libnbc.NbcRequest(self._factories[self._next]()))
            self._next += 1
            inflight += 1

    @property
    def completed(self) -> bool:
        if self._next < len(self._factories):
            self._admit()
        return (self._next >= len(self._factories)
                and all(r.completed for r in self._live))

    @completed.setter
    def completed(self, v: bool) -> None:  # base __init__ writes here
        pass

    def test(self) -> bool:
        if not self.completed:
            progress.progress()
        return self.completed

    def wait(self, timeout=None):
        progress.wait_until(lambda: self.completed, timeout=timeout)
        if not self.completed:
            raise TimeoutError("adapt collective did not complete")
        return self.status


def _flat_view(buf, count: int) -> Optional[np.ndarray]:
    """A no-copy flat view of the first `count` elements, or None when
    the buffer cannot be viewed (delegate to libnbc then — receiving
    into a silent temporary would lose the data)."""
    if isinstance(buf, np.ndarray) and buf.flags["C_CONTIGUOUS"]:
        return buf.reshape(-1)[:count]
    return None


def _seg_spans(n: int, itemsize: int):
    per = max(1, _seg_var.get() // max(1, itemsize))
    return [(i, min(per, n - i)) for i in range(0, n, per)]


def ibcast_adapt(comm, buf, count, dtype, root):
    """Per-segment binomial trees under a bounded window (adapt
    ibcast)."""
    flat = _flat_view(buf, count)
    if flat is None:
        return libnbc.ibcast(comm, buf, count, dtype, root)
    pvar.record("adapt_ibcast")
    spans = _seg_spans(flat.size, flat.dtype.itemsize)
    # tags drawn NOW, at the collective call (every rank reaches it in
    # the same order): drawing lazily at admission would interleave
    # with other concurrent collectives' tag sequence per-rank
    tags = [_tag(comm) for _ in spans]
    factories = [
        (lambda off=off, n=n, tag=tag: libnbc._sched_bcast(
            comm, flat[off:off + n], n, dtype, root, tag))
        for (off, n), tag in zip(spans, tags)]
    return CompositeRequest(factories, _window_var.get())


def ireduce_adapt(comm, sendbuf, recvbuf, count, dtype, op, root):
    """Per-segment binomial reductions under a bounded window (adapt
    ireduce)."""
    src = recvbuf if sendbuf is IN_PLACE else sendbuf
    sflat = _flat_view(src, count)
    rflat = None if recvbuf is None else _flat_view(recvbuf, count)
    if sflat is None or (recvbuf is not None and rflat is None):
        return libnbc.ireduce(comm, sendbuf, recvbuf, count, dtype,
                              op, root)
    pvar.record("adapt_ireduce")
    spans = _seg_spans(sflat.size, sflat.dtype.itemsize)
    tags = [_tag(comm) for _ in spans]  # see ibcast_adapt
    factories = [
        (lambda off=off, n=n, tag=tag: libnbc._sched_reduce(
            comm, sflat[off:off + n],
            None if rflat is None else rflat[off:off + n],
            n, dtype, op, root, tag))
        for (off, n), tag in zip(spans, tags)]
    return CompositeRequest(factories, _window_var.get())


class CollAdapt(registry.Component):
    """The component comm_select ranks (opt-in)."""

    NAME = "adapt"

    def query(self, comm) -> int:
        if comm.size < 2:
            return -1
        return _prio_var.get()  # < 0 disables (the default)

    def slots(self, comm):
        return {"ibcast": ibcast_adapt, "ireduce": ireduce_adapt}
