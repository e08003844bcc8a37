"""coll/libnbc — nonblocking and persistent collectives as progressed
schedules.

The port's copy of ``ompi_tpu.coll.libnbc`` (coll/libnbc.py:27-450,
:484-655; reference: ompi/mca/coll/libnbc, nbc_internal.h:156-165): each
``I*`` collective is a schedule of send / receive / local-op rounds. A
schedule is a Python generator that yields the list of its round's
outstanding pml requests; :class:`NbcRequest` resumes it from the
progress engine (``core/progress.py``) once they have all completed.
The ``*_init`` forms (MPI-4 persistent collectives) are
:class:`PersistentCollRequest`: each ``start`` runs a new schedule over
the bound buffers. An error inside a schedule completes its own request
with that error, raised at its ``wait``; an argument error in the
prologue raises at the call. Priority 20. A finished schedule emits the
MPI_T event ``coll_schedule_complete`` (its kind, the comm's cid and the
rounds it ran; reference :87-92). On a topology comm the
``ineighbor_*`` forms (:449-482) are one schedule round over coll/basic's
``neighbor_*_reqs`` sets, posted at the call.
"""

from __future__ import annotations

from typing import Generator, List, Optional

import numpy as np

from ompi_tpu_torch import errors
from ompi_tpu_torch.coll import basic as B
from ompi_tpu_torch.coll.basic import _irecv, _isend, _tag
from ompi_tpu_torch.core import events as mpit_events, progress, registry
from ompi_tpu_torch.pml import request as rq

_active: List["NbcRequest"] = []
_registered = False


def _nbc_progress() -> int:
    events = 0
    for req in list(_active):
        events += req._advance()
    return events


class NbcRequest(rq.Request):
    """A schedule being progressed (reference: NBC_Handle)."""

    def __init__(self, gen: Generator) -> None:
        super().__init__()
        self._gen = gen
        self._round: Optional[List[rq.Request]] = None
        self._rounds_run = 0
        self._exc: Optional[BaseException] = None
        self._in_init = True
        self._advancing = False
        # the MPI_T event's fields, from the unstarted generator: the
        # schedule's kind from its name, the comm from its arguments
        self._kind = getattr(gen, "__name__", "?").replace("_sched_", "")
        frame = getattr(gen, "gi_frame", None)
        c = frame.f_locals.get("comm") if frame is not None else None
        self._comm_cid = getattr(c, "cid", -1)
        global _registered
        if not _registered:
            progress.register(_nbc_progress)
            _registered = True
        _active.append(self)
        self._advance()
        self._in_init = False

    def _advance(self) -> int:
        if self.completed or self._advancing:
            # _advancing: a schedule body's send can spin the progress
            # engine when a transport is full (ob1._pump), re-entering
            # this sweep while the generator is executing — resuming
            # it again would raise "generator already executing" into
            # the error path below (a silent false completion)
            return 0
        if self._round is not None and \
                not all(r.completed for r in self._round):
            return 0
        events = 0
        self._advancing = True
        try:
            while True:
                self._round = self._gen.send(None)
                events += 1
                self._rounds_run += 1
                if self._round and \
                        not all(r.completed for r in self._round):
                    return events
        except StopIteration:
            _active.remove(self)
            if mpit_events.active("coll_schedule_complete"):
                mpit_events.emit("coll_schedule_complete", kind=self._kind,
                                 comm_cid=self._comm_cid,
                                 rounds=self._rounds_run)
            self.complete()
            return events + 1
        except Exception as exc:
            # A schedule body failed. Escaping here would surface it in
            # whatever call was spinning progress.progress(), maybe an
            # unrelated request's wait: complete THIS request with the
            # error instead, to re-raise at its own wait(). Argument
            # errors in the prologue, which runs inside __init__, stay
            # loud at the call site; MPI errors always defer to the
            # wait (a failed communication is an outcome, not a
            # caller's mistake).
            _active.remove(self)
            if self._in_init and not isinstance(exc, errors.MPIError):
                raise
            self._exc = exc
            code = exc.error_class if isinstance(exc, errors.MPIError) \
                else errors.ERR_OTHER
            self.complete(error=code)
            return events + 1
        finally:
            self._advancing = False

    def wait(self, timeout=None):
        progress.wait_until(lambda: self.completed, timeout=timeout)
        if not self.completed:
            raise TimeoutError(f"request {self.id} did not complete")
        if self._exc is not None:
            raise self._exc
        # completed: base wait returns immediately and runs the
        # plain-error dispatch path
        return super().wait(timeout)


# -- schedules ------------------------------------------------------------

def _sched_barrier(comm, tag):
    """Dissemination rounds (libnbc ibarrier)."""
    rank, size = comm.rank, comm.size
    tok = np.zeros(1, dtype=np.uint8)
    rtok = np.zeros(1, dtype=np.uint8)
    dist = 1
    while dist < size:
        to = (rank + dist) % size
        frm = (rank - dist + size) % size
        yield [_irecv(comm, rtok, 1, None, frm, tag),
               _isend(comm, tok, 1, None, to, tag)]
        dist <<= 1


def _sched_bcast(comm, buf, count, dtype, root, tag):
    """Binomial rounds."""
    rank, size = comm.rank, comm.size
    vrank = (rank - root + size) % size
    arr = np.asarray(buf)
    if vrank != 0:
        mask = 1
        while not (vrank & mask):
            mask <<= 1
        parent = (vrank - mask + root) % size
        yield [_irecv(comm, arr, count, dtype, parent, tag)]
    sends = []
    m = 1
    while m < size:
        if vrank & m:
            break
        if vrank + m < size:
            child = (vrank + m + root) % size
            sends.append(_isend(comm, arr, count, dtype, child, tag))
        m <<= 1
    if sends:
        yield sends


def _sched_allreduce(comm, sendbuf, recvbuf, count, dtype, op, tag):
    """Recursive-doubling rounds (libnbc iallreduce)."""
    rank, size = comm.rank, comm.size
    rb = np.asarray(recvbuf)
    sb = np.asarray(recvbuf) if sendbuf is B.IN_PLACE \
        else np.asarray(sendbuf)
    if rb is not sb:
        np.copyto(rb, sb, casting="same_kind")
    tmp = np.empty_like(rb)
    adjsize = 1
    while adjsize * 2 <= size:
        adjsize *= 2
    extra = size - adjsize
    if rank < 2 * extra:
        if rank % 2 == 1:
            yield [_isend(comm, rb, count, dtype, rank - 1, tag)]
            yield [_irecv(comm, rb, count, dtype, rank - 1, tag)]
            return
        yield [_irecv(comm, tmp, count, dtype, rank + 1, tag)]
        rb[...] = op.np_fn(rb, tmp)
    new_rank = rank // 2 if rank < 2 * extra else rank - extra
    mask = 1
    while mask < adjsize:
        peer_new = new_rank ^ mask
        peer = peer_new * 2 if peer_new < extra else peer_new + extra
        yield [_irecv(comm, tmp, count, dtype, peer, tag),
               _isend(comm, rb.copy(), count, dtype, peer, tag)]
        if peer_new < new_rank:
            rb[...] = op.np_fn(tmp, rb)
        else:
            rb[...] = op.np_fn(rb, tmp)
        mask <<= 1
    if rank < 2 * extra and rank % 2 == 0:
        yield [_isend(comm, rb, count, dtype, rank + 1, tag)]


def _sched_gather(comm, sendbuf, recvbuf, count, dtype, root, tag):
    rank, size = comm.rank, comm.size
    sb = np.asarray(sendbuf)
    if rank == root:
        rb = np.asarray(recvbuf).reshape(size, -1)
        rb[root][:] = sb.reshape(-1)
        yield [_irecv(comm, rb[r], count, dtype, r, tag)
               for r in range(size) if r != root]
    else:
        yield [_isend(comm, sb, count, dtype, root, tag)]


def _sched_scatter(comm, sendbuf, recvbuf, count, dtype, root, tag):
    rank, size = comm.rank, comm.size
    rb = np.asarray(recvbuf)
    if rank == root:
        sb = np.asarray(sendbuf).reshape(size, -1)
        rb.reshape(-1)[:] = sb[root]
        yield [_isend(comm, sb[r].copy(), count, dtype, r, tag)
               for r in range(size) if r != root]
    else:
        yield [_irecv(comm, rb, count, dtype, root, tag)]


def _sched_allgather(comm, sendbuf, recvbuf, count, dtype, tag):
    """Ring rounds."""
    rank, size = comm.rank, comm.size
    rb = np.asarray(recvbuf).reshape(size, -1)
    if sendbuf is not B.IN_PLACE:
        rb[rank][:] = np.asarray(sendbuf).reshape(-1)
    nxt, prv = (rank + 1) % size, (rank - 1 + size) % size
    for step in range(size - 1):
        sidx = (rank - step + size) % size
        ridx = (rank - step - 1 + size) % size
        yield [_irecv(comm, rb[ridx], count, dtype, prv, tag),
               _isend(comm, rb[sidx].copy(), count, dtype, nxt, tag)]


def _sched_alltoall(comm, sendbuf, recvbuf, count, dtype, tag):
    """Pairwise rounds."""
    rank, size = comm.rank, comm.size
    sb = np.asarray(sendbuf).reshape(size, -1)
    rb = np.asarray(recvbuf).reshape(size, -1)
    rb[rank][:] = sb[rank]
    for step in range(1, size):
        to = (rank + step) % size
        frm = (rank - step + size) % size
        yield [_irecv(comm, rb[frm], count, dtype, frm, tag),
               _isend(comm, sb[to], count, dtype, to, tag)]


def _sched_reduce(comm, sendbuf, recvbuf, count, dtype, op, root, tag):
    rank, size = comm.rank, comm.size
    vrank = (rank - root + size) % size
    sb = np.asarray(recvbuf) if sendbuf is B.IN_PLACE \
        else np.asarray(sendbuf)
    acc = sb.copy()
    tmp = np.empty_like(acc)
    mask = 1
    while mask < size:
        if vrank & mask:
            parent = (vrank - mask + root) % size
            yield [_isend(comm, acc, count, dtype, parent, tag)]
            return
        child_v = vrank + mask
        if child_v < size:
            child = (child_v + root) % size
            yield [_irecv(comm, tmp, count, dtype, child, tag)]
            acc = op.np_fn(acc, tmp)
        mask <<= 1
    if recvbuf is not None:
        np.copyto(np.asarray(recvbuf), acc, casting="same_kind")


def _sched_gatherv(comm, sendbuf, recvbuf, counts, displs, dtype,
                   root, tag):
    rank, size = comm.rank, comm.size
    sb = np.asarray(sendbuf)
    if rank == root:
        rb = np.asarray(recvbuf).reshape(-1)
        rb[displs[root]:displs[root] + counts[root]] = sb.reshape(-1)
        yield [_irecv(comm, rb[displs[r]:displs[r] + counts[r]],
                      counts[r], dtype, r, tag)
               for r in range(size) if r != root and counts[r]]
    elif counts[rank]:
        yield [_isend(comm, sb, counts[rank], dtype, root, tag)]


def _sched_scatterv(comm, sendbuf, recvbuf, counts, displs, dtype,
                    root, tag):
    rank, size = comm.rank, comm.size
    rb = np.asarray(recvbuf)
    if rank == root:
        sb = np.asarray(sendbuf).reshape(-1)
        rb.reshape(-1)[:counts[root]] = \
            sb[displs[root]:displs[root] + counts[root]]
        yield [_isend(comm, sb[displs[r]:displs[r] + counts[r]].copy(),
                      counts[r], dtype, r, tag)
               for r in range(size) if r != root and counts[r]]
    elif counts[rank]:
        yield [_irecv(comm, rb, counts[rank], dtype, root, tag)]


def _sched_allgatherv(comm, sendbuf, recvbuf, counts, displs, dtype,
                      tag):
    """gatherv at 0, then binomial bcast of the assembled buffer."""
    rank = comm.rank
    rb = np.asarray(recvbuf).reshape(-1)
    sb = rb[displs[rank]:displs[rank] + counts[rank]].copy() \
        if sendbuf is B.IN_PLACE else sendbuf
    yield from _sched_gatherv(comm, sb, recvbuf, counts, displs,
                              dtype, 0, tag)
    total = max(displs[r] + counts[r] for r in range(comm.size))
    yield from _sched_bcast(comm, rb[:total], total, dtype, 0, tag)


def _sched_alltoallv(comm, sendbuf, recvbuf, scounts, sdispls,
                     rcounts, rdispls, dtype, tag):
    """Pairwise rounds with per-peer counts (libnbc ialltoallv)."""
    rank, size = comm.rank, comm.size
    sb = np.asarray(sendbuf).reshape(-1)
    rb = np.asarray(recvbuf).reshape(-1)
    rb[rdispls[rank]:rdispls[rank] + rcounts[rank]] = \
        sb[sdispls[rank]:sdispls[rank] + scounts[rank]]
    for step in range(1, size):
        to = (rank + step) % size
        frm = (rank - step + size) % size
        ops = []
        if rcounts[frm]:
            ops.append(_irecv(
                comm, rb[rdispls[frm]:rdispls[frm] + rcounts[frm]],
                rcounts[frm], dtype, frm, tag))
        if scounts[to]:
            ops.append(_isend(
                comm, sb[sdispls[to]:sdispls[to] + scounts[to]].copy(),
                scounts[to], dtype, to, tag))
        if ops:
            yield ops


def _sched_scan(comm, sendbuf, recvbuf, count, dtype, op, tag,
                exclusive: bool):
    """Linear chain rounds (libnbc iscan/iexscan)."""
    rank, size = comm.rank, comm.size
    sb = np.asarray(recvbuf) if sendbuf is B.IN_PLACE \
        else np.asarray(sendbuf)
    rb = np.asarray(recvbuf)
    acc = sb.copy()  # inclusive prefix through this rank
    if rank > 0:
        tmp = np.empty_like(acc)
        yield [_irecv(comm, tmp, count, dtype, rank - 1, tag)]
        if exclusive:
            np.copyto(rb, tmp, casting="same_kind")
        acc = op.np_fn(tmp, acc)
    if not exclusive:
        np.copyto(rb, acc, casting="same_kind")
    if rank + 1 < size:
        yield [_isend(comm, acc, count, dtype, rank + 1, tag)]


def _flat(buf):
    """Flatten a user buffer for the 1-D staging compositions (other
    schedules reshape internally; _sched_reduce's final copyto needs
    matching shapes)."""
    return buf if buf is B.IN_PLACE else np.asarray(buf).reshape(-1)


def _sched_reduce_scatter_block(comm, sendbuf, recvbuf, count, dtype,
                                op, tag):
    """reduce at 0 + scatter rounds (compose: the schedule engine makes
    pipelined composition a yield-from)."""
    size = comm.size
    full = np.empty(size * count, dtype=np.asarray(recvbuf).dtype) \
        if comm.rank == 0 else None
    yield from _sched_reduce(comm, _flat(sendbuf), full, size * count,
                             dtype, op, 0, tag)
    yield from _sched_scatter(comm, full, recvbuf, count, dtype, 0, tag)


def _sched_reduce_scatter(comm, sendbuf, recvbuf, counts, dtype, op,
                          tag):
    total = sum(counts)
    displs = np.concatenate(
        ([0], np.cumsum(counts[:-1], dtype=np.intp))).tolist()
    full = np.empty(total, dtype=np.asarray(recvbuf).dtype) \
        if comm.rank == 0 else None
    yield from _sched_reduce(comm, _flat(sendbuf), full, total, dtype,
                             op, 0, tag)
    yield from _sched_scatterv(comm, full, recvbuf, counts, displs,
                               dtype, 0, tag)


# -- persistent collectives (MPI-4 *_init over the schedule engine) --------

class PersistentCollRequest(rq.Request):
    """MPI-4 persistent collective: start() re-launches the schedule;
    the request is reusable (reference: the 17 *_init slots of
    coll.h:532-649, implemented in libnbc).

    ``completed`` proxies the live schedule, so the plural waits
    (wait_all/wait_any/test_all) — which poll ``r.completed`` while
    spinning the progress engine — observe completion without needing
    a per-request test() call."""

    def __init__(self, factory) -> None:
        super().__init__()
        self.persistent = True
        self._factory = factory
        self._inner: Optional[NbcRequest] = None
        self._idle_done = True  # inactive counts as complete (MPI)

    @property
    def completed(self) -> bool:
        if self._inner is not None:
            return self._inner.completed
        return self._idle_done

    @completed.setter
    def completed(self, v: bool) -> None:  # base __init__ writes here
        self._idle_done = bool(v)

    def start(self) -> None:
        if self._inner is not None and not self._inner.completed:
            raise errors.MPIError(
                errors.ERR_REQUEST,
                "start: the previous cycle is still active: wait() it "
                "first")
        self._inner = NbcRequest(self._factory())

    def test(self) -> bool:
        if not self.completed:
            progress.progress()
        return self.completed

    def wait(self, timeout=None):
        if self._inner is not None:
            return self._inner.wait(timeout)
        return self.status


def ibarrier(comm):
    return NbcRequest(_sched_barrier(comm, _tag(comm)))


def ibcast(comm, buf, count, dtype, root):
    return NbcRequest(_sched_bcast(comm, buf, count, dtype, root,
                                   _tag(comm)))


def iallreduce(comm, sendbuf, recvbuf, count, dtype, op):
    return NbcRequest(_sched_allreduce(comm, sendbuf, recvbuf, count,
                                       dtype, op, _tag(comm)))


def ireduce(comm, sendbuf, recvbuf, count, dtype, op, root):
    return NbcRequest(_sched_reduce(comm, sendbuf, recvbuf, count,
                                    dtype, op, root, _tag(comm)))


def igather(comm, sendbuf, recvbuf, count, dtype, root):
    return NbcRequest(_sched_gather(comm, sendbuf, recvbuf, count,
                                    dtype, root, _tag(comm)))


def iscatter(comm, sendbuf, recvbuf, count, dtype, root):
    return NbcRequest(_sched_scatter(comm, sendbuf, recvbuf, count,
                                     dtype, root, _tag(comm)))


def iallgather(comm, sendbuf, recvbuf, count, dtype):
    return NbcRequest(_sched_allgather(comm, sendbuf, recvbuf, count,
                                       dtype, _tag(comm)))


def ialltoall(comm, sendbuf, recvbuf, count, dtype):
    return NbcRequest(_sched_alltoall(comm, sendbuf, recvbuf, count,
                                      dtype, _tag(comm)))


def igatherv(comm, sendbuf, recvbuf, counts, displs, dtype, root):
    return NbcRequest(_sched_gatherv(comm, sendbuf, recvbuf, counts,
                                     displs, dtype, root, _tag(comm)))


def iscatterv(comm, sendbuf, recvbuf, counts, displs, dtype, root):
    return NbcRequest(_sched_scatterv(comm, sendbuf, recvbuf, counts,
                                      displs, dtype, root, _tag(comm)))


def iallgatherv(comm, sendbuf, recvbuf, counts, displs, dtype):
    return NbcRequest(_sched_allgatherv(comm, sendbuf, recvbuf, counts,
                                        displs, dtype, _tag(comm)))


def ialltoallv(comm, sendbuf, recvbuf, scounts, sdispls, rcounts,
               rdispls, dtype):
    return NbcRequest(_sched_alltoallv(
        comm, sendbuf, recvbuf, scounts, sdispls, rcounts, rdispls,
        dtype, _tag(comm)))


def iscan(comm, sendbuf, recvbuf, count, dtype, op):
    return NbcRequest(_sched_scan(comm, sendbuf, recvbuf, count, dtype,
                                  op, _tag(comm), exclusive=False))


def iexscan(comm, sendbuf, recvbuf, count, dtype, op):
    return NbcRequest(_sched_scan(comm, sendbuf, recvbuf, count, dtype,
                                  op, _tag(comm), exclusive=True))


def ireduce_scatter_block(comm, sendbuf, recvbuf, count, dtype, op):
    return NbcRequest(_sched_reduce_scatter_block(
        comm, sendbuf, recvbuf, count, dtype, op, _tag(comm)))


def ireduce_scatter(comm, sendbuf, recvbuf, counts, dtype, op):
    return NbcRequest(_sched_reduce_scatter(
        comm, sendbuf, recvbuf, counts, dtype, op, _tag(comm)))


def _persistent(sched, comm, *args):
    # one tag per start: each launch is a distinct operation on the
    # collective context
    return PersistentCollRequest(lambda: sched(comm, *args, _tag(comm)))


def barrier_init(comm):
    return _persistent(_sched_barrier, comm)


def bcast_init(comm, buf, count, dtype, root):
    return _persistent(_sched_bcast, comm, buf, count, dtype, root)


def allreduce_init(comm, sendbuf, recvbuf, count, dtype, op):
    return _persistent(_sched_allreduce, comm, sendbuf, recvbuf, count,
                       dtype, op)


def reduce_init(comm, sendbuf, recvbuf, count, dtype, op, root):
    return _persistent(_sched_reduce, comm, sendbuf, recvbuf, count,
                       dtype, op, root)


def gather_init(comm, sendbuf, recvbuf, count, dtype, root):
    return _persistent(_sched_gather, comm, sendbuf, recvbuf, count,
                       dtype, root)


def scatter_init(comm, sendbuf, recvbuf, count, dtype, root):
    return _persistent(_sched_scatter, comm, sendbuf, recvbuf, count,
                       dtype, root)


def allgather_init(comm, sendbuf, recvbuf, count, dtype):
    return _persistent(_sched_allgather, comm, sendbuf, recvbuf, count,
                       dtype)


def alltoall_init(comm, sendbuf, recvbuf, count, dtype):
    return _persistent(_sched_alltoall, comm, sendbuf, recvbuf, count,
                       dtype)


def reduce_scatter_block_init(comm, sendbuf, recvbuf, count, dtype,
                              op):
    return _persistent(_sched_reduce_scatter_block, comm, sendbuf,
                       recvbuf, count, dtype, op)


# -- the nonblocking neighbourhood collectives (ineighbor_allgather.c and
# its family): one linear round, posted at the call

def _sched_neighbor(comm, reqs):
    yield reqs


def ineighbor_allgather(comm, sendbuf, recvbuf, count, dtype):
    return NbcRequest(_sched_neighbor(
        comm, B.neighbor_allgather_reqs(comm, sendbuf, recvbuf, count,
                                        dtype)))


def ineighbor_alltoall(comm, sendbuf, recvbuf, count, dtype):
    return NbcRequest(_sched_neighbor(
        comm, B.neighbor_alltoall_reqs(comm, sendbuf, recvbuf, count,
                                       dtype)))


def ineighbor_allgatherv(comm, sendbuf, recvbuf, count, dtype, rcounts,
                         rdispls):
    return NbcRequest(_sched_neighbor(
        comm, B.neighbor_allgatherv_reqs(comm, sendbuf, recvbuf, count,
                                         dtype, rcounts, rdispls)))


def ineighbor_alltoallv(comm, sendbuf, recvbuf, dtype, scounts, sdispls,
                        rcounts, rdispls):
    return NbcRequest(_sched_neighbor(
        comm, B.neighbor_alltoallv_reqs(comm, sendbuf, recvbuf, dtype,
                                        scounts, sdispls, rcounts,
                                        rdispls)))


class CollLibnbc(registry.Component):
    """The component comm_select ranks."""

    NAME = "libnbc"
    PRIORITY = 20

    def query(self, comm) -> int:
        return self.PRIORITY

    def slots(self, comm):
        return {
            "ibarrier": ibarrier,
            "ibcast": ibcast,
            "iallreduce": iallreduce,
            "ireduce": ireduce,
            "igather": igather,
            "iscatter": iscatter,
            "iallgather": iallgather,
            "ialltoall": ialltoall,
            "igatherv": igatherv,
            "iscatterv": iscatterv,
            "iallgatherv": iallgatherv,
            "ialltoallv": ialltoallv,
            "iscan": iscan,
            "iexscan": iexscan,
            "ireduce_scatter": ireduce_scatter,
            "ireduce_scatter_block": ireduce_scatter_block,
            # MPI-4 persistent collectives
            "barrier_init": barrier_init,
            "bcast_init": bcast_init,
            "allreduce_init": allreduce_init,
            "reduce_init": reduce_init,
            "gather_init": gather_init,
            "scatter_init": scatter_init,
            "allgather_init": allgather_init,
            "alltoall_init": alltoall_init,
            "reduce_scatter_block_init": reduce_scatter_block_init,
            # the nonblocking neighbourhood forms: topology comms only
            **({} if getattr(comm, "topo", None) is None else {
                "ineighbor_allgather": ineighbor_allgather,
                "ineighbor_alltoall": ineighbor_alltoall,
                "ineighbor_allgatherv": ineighbor_allgatherv,
                "ineighbor_alltoallv": ineighbor_alltoallv}),
        }
