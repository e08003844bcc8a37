"""coll/basic — the linear object collectives and barrier over the pml.

The reduced counterpart of ``ompi_tpu.coll.basic`` (the lowest priority,
stacked for every communicator, size 1 included): the object
collectives of the lower-case API (``bcast_obj``, ``gather_obj``,
``scatter_obj``, ``allgather_obj``, ``alltoall_obj``, ``allreduce_obj``)
and the linear ``barrier``, each as the reference runs it: pickled
objects over ob1's object channel on the communicator's collective
context (coll/basic.py:353-410; the barrier gathers a token to rank 0
and releases, :109). Each call takes the next tag of the comm's table,
so every member must call a comm's collectives in the same order (MPI's
rule). The one-sided windows (peer info at creation, descriptors at
every fence) and coll/device's scatter metadata round ride these.

The host-buffer algorithms (numpy Allreduce and the rest) come with
coll/basic's remaining slots and coll/tuned (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from ompi_tpu_torch import pml
from ompi_tpu_torch.core import pvar


def _send_obj(comm, obj, dst, tag):
    pml.current().send_obj(comm, obj, dst, tag, collective=True)


def _recv_obj(comm, src, tag):
    return pml.current().recv_obj(comm, src, tag, collective=True)


def barrier(comm) -> None:
    """Linear barrier: a token from every rank to rank 0, then one back
    (coll_basic_barrier.c)."""
    pvar.record("barrier")
    tag = comm.coll.next_tag()
    p = pml.current()
    token = np.zeros(1, dtype=np.uint8)
    if comm.rank == 0:
        for r in range(1, comm.size):
            p.recv(comm, token, 1, None, r, tag, collective=True)
        for r in range(1, comm.size):
            p.send(comm, token, 1, None, r, tag, collective=True)
    elif comm.size > 1:
        p.send(comm, token, 1, None, 0, tag, collective=True)
        p.recv(comm, token, 1, None, 0, tag, collective=True)


def bcast_obj(comm, obj, root: int = 0):
    """The root's ``obj`` (picklable) on every member; the others pass
    anything (None)."""
    tag = comm.coll.next_tag()
    if comm.rank == root:
        for r in range(comm.size):
            if r != root:
                _send_obj(comm, obj, r, tag)
        return obj
    return _recv_obj(comm, root, tag)


def gather_obj(comm, obj, root: int = 0) -> Optional[List[Any]]:
    """Every member's ``obj`` on the root in comm rank order, None
    elsewhere."""
    tag = comm.coll.next_tag()
    if comm.rank == root:
        out: List[Any] = [None] * comm.size
        out[root] = obj
        for r in range(comm.size):
            if r != root:
                out[r] = _recv_obj(comm, r, tag)
        return out
    _send_obj(comm, obj, root, tag)
    return None


def scatter_obj(comm, objs, root: int = 0):
    """``objs[r]`` of the root on rank r."""
    tag = comm.coll.next_tag()
    if comm.rank == root:
        for r in range(comm.size):
            if r != root:
                _send_obj(comm, objs[r], r, tag)
        return objs[root]
    return _recv_obj(comm, root, tag)


def allgather_obj(comm, obj) -> List[Any]:
    """Every member's ``obj`` in comm rank order (a gather to rank 0,
    then its broadcast, coll/basic.py:386)."""
    return bcast_obj(comm, gather_obj(comm, obj, 0), 0)


def alltoall_obj(comm, objs) -> List[Any]:
    """``objs[r]`` goes to rank r; returns what each rank sent here."""
    tag = comm.coll.next_tag()
    me = comm.rank
    p = pml.current()
    out: List[Any] = [None] * comm.size
    out[me] = objs[me]
    sreqs = [p.isend_obj(comm, objs[r], r, tag, collective=True)
             for r in range(comm.size) if r != me]
    for r in range(comm.size):
        if r != me:
            out[r] = _recv_obj(comm, r, tag)
    for q in sreqs:
        q.wait()
    return out


def allreduce_obj(comm, obj, fn):
    """Every member's ``obj`` folded in rank order with ``fn``."""
    vals = allgather_obj(comm, obj)
    acc = vals[0]
    for v in vals[1:]:
        acc = fn(acc, v)
    return acc


class CollBasic:
    """The component comm_select ranks."""

    NAME = "basic"
    PRIORITY = 10  # the reference's basic level: below every device provider

    def query(self, comm) -> int:
        return self.PRIORITY

    def slots(self, comm):
        return {"barrier": barrier, "bcast_obj": bcast_obj,
                "gather_obj": gather_obj, "scatter_obj": scatter_obj,
                "allgather_obj": allgather_obj,
                "alltoall_obj": alltoall_obj,
                "allreduce_obj": allreduce_obj}
