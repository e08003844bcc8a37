"""coll/inter — the group-vs-group collectives of intercommunicators.

The port's copy of ``ompi_tpu.coll.inter`` (reference: ompi/mca/coll/inter,
leader-based: a local phase on the intercomm's ``local_comm``, the
leaders' exchange across the bridge, a local redistribution). Root
arguments follow MPI's inter convention: in the root's group the root
passes ``ROOT`` and the others ``PROC_NULL``; the other group passes the
root's rank in the remote group. Host buffers, as in the reference.

It is the only component that stacks on an intercommunicator
(``INTER_OK``; :func:`ompi_tpu_torch.coll.comm_select` keeps every other
one off), and it serves intercommunicators only.
"""

from __future__ import annotations

import numpy as np

from ompi_tpu_torch.comm.intercomm import ROOT
from ompi_tpu_torch.core import pvar, registry
from ompi_tpu_torch.pml.request import PROC_NULL

#: the leaders' pml tags per collective (negative: no wildcard matches)
_TAG_BARRIER, _TAG_BCAST, _TAG_ALLREDUCE = -22, -23, -24
_TAG_ALLGATHER, _TAG_ALLGATHER_OBJ = -25, -26


def _leader(comm) -> bool:
    return comm.rank == 0


def inter_barrier(comm) -> None:
    """A local barrier, the leaders' token exchange, a local barrier."""
    pvar.record("inter_barrier")
    comm.local_comm.Barrier()
    if _leader(comm):
        comm.sendrecv(None, dest=0, source=0, sendtag=_TAG_BARRIER,
                      recvtag=_TAG_BARRIER)
    comm.local_comm.Barrier()


def inter_bcast_obj(comm, obj, root):
    pvar.record("inter_bcast")
    if root == PROC_NULL:
        return None  # a non-root member of the root's group
    if root == ROOT:
        comm.send(obj, dest=0, tag=_TAG_BCAST)  # to the remote leader
        return obj
    if _leader(comm):
        obj = comm.recv(source=root, tag=_TAG_BCAST)
    return comm.local_comm.bcast(obj, root=0)


def _spec(buf, count, dtype):
    """The buffer spec of a host slot's (buf, count, dtype): dtype None is
    the buffer's own element type."""
    return (buf, count, dtype) if dtype is not None else (buf, count)


def inter_bcast(comm, buf, count, dtype, root) -> None:
    if root == PROC_NULL:
        return
    if root == ROOT:
        comm.Send(_spec(buf, count, dtype), dest=0, tag=_TAG_BCAST)
        return
    if _leader(comm):
        comm.Recv(_spec(buf, count, dtype), source=root, tag=_TAG_BCAST)
    comm.local_comm.Bcast(_spec(buf, count, dtype), root=0)


def inter_allreduce(comm, sendbuf, recvbuf, count, dtype, op) -> None:
    """Each group receives the reduction of the other group's vectors:
    a local reduce, the leaders' swap, a local bcast."""
    pvar.record("inter_allreduce")
    local = comm.local_comm
    sb = np.asarray(sendbuf)
    mine = np.empty_like(sb)
    local.Reduce(sb, mine, op=op, root=0)
    rb = np.asarray(recvbuf)
    if _leader(comm):
        rreq = comm.Irecv(_spec(rb, count, dtype), source=0,
                          tag=_TAG_ALLREDUCE)
        comm.Send(_spec(mine, count, dtype), dest=0, tag=_TAG_ALLREDUCE)
        rreq.wait()
    local.Bcast(_spec(rb, count, dtype), root=0)


def inter_allgather(comm, sendbuf, recvbuf, count, dtype) -> None:
    """``recvbuf`` receives the remote group's contributions
    (``remote_size * count`` elements)."""
    pvar.record("inter_allgather")
    local = comm.local_comm
    sb = np.asarray(sendbuf)
    gathered = np.empty((local.size,) + sb.shape, sb.dtype) \
        if _leader(comm) else None
    local.Gather(sb, gathered, root=0)
    rb = np.asarray(recvbuf)
    if _leader(comm):
        rreq = comm.Irecv(_spec(rb, rb.size, dtype), source=0,
                          tag=_TAG_ALLGATHER)
        comm.Send(_spec(gathered, gathered.size, dtype), dest=0,
                  tag=_TAG_ALLGATHER)
        rreq.wait()
    local.Bcast(_spec(rb, rb.size, dtype), root=0)


def inter_allgather_obj(comm, obj):
    pvar.record("inter_allgather")
    local = comm.local_comm
    mine = local.gather(obj, root=0)
    theirs = None
    if _leader(comm):
        theirs = comm.sendrecv(mine, dest=0, source=0,
                               sendtag=_TAG_ALLGATHER_OBJ,
                               recvtag=_TAG_ALLGATHER_OBJ)
    return local.bcast(theirs, root=0)


class CollInter(registry.Component):
    """The component comm_select ranks (intercommunicators only)."""

    NAME = "inter"
    PRIORITY = 45
    INTER_OK = True  # the group-vs-group algorithms

    def query(self, comm) -> int:
        return self.PRIORITY if getattr(comm, "is_inter", False) else -1

    def slots(self, comm):
        return {
            "barrier": inter_barrier,
            "bcast": inter_bcast,
            "bcast_obj": inter_bcast_obj,
            "allreduce": inter_allreduce,
            "allgather": inter_allgather,
            "allgather_obj": inter_allgather_obj,
        }
