"""coll/basic — the linear algorithms over the pml.

The port's copy of ``ompi_tpu.coll.basic`` (coll/basic.py:80-410; the
lowest priority, stacked for every communicator, size 1 included): the
naive linear algorithms every other component is held against, each
folding in rank order, so a float reduction's bits are fixed:

- ``barrier`` (a token from every rank to rank 0, then one back,
  :109), ``bcast`` (the root sends to every rank), ``reduce`` (the
  root folds the contributions in ascending rank order, :134) and
  ``allreduce`` (reduce to 0, then bcast);
- ``gather`` / ``gatherv`` / ``scatter`` / ``scatterv`` (the root posts
  one receive or send per rank), ``allgather`` (gather + bcast),
  ``allgatherv``, ``alltoall`` (every send and receive posted at once)
  and ``alltoallv``;
- ``reduce_scatter_block`` / ``reduce_scatter`` (reduce at 0, then
  scatter(v)), ``scan`` / ``exscan`` (a chain in rank order) and
  ``reduce_local``;
- the object collectives of the lower-case API (``bcast_obj``,
  ``gather_obj``, ``scatter_obj``, ``allgather_obj``, ``alltoall_obj``,
  ``allreduce_obj``): pickled objects over ob1's object channel.

Buffers are numpy (or any object with the buffer protocol), moved as
``count`` elements of ``dtype`` (None: the buffer's own element type);
``IN_PLACE`` as the send buffer takes the receive buffer's contents.
Everything runs on the communicator's collective context, and each call
takes the next tag of the comm's table, so every member must call a
comm's collectives in the same order (MPI's rule).

On a topology comm (:mod:`ompi_tpu_torch.topo`) it adds the neighbourhood
slots (:425-559): ``neighbor_allgather`` / ``_alltoall`` /
``_allgatherv`` / ``_alltoallv``, one linear round of isends and irecvs
over the topology's lists in MPI order (PROC_NULL edges skipped), and
their ``*_reqs`` builders, which coll/libnbc's ``ineighbor_*`` forms run
as one schedule round. A cart tags each edge by its slot and matches the
conjugate slot (``slot ^ 1``: the (d, -1) in-edge is the peer's (d, +1)
out-edge, which tells the two directions of a periodic dim of size 2
apart); a graph or dist graph uses one tag, so duplicate edges match in
posted order.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from ompi_tpu_torch import op as op_mod
from ompi_tpu_torch import pml
from ompi_tpu_torch.core import pvar, registry
from ompi_tpu_torch.pml.request import PROC_NULL

IN_PLACE = "MPI_IN_PLACE"


def _tag(comm) -> int:
    return comm.coll.next_tag()


# -- p2p building blocks (always the collective context) -------------------

def _send(comm, buf, count, dtype, dst, tag):
    pml.current().send(comm, buf, count, dtype, dst, tag, collective=True)


def _recv(comm, buf, count, dtype, src, tag):
    return pml.current().recv(comm, buf, count, dtype, src, tag,
                              collective=True)


def _isend(comm, buf, count, dtype, dst, tag):
    return pml.current().isend(comm, buf, count, dtype, dst, tag,
                               collective=True)


def _irecv(comm, buf, count, dtype, src, tag):
    return pml.current().irecv(comm, buf, count, dtype, src, tag,
                               collective=True)


def _send_obj(comm, obj, dst, tag):
    pml.current().send_obj(comm, obj, dst, tag, collective=True)


def _recv_obj(comm, src, tag):
    return pml.current().recv_obj(comm, src, tag, collective=True)


# -- collectives ------------------------------------------------------------

def barrier(comm) -> None:
    """Linear barrier: a token from every rank to rank 0, then one back
    (coll_basic_barrier.c)."""
    pvar.record("barrier")
    tag = _tag(comm)
    token = np.zeros(1, dtype=np.uint8)
    if comm.rank == 0:
        for r in range(1, comm.size):
            _recv(comm, token, 1, None, r, tag)
        for r in range(1, comm.size):
            _send(comm, token, 1, None, r, tag)
    elif comm.size > 1:
        _send(comm, token, 1, None, 0, tag)
        _recv(comm, token, 1, None, 0, tag)


def bcast_linear(comm, buf, count, dtype, root: int) -> None:
    pvar.record("bcast")
    tag = _tag(comm)
    if comm.rank == root:
        reqs = [_isend(comm, buf, count, dtype, r, tag)
                for r in range(comm.size) if r != root]
        for q in reqs:
            q.wait()
    else:
        _recv(comm, buf, count, dtype, root, tag)


def reduce_linear(comm, sendbuf, recvbuf, count, dtype, op, root: int):
    """The rank-order fold at the root (coll_basic_reduce.c): the
    receives arrive in ascending rank order, so the root folds as they
    come, ``acc = op(acc, contribution)``."""
    pvar.record("reduce")
    tag = _tag(comm)
    sb = np.asarray(recvbuf if sendbuf is IN_PLACE else sendbuf)
    if comm.rank == root:
        tmp = np.empty_like(sb)
        result = None
        for r in range(comm.size):
            if r == root:
                contrib = sb
            else:
                _recv(comm, tmp, count, dtype, r, tag)
                contrib = tmp
            result = contrib.copy() if result is None \
                else op.np_fn(result, contrib)
        np.copyto(np.asarray(recvbuf), result, casting="same_kind")
    else:
        _send(comm, sb, count, dtype, root, tag)


def allreduce_reduce_bcast(comm, sendbuf, recvbuf, count, dtype, op):
    pvar.record("allreduce")
    reduce_linear(comm, sendbuf, recvbuf, count, dtype, op, 0)
    bcast_linear(comm, recvbuf, count, dtype, 0)


def gather_linear(comm, sendbuf, recvbuf, count, dtype, root: int):
    """``recvbuf`` on the root holds ``size * count`` elements."""
    pvar.record("gather")
    tag = _tag(comm)
    sb = np.asarray(sendbuf)
    if comm.rank == root:
        rb = np.asarray(recvbuf).reshape(comm.size, -1)
        rb[root][:] = sb.reshape(-1)
        reqs = [_irecv(comm, rb[r], count, dtype, r, tag)
                for r in range(comm.size) if r != root]
        for q in reqs:
            q.wait()
    else:
        _send(comm, sb, count, dtype, root, tag)


def gatherv_linear(comm, sendbuf, recvbuf, counts, displs, dtype,
                   root: int):
    pvar.record("gather")
    tag = _tag(comm)
    sb = np.asarray(sendbuf)
    if comm.rank == root:
        rb = np.asarray(recvbuf).reshape(-1)
        rb[displs[root]:displs[root] + counts[root]] = sb.reshape(-1)
        reqs = [_irecv(comm, rb[displs[r]:displs[r] + counts[r]],
                       counts[r], dtype, r, tag)
                for r in range(comm.size) if r != root]
        for q in reqs:
            q.wait()
    else:
        _send(comm, sb, len(sb.reshape(-1)), dtype, root, tag)


def scatter_linear(comm, sendbuf, recvbuf, count, dtype, root: int):
    pvar.record("scatter")
    tag = _tag(comm)
    rb = np.asarray(recvbuf)
    if comm.rank == root:
        sb = np.asarray(sendbuf).reshape(comm.size, -1)
        reqs = [_isend(comm, sb[r], count, dtype, r, tag)
                for r in range(comm.size) if r != root]
        rb.reshape(-1)[:] = sb[root]
        for q in reqs:
            q.wait()
    else:
        _recv(comm, rb, count, dtype, root, tag)


def scatterv_linear(comm, sendbuf, recvbuf, counts, displs, dtype,
                    root: int):
    pvar.record("scatter")
    tag = _tag(comm)
    rb = np.asarray(recvbuf)
    if comm.rank == root:
        sb = np.asarray(sendbuf).reshape(-1)
        reqs = []
        for r in range(comm.size):
            view = sb[displs[r]:displs[r] + counts[r]]
            if r == root:
                rb.reshape(-1)[:counts[r]] = view
            else:
                reqs.append(_isend(comm, view.copy(), counts[r], dtype,
                                   r, tag))
        for q in reqs:
            q.wait()
    else:
        _recv(comm, rb, len(rb.reshape(-1)), dtype, root, tag)


def allgather_gather_bcast(comm, sendbuf, recvbuf, count, dtype):
    pvar.record("allgather")
    gather_linear(comm, sendbuf, recvbuf, count, dtype, 0)
    bcast_linear(comm, recvbuf, count * comm.size, dtype, 0)


def allgatherv_linear(comm, sendbuf, recvbuf, counts, displs, dtype):
    pvar.record("allgather")
    gatherv_linear(comm, sendbuf, recvbuf, counts, displs, dtype, 0)
    total = max(displs[r] + counts[r] for r in range(comm.size))
    bcast_linear(comm, np.asarray(recvbuf).reshape(-1)[:total], total,
                 dtype, 0)


def alltoall_pairwise_isend(comm, sendbuf, recvbuf, count, dtype):
    """Every send and receive posted at once (coll_basic_alltoall)."""
    pvar.record("alltoall")
    tag = _tag(comm)
    sb = np.asarray(sendbuf).reshape(comm.size, -1)
    rb = np.asarray(recvbuf).reshape(comm.size, -1)
    rb[comm.rank][:] = sb[comm.rank]
    rreqs = [_irecv(comm, rb[r], count, dtype, r, tag)
             for r in range(comm.size) if r != comm.rank]
    sreqs = [_isend(comm, sb[r], count, dtype, r, tag)
             for r in range(comm.size) if r != comm.rank]
    for q in rreqs + sreqs:
        q.wait()


def alltoallv_linear(comm, sendbuf, recvbuf, scounts, sdispls,
                     rcounts, rdispls, dtype):
    pvar.record("alltoall")
    tag = _tag(comm)
    sb = np.asarray(sendbuf).reshape(-1)
    rb = np.asarray(recvbuf).reshape(-1)
    me = comm.rank
    rb[rdispls[me]:rdispls[me] + rcounts[me]] = \
        sb[sdispls[me]:sdispls[me] + scounts[me]]
    rreqs = [_irecv(comm, rb[rdispls[r]:rdispls[r] + rcounts[r]],
                    rcounts[r], dtype, r, tag)
             for r in range(comm.size) if r != me]
    sreqs = [_isend(comm, sb[sdispls[r]:sdispls[r] + scounts[r]].copy(),
                    scounts[r], dtype, r, tag)
             for r in range(comm.size) if r != me]
    for q in rreqs + sreqs:
        q.wait()


def reduce_scatter_block_basic(comm, sendbuf, recvbuf, count, dtype, op):
    """Reduce at 0, then scatter (coll_basic_reduce_scatter_block.c)."""
    pvar.record("reduce_scatter")
    sb = np.asarray(sendbuf)
    total = np.empty_like(sb) if comm.rank == 0 else sb
    reduce_linear(comm, sb, total, count * comm.size, dtype, op, 0)
    scatter_linear(comm, total if comm.rank == 0 else None, recvbuf,
                   count, dtype, 0)


def packed_displs(counts) -> list:
    """The MPI default displacements: ``counts`` packed end to end."""
    displs, o = [], 0
    for c in counts:
        displs.append(o)
        o += int(c)
    return displs


def reduce_scatter_basic(comm, sendbuf, recvbuf, counts, dtype, op):
    """MPI_Reduce_scatter with per-rank counts: reduce, then scatterv."""
    pvar.record("reduce_scatter")
    sb = np.asarray(sendbuf)
    total = np.empty_like(sb) if comm.rank == 0 else sb
    reduce_linear(comm, sb, total, int(sum(counts)), dtype, op, 0)
    scatterv_linear(comm, total if comm.rank == 0 else None, recvbuf,
                    counts, packed_displs(counts), dtype, 0)


def scan_linear(comm, sendbuf, recvbuf, count, dtype, op):
    """MPI_Scan: the inclusive prefix, a chain in rank order."""
    pvar.record("scan")
    tag = _tag(comm)
    sb = np.asarray(recvbuf if sendbuf is IN_PLACE else sendbuf)
    rb = np.asarray(recvbuf)
    if comm.rank == 0:
        np.copyto(rb, sb, casting="same_kind")
    else:
        prev = np.empty_like(rb)
        _recv(comm, prev, count, dtype, comm.rank - 1, tag)
        np.copyto(rb, op.np_fn(prev, sb), casting="same_kind")
    if comm.rank + 1 < comm.size:
        _send(comm, rb, count, dtype, comm.rank + 1, tag)


def exscan_linear(comm, sendbuf, recvbuf, count, dtype, op):
    """MPI_Exscan: rank 0's recvbuf is left as it was (MPI leaves it
    undefined)."""
    pvar.record("exscan")
    tag = _tag(comm)
    # in place, the receive overwrites recvbuf: keep its contribution
    sb = np.asarray(recvbuf).copy() if sendbuf is IN_PLACE \
        else np.asarray(sendbuf)
    rb = np.asarray(recvbuf)
    if comm.rank > 0:
        _recv(comm, rb, count, dtype, comm.rank - 1, tag)
    if comm.rank + 1 < comm.size:
        nxt = sb if comm.rank == 0 else op.np_fn(rb, sb)
        _send(comm, np.ascontiguousarray(nxt), count, dtype,
              comm.rank + 1, tag)


def reduce_local(comm, inbuf, inoutbuf, count, dtype, op):
    op_mod.reduce_local(np.asarray(inbuf), np.asarray(inoutbuf), op)


# -- the object collectives -------------------------------------------------

def bcast_obj(comm, obj, root: int = 0):
    """The root's ``obj`` (picklable) on every member; the others pass
    anything (None)."""
    tag = _tag(comm)
    if comm.rank == root:
        for r in range(comm.size):
            if r != root:
                _send_obj(comm, obj, r, tag)
        return obj
    return _recv_obj(comm, root, tag)


def gather_obj(comm, obj, root: int = 0) -> Optional[List[Any]]:
    """Every member's ``obj`` on the root in comm rank order, None
    elsewhere."""
    tag = _tag(comm)
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
    tag = _tag(comm)
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
    tag = _tag(comm)
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


# -- the neighbourhood collectives (topology comms only) --------------------

def _nbr_tags(comm, topo):
    """(send tag, receive tag) of each edge slot: conjugate slot tags on a
    cart, one tag on a graph or dist graph."""
    base = _tag(comm)
    if getattr(topo, "kind", None) == "cart":
        return ((lambda slot: (base + 1 + slot) & 0x3FFFFFFF),
                (lambda slot: (base + 1 + (slot ^ 1)) & 0x3FFFFFFF))
    return (lambda slot: base), (lambda slot: base)


def neighbor_allgather_reqs(comm, sendbuf, recvbuf, count, dtype):
    """Post the allgather's isends and irecvs (one linear round) and
    return them: the blocking form waits on them, the ``ineighbor`` form
    runs them as a schedule round."""
    pvar.record("neighbor_allgather")
    topo = comm.topo
    ins = topo.in_neighbors(comm.rank)
    outs = topo.out_neighbors(comm.rank)
    send_tag, recv_tag = _nbr_tags(comm, topo)
    sb = np.asarray(sendbuf)
    # zero-degree ranks are legal (receive-only / send-only dist graphs)
    rb = np.asarray(recvbuf).reshape(len(ins), -1) if ins else None
    rreqs = [_irecv(comm, rb[i], count, dtype, src, recv_tag(i))
             for i, src in enumerate(ins) if src != PROC_NULL]
    sreqs = [_isend(comm, sb, count, dtype, dst, send_tag(i))
             for i, dst in enumerate(outs) if dst != PROC_NULL]
    return rreqs + sreqs


def neighbor_alltoall_reqs(comm, sendbuf, recvbuf, count, dtype):
    """Block j of ``sendbuf`` to out-neighbour j, block i of ``recvbuf``
    from in-neighbour i."""
    pvar.record("neighbor_alltoall")
    topo = comm.topo
    ins = topo.in_neighbors(comm.rank)
    outs = topo.out_neighbors(comm.rank)
    send_tag, recv_tag = _nbr_tags(comm, topo)
    sb = np.asarray(sendbuf).reshape(len(outs), -1) if outs else None
    rb = np.asarray(recvbuf).reshape(len(ins), -1) if ins else None
    rreqs = [_irecv(comm, rb[i], count, dtype, src, recv_tag(i))
             for i, src in enumerate(ins) if src != PROC_NULL]
    sreqs = [_isend(comm, sb[i], count, dtype, dst, send_tag(i))
             for i, dst in enumerate(outs) if dst != PROC_NULL]
    return rreqs + sreqs


def neighbor_allgatherv_reqs(comm, sendbuf, recvbuf, count, dtype,
                             rcounts, rdispls):
    """The same ``count`` elements to every out-neighbour; in-neighbour
    i's block at ``rdispls[i]``, ``rcounts[i]`` elements. A zero count
    posts nothing on either side (both sides skip it alike)."""
    pvar.record("neighbor_allgatherv")
    topo = comm.topo
    ins = topo.in_neighbors(comm.rank)
    outs = topo.out_neighbors(comm.rank)
    send_tag, recv_tag = _nbr_tags(comm, topo)
    sb = np.asarray(sendbuf)
    rb = np.asarray(recvbuf).reshape(-1)
    rreqs = [_irecv(comm, rb[rdispls[i]:rdispls[i] + rcounts[i]],
                    rcounts[i], dtype, src, recv_tag(i))
             for i, src in enumerate(ins)
             if src != PROC_NULL and rcounts[i]]
    sreqs = [_isend(comm, sb, count, dtype, dst, send_tag(i))
             for i, dst in enumerate(outs) if dst != PROC_NULL and count]
    return rreqs + sreqs


def neighbor_alltoallv_reqs(comm, sendbuf, recvbuf, dtype, scounts,
                            sdispls, rcounts, rdispls):
    """Per-out-neighbour send segments and per-in-neighbour receive
    segments, each by count and displacement in elements."""
    pvar.record("neighbor_alltoallv")
    topo = comm.topo
    ins = topo.in_neighbors(comm.rank)
    outs = topo.out_neighbors(comm.rank)
    send_tag, recv_tag = _nbr_tags(comm, topo)
    sb = np.asarray(sendbuf).reshape(-1)
    rb = np.asarray(recvbuf).reshape(-1)
    rreqs = [_irecv(comm, rb[rdispls[i]:rdispls[i] + rcounts[i]],
                    rcounts[i], dtype, src, recv_tag(i))
             for i, src in enumerate(ins)
             if src != PROC_NULL and rcounts[i]]
    sreqs = [_isend(comm, sb[sdispls[i]:sdispls[i] + scounts[i]],
                    scounts[i], dtype, dst, send_tag(i))
             for i, dst in enumerate(outs)
             if dst != PROC_NULL and scounts[i]]
    return rreqs + sreqs


def _wait_reqs(reqs) -> None:
    for q in reqs:
        q.wait()


def neighbor_allgather_linear(comm, sendbuf, recvbuf, count, dtype):
    _wait_reqs(neighbor_allgather_reqs(comm, sendbuf, recvbuf, count,
                                       dtype))


def neighbor_alltoall_linear(comm, sendbuf, recvbuf, count, dtype):
    _wait_reqs(neighbor_alltoall_reqs(comm, sendbuf, recvbuf, count,
                                      dtype))


def neighbor_allgatherv_linear(comm, sendbuf, recvbuf, count, dtype,
                               rcounts, rdispls):
    _wait_reqs(neighbor_allgatherv_reqs(comm, sendbuf, recvbuf, count,
                                        dtype, rcounts, rdispls))


def neighbor_alltoallv_linear(comm, sendbuf, recvbuf, dtype, scounts,
                              sdispls, rcounts, rdispls):
    _wait_reqs(neighbor_alltoallv_reqs(comm, sendbuf, recvbuf, dtype,
                                       scounts, sdispls, rcounts, rdispls))


class CollBasic(registry.Component):
    """The component comm_select ranks."""

    NAME = "basic"
    PRIORITY = 10  # the reference's basic level: below every other

    def query(self, comm) -> int:
        return self.PRIORITY

    def slots(self, comm):
        return {
            "barrier": barrier,
            "bcast": bcast_linear,
            "reduce": reduce_linear,
            "allreduce": allreduce_reduce_bcast,
            "gather": gather_linear,
            "gatherv": gatherv_linear,
            "scatter": scatter_linear,
            "scatterv": scatterv_linear,
            "allgather": allgather_gather_bcast,
            "allgatherv": allgatherv_linear,
            "alltoall": alltoall_pairwise_isend,
            "alltoallv": alltoallv_linear,
            "reduce_scatter": reduce_scatter_basic,
            "reduce_scatter_block": reduce_scatter_block_basic,
            "scan": scan_linear,
            "exscan": exscan_linear,
            "reduce_local": reduce_local,
            "bcast_obj": bcast_obj,
            "gather_obj": gather_obj,
            "scatter_obj": scatter_obj,
            "allgather_obj": allgather_obj,
            "alltoall_obj": alltoall_obj,
            "allreduce_obj": allreduce_obj,
            # the neighbourhood slots: topology comms only
            **({} if getattr(comm, "topo", None) is None else {
                "neighbor_allgather": neighbor_allgather_linear,
                "neighbor_alltoall": neighbor_alltoall_linear,
                "neighbor_allgatherv": neighbor_allgatherv_linear,
                "neighbor_alltoallv": neighbor_alltoallv_linear}),
        }
