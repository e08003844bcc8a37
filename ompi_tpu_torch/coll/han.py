"""coll/han — two-level host collectives.

The port of :mod:`ompi_tpu.coll.han`. Reference: ompi/mca/coll/han/
coll_han.h:22-33,62-63 — split each communicator into an intra-node
``low`` communicator and an inter-node ``up`` communicator of node
leaders, then compose per-level algorithms so inter-node traffic is one
message per node instead of one per rank. The reference's default
priority is 35, above coll/tuned.

Host (numpy) buffers only: device tensors take coll/hier and coll/device.
The sub-communicators are built lazily on the first collective (han's
comm_create on first use), which is safe because every member reaches
that collective together, and freed with the parent
(``Communicator.free``). Testing aid: ``coll_han_split=modulo:K`` fakes K
nodes on one host.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ompi_tpu_torch.coll import basic
from ompi_tpu_torch.core import cvar, pvar, registry

_IN_PLACE = basic.IN_PLACE

_split_var = cvar.register(
    "coll_han_split", "auto", str,
    help="Node-split strategy: 'auto' (by hostname), 'modulo:K' "
         "(fake K nodes for single-host testing), 'off'.", level=6)
_prio_var = cvar.register(
    "coll_han_priority", 35, int,
    help="coll/han selection priority (reference default 35, above "
         "tuned).", level=6)


def _node_color(comm) -> int:
    spec = _split_var.get()
    if spec.startswith("modulo:"):
        k = max(1, int(spec.split(":", 1)[1]))
        # contiguous blocks of ranks pretend to share a node
        per = -(-comm.size // k)
        return comm.rank // per
    from ompi_tpu_torch.runtime import rte

    host = rte.hostname()
    return int.from_bytes(
        hashlib.sha1(host.encode()).digest()[:4], "little") & 0x7FFFFFFF


class _Levels:
    """low = my node's ranks; up = node leaders (None if not one)."""

    def __init__(self, comm) -> None:
        from ompi_tpu_torch.comm import UNDEFINED

        color = _node_color(comm)
        self.low = comm.split(color, key=comm.rank)
        is_leader = self.low.rank == 0
        self.up = comm.split(0 if is_leader else UNDEFINED, key=comm.rank)
        # which comm rank leads my node
        self.leader_commrank = self.low.coll.bcast_obj(
            self.low, comm.rank if is_leader else None, 0)

    def release(self) -> None:
        """Free both sub-communicators (the parent's free calls it)."""
        for sub in (self.low, self.up):
            if sub is not None:
                sub.free()
        self.low = None
        self.up = None


def _levels(comm) -> _Levels:
    lv = comm.__dict__.get("_han_levels")
    if lv is None:
        lv = _Levels(comm)
        comm._han_levels = lv
    return lv


class CollHan(registry.Component):
    """The component comm_select ranks."""

    NAME = "han"

    def query(self, comm) -> int:
        spec = _split_var.get()
        if spec == "off" or comm.size < 4:
            return -1
        if spec == "auto":
            # a single-host job: every rank on one node, the hierarchy is
            # pure overhead (the reference's one-node check)
            return -1 if _single_node() else _prio_var.get()
        return _prio_var.get()

    def slots(self, comm):
        return {
            "barrier": barrier_han,
            "bcast": bcast_han,
            "reduce": reduce_han,
            "allreduce": allreduce_han,
            "allgather": allgather_han,
        }


def _single_node() -> bool:
    # every rank of this job shares local_size == size (launcher contract)
    from ompi_tpu_torch.runtime import rte

    return rte.local_size >= rte.size


# -- the two-level compositions (coll_han_*_intra) --------------------------

def allreduce_han(comm, sendbuf, recvbuf, count, dtype, op):
    """low reduce -> up allreduce among leaders -> low bcast
    (coll_han_allreduce.c's default composition)."""
    pvar.record("han_allreduce")
    lv = _levels(comm)
    if sendbuf is _IN_PLACE:
        # materialise: a comm-level IN_PLACE would confuse the low reduce
        # when the comm root is not the low root
        sendbuf = np.array(recvbuf, copy=True)
    lv.low.coll.reduce(lv.low, sendbuf, recvbuf, count, dtype, op, 0)
    if lv.up is not None:
        tmp = np.array(recvbuf, copy=True)
        lv.up.coll.allreduce(lv.up, tmp, recvbuf, count, dtype, op)
    lv.low.coll.bcast(lv.low, recvbuf, count, dtype, 0)


def reduce_han(comm, sendbuf, recvbuf, count, dtype, op, root):
    """low reduce to node leaders -> up reduce to the root's leader ->
    one hop to the root when it is not a leader."""
    pvar.record("han_reduce")
    lv = _levels(comm)
    tag = basic._tag(comm)  # every member draws it: the sequence agrees
    if sendbuf is _IN_PLACE:  # only legal at the root, which has recvbuf
        sendbuf = np.array(recvbuf, copy=True)
    tmp = np.empty_like(np.asarray(sendbuf))
    lv.low.coll.reduce(lv.low, sendbuf, tmp, count, dtype, op, 0)
    root_leader = _leader_of(comm, root)
    if lv.up is not None:
        up_root = _up_rank_of(comm, root_leader)
        lv.up.coll.reduce(lv.up, np.array(tmp, copy=True), tmp, count,
                          dtype, op, up_root)
    if comm.rank == root_leader and root != root_leader:
        basic._send(comm, tmp, count, dtype, root, tag)
    if comm.rank == root:
        if root == root_leader:
            np.copyto(np.asarray(recvbuf), tmp)
        else:
            basic._recv(comm, recvbuf, count, dtype, root_leader, tag)


def bcast_han(comm, buf, count, dtype, root):
    """root -> its leader -> up bcast -> low bcast."""
    pvar.record("han_bcast")
    lv = _levels(comm)
    tag = basic._tag(comm)
    root_leader = _leader_of(comm, root)
    if comm.rank == root and root != root_leader:
        basic._send(comm, buf, count, dtype, root_leader, tag)
    if comm.rank == root_leader and root != root_leader:
        basic._recv(comm, buf, count, dtype, root, tag)
    if lv.up is not None:
        lv.up.coll.bcast(lv.up, buf, count, dtype,
                         _up_rank_of(comm, root_leader))
    lv.low.coll.bcast(lv.low, buf, count, dtype, 0)


def barrier_han(comm):
    pvar.record("han_barrier")
    lv = _levels(comm)
    # gather at the leaders, leaders rendezvous, release
    lv.low.coll.barrier(lv.low)
    if lv.up is not None:
        lv.up.coll.barrier(lv.up)
    lv.low.coll.barrier(lv.low)


def allgather_han(comm, sendbuf, recvbuf, count, dtype):
    """low gather -> up allgather of the node blocks -> low bcast, the
    node blocks placed in comm rank order."""
    pvar.record("han_allgather")
    lv = _levels(comm)
    if sendbuf is _IN_PLACE:  # my block already sits in recvbuf
        flat = np.asarray(recvbuf).reshape(comm.size, -1)
        sendbuf = np.array(flat[comm.rank], copy=True)
    send = np.asarray(sendbuf)
    n = send.size
    low_buf = (np.empty(n * lv.low.size, dtype=send.dtype)
               if lv.low.rank == 0 else None)
    lv.low.coll.gather(lv.low, send, low_buf, n, dtype, 0)
    full = np.asarray(recvbuf).reshape(-1)
    if lv.up is not None:
        # leaders exchange (node ranks, block) and place by comm rank
        pieces = lv.up.coll.allgather_obj(
            lv.up, (_low_commranks(comm), low_buf))
        for ranks, block in pieces:
            block = np.asarray(block).reshape(len(ranks), -1)
            for i, r in enumerate(ranks):
                full[r * n:(r + 1) * n] = block[i].view(send.dtype)
    lv.low.coll.bcast(lv.low, full, full.size, dtype, 0)
    np.asarray(recvbuf).reshape(-1)[:] = full


# -- helpers ----------------------------------------------------------------

def _leader_of(comm, rank: int) -> int:
    """Comm rank of ``rank``'s node leader: the lowest comm rank with the
    same node colour."""
    colors = _color_table(comm)
    c = colors[rank]
    return min(i for i, col in enumerate(colors) if col == c)


def _up_rank_of(comm, leader_commrank: int) -> int:
    """Rank within ``up`` of a leader, from the colour order."""
    colors = _color_table(comm)
    leaders = sorted(min(i for i, c in enumerate(colors) if c == col)
                     for col in sorted(set(colors)))
    return leaders.index(leader_commrank)


def _color_table(comm):
    tbl = comm.__dict__.get("_han_colors")
    if tbl is None:
        spec = _split_var.get()
        if spec.startswith("modulo:"):
            k = max(1, int(spec.split(":", 1)[1]))
            per = -(-comm.size // k)
            tbl = [r // per for r in range(comm.size)]
        else:  # by hostname: one exchange
            tbl = comm.coll.allgather_obj(comm, _node_color(comm))
        comm._han_colors = tbl
    return tbl


def _low_commranks(comm):
    """Comm ranks of my node, in low rank order."""
    colors = _color_table(comm)
    mine = colors[comm.rank]
    return [i for i, c in enumerate(colors) if c == mine]
