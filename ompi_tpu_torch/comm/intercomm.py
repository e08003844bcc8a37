"""Intercommunicators and connect / accept over the store.

The port's copy of ``ompi_tpu.comm.intercomm`` (reference:
ompi/communicator/comm.c, intercomm create and merge; ompi/mca/coll/inter
and coll/basic's inter algorithms; ompi/dpm/dpm.c:386, the connect /
accept rendezvous, here through the job's store in place of PMIx
publish / lookup).

An intercommunicator binds a local group and a remote group under one
cid: point-to-point ranks address the remote group, and the collectives
(:mod:`ompi_tpu_torch.coll.inter`, the only coll component that stacks on
one) give each side the other side's contribution. A private intracomm
over the local group (``local_comm``, the reference's ``c_local_comm``)
carries their local phases.

Connect / accept pairs any two disjoint sets of world ranks that share a
job's store: the ranks of one launcher job, or a parent job and the
children it spawned (:mod:`ompi_tpu_torch.dpm`).
"""

from __future__ import annotations

from typing import Optional

from ompi_tpu_torch import errors
from ompi_tpu_torch.comm import (Communicator, Group, alloc_cid,
                                 comm_create_from_group)
from ompi_tpu_torch.runtime import rte

#: MPI_ROOT: the root argument of the rooted inter collectives at the root
ROOT = -4

#: pml tags of the leaders' exchanges (negative: no wildcard matches them)
_TAG_MERGE = -21


class Intercommunicator(Communicator):
    """A communicator with distinct local and remote groups."""

    is_inter = True

    def __init__(self, local_group: Group, remote_group: Group,
                 cid: int, errhandler=errors.ERRORS_ARE_FATAL) -> None:
        if set(local_group.ranks) & set(remote_group.ranks):
            raise errors.MPIError(
                errors.ERR_COMM,
                "intercommunicator groups must be disjoint: "
                f"{list(local_group.ranks)} and {list(remote_group.ranks)}")
        # comm_select (in Communicator.__init__) may read the remote group
        self.remote_group = remote_group
        super().__init__(local_group, cid, errhandler)
        self.name = f"intercomm#{cid}"
        self.local_comm = comm_create_from_group(local_group,
                                                 tag=f"icl:{cid}")

    @property
    def remote_size(self) -> int:
        return self.remote_group.size

    def world_rank(self, rank: int) -> int:
        """Point-to-point ranks index the remote group."""
        return self.remote_group.ranks[rank]

    def merge(self, high: bool = False) -> Communicator:
        """MPI_Intercomm_merge: the union intracomm, the low side's ranks
        first; when both sides give the same ``high``, the side holding
        the smallest world rank goes first."""
        flags = self.local_comm.allgather(bool(high))
        my_high = flags[0]
        their_high = None
        if self.rank == 0:
            their_high = self.sendrecv(my_high, dest=0, source=0,
                                       sendtag=_TAG_MERGE,
                                       recvtag=_TAG_MERGE)
        their_high = self.local_comm.bcast(their_high, root=0)
        mine, theirs = list(self.group.ranks), list(self.remote_group.ranks)
        if my_high == their_high:
            first = mine if min(mine) < min(theirs) else theirs
        else:
            first = theirs if my_high else mine
        second = theirs if first is mine else mine
        return comm_create_from_group(Group(first + second),
                                      tag=f"imerge:{self.cid}")


def intercomm_create(local_comm: Communicator, local_leader: int,
                     peer_comm: Communicator, remote_leader: int,
                     tag: int = 0) -> Intercommunicator:
    """MPI_Intercomm_create: the leaders swap their groups over
    ``peer_comm``, the one whose group holds the smaller world rank
    allocates the cid, and each leader broadcasts both to its side
    (comm.c ompi_intercomm_create)."""
    data = None
    if local_comm.rank == local_leader:
        mine = list(local_comm.group.ranks)
        other = peer_comm.sendrecv(mine, dest=remote_leader,
                                   source=remote_leader, sendtag=tag,
                                   recvtag=tag)
        if min(mine) < min(other):
            cid = alloc_cid()
            peer_comm.send(cid, remote_leader, tag)
        else:
            cid = peer_comm.recv(source=remote_leader, tag=tag)
        data = (other, cid)
    other, cid = local_comm.bcast(data, root=local_leader)
    return Intercommunicator(Group(local_comm.group.ranks), Group(other),
                             cid)


def open_port(name: Optional[str] = None) -> str:
    """MPI_Open_port: a rendezvous name unique in the job's store."""
    if name is None:
        name = f"port:{rte.jobid}:{rte.next_id('port')}"
    return name


def _port_rendezvous(port: str, comm: Communicator, root: int,
                     side: str) -> Intercommunicator:
    """Each side's root publishes its group under its side's key and
    waits for the other's; the accept side allocates the cid."""
    data = None
    if comm.rank == root:
        client = rte.client()
        client.put(f"{port}:{side}", list(comm.group.ranks))
        other_side = "connect" if side == "accept" else "accept"
        other = client.get(f"{port}:{other_side}", wait=True)
        if side == "accept":
            cid = alloc_cid()
            client.put(f"{port}:cid", cid)
        else:
            cid = client.get(f"{port}:cid", wait=True)
        data = (other, cid)
    other, cid = comm.bcast(data, root=root)
    return Intercommunicator(Group(comm.group.ranks), Group(other), cid)


def comm_accept(port: str, comm: Communicator,
                root: int = 0) -> Intercommunicator:
    """MPI_Comm_accept (collective over ``comm``)."""
    return _port_rendezvous(port, comm, root, "accept")


def comm_connect(port: str, comm: Communicator,
                 root: int = 0) -> Intercommunicator:
    """MPI_Comm_connect (collective over ``comm``)."""
    return _port_rendezvous(port, comm, root, "connect")


def _attach() -> None:
    Communicator.is_inter = False
    Communicator.remote_group = None
    Communicator.Intercomm_merge = lambda self, high=False: self.merge(high)


_attach()
