"""Groups and communicators.

Reference: ompi/group/ and ompi/communicator/, and the JAX package's
``ompi_tpu.comm``. A communicator = (Group mapping comm rank -> world
rank, cid, coll table). This slice builds COMM_WORLD and
COMM_SELF; dup/split come with the pml slice, which also brings host
point-to-point and host collectives.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from ompi_tpu_torch.runtime import rte

UNDEFINED = -32766


class Group:
    """MPI_Group: an ordered set of world ranks."""

    __slots__ = ("ranks", "_index")

    def __init__(self, ranks: Sequence[int]) -> None:
        self.ranks: Tuple[int, ...] = tuple(ranks)
        self._index = {r: i for i, r in enumerate(self.ranks)}

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def rank(self) -> int:
        """This process's rank in the group (UNDEFINED if absent)."""
        return self._index.get(rte.rank, UNDEFINED)

    def __repr__(self) -> str:
        return f"Group({list(self.ranks)})"


class Communicator:
    """Group + cid + per-comm collective table. The API methods
    (Allreduce, ...) are attached by :mod:`ompi_tpu_torch.mpi`."""

    def __init__(self, group: Group, cid: int) -> None:
        self.group = group
        self.cid = cid
        self.name = f"comm#{cid}"
        self.coll = None  # installed by coll.comm_select
        from ompi_tpu_torch.coll import comm_select

        comm_select(self)

    @property
    def rank(self) -> int:
        return self.group.rank

    @property
    def size(self) -> int:
        return self.group.size

    def set_name(self, name: str) -> None:
        self.name = name

    def free(self) -> None:
        """Release the comm's device arenas (collective)."""
        from ompi_tpu_torch.coll import cuda as _coll_cuda

        _coll_cuda.release(self)

    def __repr__(self) -> str:
        return (f"Communicator({self.name}, rank={self.rank}/"
                f"{self.size}, cid={self.cid})")


def build_world() -> Tuple[Communicator, Communicator]:
    """COMM_WORLD (cid 0) + COMM_SELF (cid 1)."""
    rte.init()
    world = Communicator(Group(rte.world_ranks()), cid=0)
    world.set_name("MPI_COMM_WORLD")
    selfc = Communicator(Group([rte.rank]), cid=1)
    selfc.set_name("MPI_COMM_SELF")
    return world, selfc
