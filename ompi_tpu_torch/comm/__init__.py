"""Groups and communicators.

Reference: ompi/group/ (set algebra over process lists) and
ompi/communicator/ (cid allocation, comm_cid.c:297-463; dup / split /
create), and the JAX package's ``ompi_tpu.comm`` (:25-290). A
communicator = (Group mapping comm rank -> world rank, cid, coll table,
attributes, info). Point-to-point traffic uses the pml context cid*2,
collectives cid*2+1. Construction agrees on a fresh cid (allocated by
``rte.next_id``, the store's atomic counter) over the pml's collective
context: rank 0 of the new communicator's parent allocates it and sends
it to the others, as the reference's ``_agree_cid`` does. The ULFM
methods (revoke, shrink, agree, ...) wait for ROADMAP queue 1 item 9.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from ompi_tpu_torch import attr as attr_mod
from ompi_tpu_torch.info import Info, as_info
from ompi_tpu_torch.runtime import rte

UNDEFINED = -32766

#: pml tags of the construction rounds on the collective context
#: (negative: never matched by a wildcard, never used by coll/basic)
_TAG_GATHER, _TAG_SCATTER = -7, -8


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

    def translate(self, rank: int, other: "Group") -> int:
        """MPI_Group_translate_ranks for one rank."""
        return other._index.get(self.ranks[rank], UNDEFINED)

    def union(self, other: "Group") -> "Group":
        extra = [r for r in other.ranks if r not in self._index]
        return Group(list(self.ranks) + extra)

    def intersection(self, other: "Group") -> "Group":
        return Group([r for r in self.ranks if r in other._index])

    def difference(self, other: "Group") -> "Group":
        return Group([r for r in self.ranks if r not in other._index])

    def incl(self, ranks: Sequence[int]) -> "Group":
        return Group([self.ranks[r] for r in ranks])

    def excl(self, ranks: Sequence[int]) -> "Group":
        drop = set(ranks)
        return Group([r for i, r in enumerate(self.ranks) if i not in drop])

    def range_incl(self, ranges) -> "Group":
        out: List[int] = []
        for first, last, stride in ranges:
            out.extend(range(first, last + (1 if stride > 0 else -1),
                             stride))
        return self.incl(out)

    def compare(self, other: "Group") -> str:
        if self.ranks == other.ranks:
            return "ident"
        if set(self.ranks) == set(other.ranks):
            return "similar"
        return "unequal"

    def __repr__(self) -> str:
        return f"Group({list(self.ranks)})"


_comms: Dict[int, "Communicator"] = {}
_comms_lock = threading.Lock()


def lookup_cid(cid: int) -> Optional["Communicator"]:
    return _comms.get(cid)


class Communicator(attr_mod.AttrHost):
    """Group + cid + per-comm collective table. The API methods (Send,
    Allreduce, ...) are attached by :mod:`ompi_tpu_torch.mpi`."""

    def __init__(self, group: Group, cid: int) -> None:
        self.group = group
        self.cid = cid
        self.name = f"comm#{cid}"
        self.attrs: Dict[int, object] = {}
        self.info = Info()
        self.coll = None  # installed by coll.comm_select
        with _comms_lock:
            _comms[cid] = self
        from ompi_tpu_torch.coll import comm_select

        comm_select(self)
        # replay frames peers sent before this comm existed here
        from ompi_tpu_torch import pml

        if pml.instance() is not None:
            pml.current().comm_registered(cid)

    # -- identity ---------------------------------------------------------
    @property
    def rank(self) -> int:
        return self.group.rank

    @property
    def size(self) -> int:
        return self.group.size

    def world_rank(self, rank: int) -> int:
        """comm rank -> world (job) rank."""
        return self.group.ranks[rank]

    def comm_rank_of_world(self, world: int) -> int:
        return self.group._index.get(world, UNDEFINED)

    def Get_group(self) -> Group:
        """MPI_Comm_group: a new group over this comm's membership."""
        return Group(self.group.ranks)

    def set_name(self, name: str) -> None:
        self.name = name

    def get_name(self) -> str:
        return self.name

    def Set_info(self, info) -> None:
        """MPI_Comm_set_info (captured: later changes to ``info`` do not
        leak in)."""
        self.info = as_info(info)

    def Get_info(self) -> Info:
        """MPI_Comm_get_info: a new Info with the hints set."""
        return as_info(self.info)

    # -- construction (collective) ----------------------------------------
    def _derive(self, group: Group, cid: int) -> "Communicator":
        """A new communicator that inherits this one's info hints."""
        c = Communicator(group, cid)
        c.info = self.info.dup()
        return c

    def dup(self) -> "Communicator":
        """MPI_Comm_dup: the same group under a fresh cid; attributes
        propagate through their keyvals' copy callbacks."""
        c = self._derive(Group(self.group.ranks), self._agree_cid())
        if self.attrs:
            attr_mod.copy_attrs(self, c)
        return c

    def split(self, color: int, key: int = 0) -> Optional["Communicator"]:
        """MPI_Comm_split: rank 0 gathers every (color, key, world rank),
        forms the groups (ordered by key, then world rank), allocates a
        cid per colour and sends each member its plan. UNDEFINED gets
        None."""
        triples = self._gather_obj((color, key, rte.rank))
        plans = None
        if self.rank == 0:
            groups: Dict[int, List[Tuple]] = {}
            for t in triples:
                if t[0] != UNDEFINED:
                    groups.setdefault(t[0], []).append(t)
            by_world = {}
            for members in groups.values():
                members.sort(key=lambda t: (t[1], t[2]))
                ranks = [t[2] for t in members]
                cid = alloc_cid()
                for t in members:
                    by_world[t[2]] = (ranks, cid)
            plans = [by_world.get(t[2]) for t in triples]
        mine = self._scatter_obj(plans)
        if mine is None:
            return None
        ranks, cid = mine
        return self._derive(Group(ranks), cid)

    def split_type(self, split_type: str = "shared",
                   key: int = 0) -> Optional["Communicator"]:
        """MPI_Comm_split_type(MPI_COMM_TYPE_SHARED): colour by host."""
        if split_type != "shared":
            from ompi_tpu_torch import errors

            raise errors.MPIError(errors.ERR_ARG,
                                  f"split_type {split_type!r}: only "
                                  "'shared' is known")
        # a stable digest: Python's hash() is salted per process
        color = int.from_bytes(hashlib.sha1(
            rte.hostname().encode()).digest()[:4], "little") & 0x7FFFFFFF
        return self.split(color, key)

    def create(self, group: Group) -> Optional["Communicator"]:
        """MPI_Comm_create (collective over this comm): members of
        ``group`` get a communicator in the group's order, the others
        None."""
        member = group.rank != UNDEFINED
        return self.split(0 if member else UNDEFINED,
                          key=group.rank if member else 0)

    def create_group(self, group: Group,
                     tag: int = 0) -> Optional["Communicator"]:
        """MPI_Comm_create_group: collective over the members of
        ``group`` only; the group's rank 0 allocates the cid and sends it
        to the other members over this comm's collective context, on a
        tag of its own per ``tag``."""
        if group.rank == UNDEFINED:
            return None
        from ompi_tpu_torch import pml

        p = pml.current()
        ptag = -1000 - int(tag)
        if group.rank == 0:
            cid = alloc_cid()
            reqs = [p.isend_obj(self, cid, self.comm_rank_of_world(w),
                                ptag, collective=True)
                    for w in group.ranks[1:]]
            for r in reqs:
                r.wait()
        else:
            cid = p.recv_obj(self, self.comm_rank_of_world(group.ranks[0]),
                             ptag, collective=True)
        return self._derive(Group(group.ranks), cid)

    def free(self) -> None:
        """MPI_Comm_free: attribute delete callbacks, then the device
        arenas (collective), then the cid leaves the registry."""
        if self.attrs:
            attr_mod.delete_attrs(self)
        from ompi_tpu_torch.coll import cuda as _coll_cuda

        _coll_cuda.release(self)
        with _comms_lock:
            if _comms.get(self.cid) is self:
                del _comms[self.cid]

    # -- the construction rounds over the pml ----------------------------
    def _gather_obj(self, obj):
        from ompi_tpu_torch import pml

        p = pml.current()
        if self.rank != 0:
            p.send_obj(self, obj, 0, _TAG_GATHER, collective=True)
            return None
        reqs = [p.irecv_obj(self, r, _TAG_GATHER, collective=True)
                for r in range(1, self.size)]
        out = [obj]
        for req in reqs:
            req.wait()
            out.append(req._obj)
        return out

    def _scatter_obj(self, objs):
        from ompi_tpu_torch import pml

        p = pml.current()
        if self.rank != 0:
            return p.recv_obj(self, 0, _TAG_SCATTER, collective=True)
        reqs = [p.isend_obj(self, objs[r], r, _TAG_SCATTER, collective=True)
                for r in range(1, self.size)]
        for r in reqs:
            r.wait()
        return objs[0]

    def _agree_cid(self) -> int:
        """Every member learns one fresh cid: rank 0 allocates it."""
        if self.rank == 0:
            cid = alloc_cid()
            return self._scatter_obj([cid] * self.size)
        return self._scatter_obj(None)

    def __repr__(self) -> str:
        return (f"Communicator({self.name}, rank={self.rank}/"
                f"{self.size}, cid={self.cid})")


def alloc_cid() -> int:
    """A job-unique communicator id (the store's atomic counter); 0 and
    1 are COMM_WORLD and COMM_SELF."""
    return 1 + rte.next_id("cid")


def build_world() -> Tuple[Communicator, Communicator]:
    """COMM_WORLD (cid 0) + COMM_SELF (cid 1)."""
    rte.init()
    world = Communicator(Group(rte.world_ranks()), cid=0)
    world.set_name("MPI_COMM_WORLD")
    selfc = Communicator(Group([rte.rank]), cid=1)
    selfc.set_name("MPI_COMM_SELF")
    return world, selfc
