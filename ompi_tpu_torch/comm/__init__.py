"""Groups and communicators.

Reference: ompi/group/ (set algebra over process lists) and
ompi/communicator/ (cid allocation, comm_cid.c:297-463; dup / Idup /
split / create), and the JAX package's ``ompi_tpu.comm`` (:25-290). A
communicator = (Group mapping comm rank -> world rank, cid, coll table,
attributes, info, errhandler, topology; info and errhandler inherited by
every comm built from it). ``topo`` is None until :mod:`ompi_tpu_torch.topo`
attaches a cartesian, graph or distributed-graph topology
(``Topo_test``); :mod:`ompi_tpu_torch.comm.intercomm` adds ``is_inter``,
``remote_group`` and ``Intercomm_merge``. Point-to-point traffic uses the pml context cid*2,
collectives cid*2+1. Construction agrees on a fresh cid (allocated by
``rte.next_id``, the store's atomic counter) over the pml's collective
context: rank 0 of the new communicator's parent allocates it and sends
it to the others, as the reference's ``_agree_cid`` does. The ULFM
methods (revoke, shrink, agree, ...) wait for ROADMAP queue 1 item 9.
MPI-4's :func:`comm_create_from_group` needs no parent: the members agree
on the cid through the store, keyed on (tag, group, epoch).
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from ompi_tpu_torch import attr as attr_mod, errors
from ompi_tpu_torch.info import Info, apply_memkinds, as_info
from ompi_tpu_torch.runtime import rte

UNDEFINED = -32766

#: pml tags of the construction rounds on the collective context
#: (negative: never matched by a wildcard, never used by coll/basic)
_TAG_GATHER, _TAG_SCATTER = -7, -8


class Group:
    """MPI_Group: an ordered set of world ranks. A group from a session's
    process set carries the session (``session``), and so does every
    group derived from it."""

    __slots__ = ("ranks", "_index", "session")

    def __init__(self, ranks: Sequence[int], session=None) -> None:
        self.ranks: Tuple[int, ...] = tuple(ranks)
        self._index = {r: i for i, r in enumerate(self.ranks)}
        self.session = session

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
        return Group(list(self.ranks) + extra, self.session)

    def intersection(self, other: "Group") -> "Group":
        return Group([r for r in self.ranks if r in other._index],
                     self.session)

    def difference(self, other: "Group") -> "Group":
        return Group([r for r in self.ranks if r not in other._index],
                     self.session)

    def incl(self, ranks: Sequence[int]) -> "Group":
        return Group([self.ranks[r] for r in ranks], self.session)

    def excl(self, ranks: Sequence[int]) -> "Group":
        drop = set(ranks)
        return Group([r for i, r in enumerate(self.ranks) if i not in drop],
                     self.session)

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

    def __init__(self, group: Group, cid: int,
                 errhandler=errors.ERRORS_ARE_FATAL) -> None:
        self.group = group
        self.cid = cid
        self.name = f"comm#{cid}"
        self.attrs: Dict[int, object] = {}
        self.info = Info()
        self.errhandler = errhandler
        self.coll = None  # installed by coll.comm_select
        self.topo = None  # a cart / graph / dist graph (topo/)
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

    def Topo_test(self) -> str:
        """MPI_Topo_test: 'cart', 'graph', 'dist_graph' or 'undefined'
        (ompi/mpi/c/topo_test.c)."""
        return "undefined" if self.topo is None else self.topo.kind

    def Is_inter(self) -> bool:
        """MPI_Comm_test_inter."""
        return bool(getattr(self, "is_inter", False))

    def Get_group(self) -> Group:
        """MPI_Comm_group: a new group over this comm's membership."""
        return Group(self.group.ranks)

    def set_name(self, name: str) -> None:
        self.name = name

    def get_name(self) -> str:
        return self.name

    def Set_info(self, info) -> None:
        """MPI_Comm_set_info (captured: later changes to ``info`` do not
        leak in); a ``mpi_memory_alloc_kinds`` request is answered with
        the granted subset (info_memkind.c)."""
        self.info = apply_memkinds(as_info(info))

    def Get_info(self) -> Info:
        """MPI_Comm_get_info: a new Info with the hints set."""
        return as_info(self.info)

    # -- construction (collective) ----------------------------------------
    def _derive(self, group: Group, cid: int) -> "Communicator":
        """A new communicator that inherits this one's info hints and
        errhandler."""
        c = Communicator(group, cid, self.errhandler)
        c.info = self.info.dup()
        return c

    def _materialize_dup(self, cid: int) -> "Communicator":
        """The construction tail dup and Idup share: the same group under
        ``cid``, info and errhandler inherited, attributes through their
        keyvals' copy callbacks; coll stacks on it as on any comm."""
        c = self._derive(Group(self.group.ranks), cid)
        if self.attrs:
            attr_mod.copy_attrs(self, c)
        return c

    def dup(self) -> "Communicator":
        """MPI_Comm_dup: the same group under a fresh cid."""
        return self._materialize_dup(self._agree_cid())

    def _sched_idup(self, out: dict):
        """Idup's rounds: rank 0 allocates the cid and sends it over the
        collective context on the comm's next collective tag; the
        construction runs at completion."""
        from ompi_tpu_torch import pml

        p = pml.current()
        tag = self.coll.next_tag()
        if self.rank == 0:
            cid = alloc_cid()
            yield [p.isend_obj(self, cid, d, tag, collective=True)
                   for d in range(1, self.size)]
        else:
            r = p.irecv_obj(self, 0, tag, collective=True)
            yield [r]
            if r.status.error:
                errors.raise_mpi_error(r.status.error,
                                       "idup: the cid did not arrive")
            cid = r._obj
        out["comm"] = self._materialize_dup(cid)

    def Idup(self):
        """MPI_Comm_idup (ompi/mpi/c/comm_idup.c): a nonblocking dup on
        coll/libnbc's progress engine; the new communicator is
        ``req.result["comm"]`` once the request completes."""
        from ompi_tpu_torch.coll import libnbc

        out: dict = {}
        req = libnbc.NbcRequest(self._sched_idup(out))
        req.result = out
        return req

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
        """MPI_Comm_free: attribute delete callbacks, then the two-level
        splits (coll/hier's and coll/device's grids: ``low`` then ``up``;
        coll/han's levels), then the device arenas (collective), then the
        cid leaves the registry."""
        if self.attrs:
            attr_mod.delete_attrs(self)
        from ompi_tpu_torch.coll import cuda as _coll_cuda
        from ompi_tpu_torch.parallel import hierarchical as _hier

        self.__dict__.pop("_coll_hier_plan", None)
        self.__dict__.pop("_coll_device_grid", None)
        _hier.release(self)
        levels = self.__dict__.pop("_han_levels", None)
        if levels is not None:
            levels.release()
        self.__dict__.pop("_han_colors", None)
        self.__dict__.pop("_coll_device_nbr_adj", None)
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


_cfg_epochs: Dict[str, int] = {}


def comm_create_from_group(group: Group,
                           tag: str) -> Optional[Communicator]:
    """MPI_Comm_create_from_group (the MPI-4 sessions path): no parent
    comm; the group's rank 0 allocates the cid and publishes it in the
    store under (tag, group, epoch), the other members read it. Members
    call in the same order per (tag, group), so a local epoch counter
    keeps repeated calls apart. Non-members get None."""
    if group.rank == UNDEFINED:
        return None
    base_key = f"cfg:{rte.jobid}:{tag}:{','.join(map(str, group.ranks))}"
    epoch = _cfg_epochs.get(base_key, 0)
    _cfg_epochs[base_key] = epoch + 1
    key = f"{base_key}:{epoch}"
    if group.rank == 0:
        cid = alloc_cid()
        rte.client().put(key, cid)
    else:
        cid = rte.client().get(key, wait=True)
    return Communicator(Group(group.ranks), cid)


def build_world() -> Tuple[Communicator, Communicator]:
    """COMM_WORLD (cid 0) + COMM_SELF (cid 1)."""
    rte.init()
    world = Communicator(Group(rte.world_ranks()), cid=0)
    world.set_name("MPI_COMM_WORLD")
    selfc = Communicator(Group([rte.rank]), cid=1)
    selfc.set_name("MPI_COMM_SELF")
    return world, selfc
