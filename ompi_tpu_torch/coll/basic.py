"""coll/basic — object allgather and barrier over the runtime store.

The reduced counterpart of ``ompi_tpu.coll.basic`` (the lowest priority,
stacked for every communicator, size 1 included): ``allgather_obj`` and
``barrier``, which the one-sided windows need (``osc``: peer info at
creation, descriptors at every fence). The reference runs them over the
pml's object channel (coll/basic.py:386 gathers to rank 0 and
broadcasts; :109 is the linear barrier). The port has no pml yet, so
they go through the rendezvous store, keyed by (jobid, cid, per-comm
sequence): every member calls a comm's collectives in the same order, so
the sequence agrees, and two comms (a window's private dup and its
parent, or two windows' dups) never read each other's keys. The pml
slice swaps the transport.
"""

from __future__ import annotations

from typing import Any, List

from ompi_tpu_torch.runtime import rte


def _key(comm, what: str) -> str:
    seq = comm.__dict__.get("_coll_basic_seq", 0) + 1
    comm._coll_basic_seq = seq
    return f"{what}:{rte.jobid}:{comm.cid}:{seq}"


def allgather_obj(comm, obj) -> List[Any]:
    """Every member's ``obj`` (picklable), in comm rank order."""
    if comm.size == 1:
        return [obj]
    key = _key(comm, "allgather_obj")
    store = rte.client()
    store.put(f"{key}:{comm.rank}", obj)
    return [obj if p == comm.rank else store.get(f"{key}:{p}")
            for p in range(comm.size)]


def barrier(comm) -> None:
    """Returns once every member has entered (a store fence)."""
    if comm.size > 1:
        rte.client().fence(_key(comm, "barrier"), comm.size, comm.rank)


class CollBasic:
    """The component comm_select ranks."""

    NAME = "basic"
    PRIORITY = 10  # the reference's basic level: below every device provider

    def query(self, comm) -> int:
        return self.PRIORITY

    def slots(self, comm):
        return {"allgather_obj": allgather_obj, "barrier": barrier}
