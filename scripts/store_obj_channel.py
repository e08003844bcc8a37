"""Run a port example with coll/basic's object collectives on the
rendezvous store instead of the pml: the transport coll/basic used before
it moved onto ob1's object channel, kept here to measure that move.

A rank program for the port's launcher: it replaces ``allgather_obj``,
``bcast_obj`` and ``barrier`` in coll/basic's slots (and coll/tuned's
``barrier``, which stacks above them) with store-keyed versions ((jobid,
cid, per-comm sequence) keys, a store fence for the barrier), then runs
the example's ``main`` with the remaining arguments. Run the embedding
path under it and without it, in turns, to compare the fence times.

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        --mca osc_cuda on scripts/store_obj_channel.py embedding_table \\
        --out DIR
"""

from __future__ import annotations

import importlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ompi_tpu_torch.coll import basic, tuned  # noqa: E402
from ompi_tpu_torch.runtime import rte  # noqa: E402


def _key(comm, what: str) -> str:
    seq = comm.__dict__.get("_store_obj_seq", 0) + 1
    comm._store_obj_seq = seq
    return f"{what}:{rte.jobid}:{comm.cid}:{seq}"


def allgather_obj(comm, obj):
    if comm.size == 1:
        return [obj]
    key = _key(comm, "allgather_obj")
    store = rte.client()
    store.put(f"{key}:{comm.rank}", obj)
    return [obj if p == comm.rank else store.get(f"{key}:{p}")
            for p in range(comm.size)]


def bcast_obj(comm, obj, root: int = 0):
    if comm.size == 1:
        return obj
    key = _key(comm, "bcast_obj")
    if comm.rank == root:
        rte.client().put(key, obj)
        return obj
    return rte.client().get(key)


def barrier(comm) -> None:
    if comm.size > 1:
        rte.client().fence(_key(comm, "barrier"), comm.size, comm.rank)


def _slots(self, comm):
    slots = _pml_slots(self, comm)
    slots.update(allgather_obj=allgather_obj, bcast_obj=bcast_obj,
                 barrier=barrier)
    return slots


def _tuned_slots(self, comm):
    slots = _tuned_pml_slots(self, comm)
    slots["barrier"] = barrier
    return slots


_pml_slots = basic.CollBasic.slots
basic.CollBasic.slots = _slots
_tuned_pml_slots = tuned.CollTuned.slots
tuned.CollTuned.slots = _tuned_slots

if __name__ == "__main__":
    example = importlib.import_module(
        f"ompi_tpu_torch.examples.{sys.argv[1]}")
    raise SystemExit(example.main(sys.argv[2:]))
