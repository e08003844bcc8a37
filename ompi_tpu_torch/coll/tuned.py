"""coll/tuned — the decision layer over the base algorithm library.

The port's copy of ``ompi_tpu.coll.tuned`` (coll/tuned.py:20-200;
reference: ompi/mca/coll/tuned, coll_tuned_decision_fixed.c:55-160):
fixed decision rules keyed on the communicator's size and the message's
bytes, and forced-algorithm cvars (``coll_tuned_<coll>_algorithm``) for
A/B checks, read at each call, so one job can step through the
algorithms with ``cvar.set``. The switchpoints are the reference's
figures (``coll_tuned_small_msg``, ``coll_tuned_bcast_pipeline_min``,
``coll_tuned_bcast_segsize``, ``coll_tuned_allreduce_ring_min``).
Priority 30; a one-rank comm disqualifies it, so coll/basic serves
there.
"""

from __future__ import annotations

from ompi_tpu_torch.coll import base_algos as A
from ompi_tpu_torch.coll import basic as B
from ompi_tpu_torch.core import cvar, registry

_force_allreduce = cvar.register(
    "coll_tuned_allreduce_algorithm", "", str,
    help="Force: recursivedoubling|ring|rabenseifner|basic",
    choices=["", "recursivedoubling", "ring", "rabenseifner", "basic"])
_force_bcast = cvar.register(
    "coll_tuned_bcast_algorithm", "", str,
    help="Force: linear|binomial|pipeline",
    choices=["", "linear", "binomial", "pipeline"])
_force_allgather = cvar.register(
    "coll_tuned_allgather_algorithm", "", str,
    help="Force: ring|bruck|recursivedoubling|basic",
    choices=["", "ring", "bruck", "recursivedoubling", "basic"])
_force_alltoall = cvar.register(
    "coll_tuned_alltoall_algorithm", "", str,
    help="Force: pairwise|bruck|basic",
    choices=["", "pairwise", "bruck", "basic"])
_force_barrier = cvar.register(
    "coll_tuned_barrier_algorithm", "", str,
    help="Force: recursivedoubling|bruck|linear",
    choices=["", "recursivedoubling", "bruck", "linear"])

_small = cvar.register(
    "coll_tuned_small_msg", 16384, int,
    help="Bytes below which latency-optimal algorithms are used "
         "(reference switchpoint shape, decision_fixed.c)")
_pipeline_min = cvar.register(
    "coll_tuned_bcast_pipeline_min", 64 << 20, int,
    help="Bytes above which bcast switches to the segmented pipeline. "
         "High default (the reference's): with smsc single copy a "
         "binomial hop moves the whole payload in one copy, so "
         "segmentation only pays on streaming fabrics; lower it when "
         "smsc is off")
_bcast_segsize = cvar.register(
    "coll_tuned_bcast_segsize", 1 << 20, int,
    help="Pipeline bcast segment bytes (the segsize params of "
         "coll_base_bcast.c); 16x the C library's default, as a Python "
         "segment costs far more than a C one")
_ring_min = cvar.register(
    "coll_tuned_allreduce_ring_min", 2 << 20, int,
    help="Total bytes at and above which a commutative allreduce on "
         "more than 2 ranks takes the bandwidth-optimal ring; below it, "
         "recursive doubling. Rabenseifner is forced-only")


def _bytes(count, dtype) -> int:
    return count * (dtype.size if dtype is not None else 1)


def allreduce_tuned(comm, sendbuf, recvbuf, count, dtype, op):
    forced = _force_allreduce.get()
    if forced == "basic":
        return B.allreduce_reduce_bcast(comm, sendbuf, recvbuf, count,
                                        dtype, op)
    if forced == "recursivedoubling":
        return A.allreduce_recursivedoubling(comm, sendbuf, recvbuf,
                                             count, dtype, op)
    if forced == "ring":
        return A.allreduce_ring(comm, sendbuf, recvbuf, count, dtype, op)
    if forced == "rabenseifner":
        return A.allreduce_rabenseifner(comm, sendbuf, recvbuf, count,
                                        dtype, op)
    total = _bytes(count, dtype)
    if (op.commute and comm.size > 2 and count >= comm.size
            and total >= _ring_min.get()):
        # bandwidth-bound (decision_fixed.c's large-message branch)
        return A.allreduce_ring(comm, sendbuf, recvbuf, count, dtype, op)
    return A.allreduce_recursivedoubling(comm, sendbuf, recvbuf, count,
                                         dtype, op)


def bcast_tuned(comm, buf, count, dtype, root):
    forced = _force_bcast.get()
    if forced == "linear":
        return B.bcast_linear(comm, buf, count, dtype, root)
    if forced == "binomial":
        return A.bcast_binomial(comm, buf, count, dtype, root)
    if forced == "pipeline":
        return A.bcast_pipeline(comm, buf, count, dtype, root,
                                segsize=_bcast_segsize.get())
    if _bytes(count, dtype) >= _pipeline_min.get() and comm.size > 2:
        return A.bcast_pipeline(comm, buf, count, dtype, root,
                                segsize=_bcast_segsize.get())
    return A.bcast_binomial(comm, buf, count, dtype, root)


def allgather_tuned(comm, sendbuf, recvbuf, count, dtype):
    forced = _force_allgather.get()
    if forced == "basic":
        return B.allgather_gather_bcast(comm, sendbuf, recvbuf, count,
                                        dtype)
    if forced == "ring":
        return A.allgather_ring(comm, sendbuf, recvbuf, count, dtype)
    if forced == "bruck":
        return A.allgather_bruck(comm, sendbuf, recvbuf, count, dtype)
    if forced == "recursivedoubling":
        return A.allgather_recursivedoubling(comm, sendbuf, recvbuf,
                                             count, dtype)
    if _bytes(count, dtype) <= _small.get():
        return A.allgather_bruck(comm, sendbuf, recvbuf, count, dtype)
    if comm.size & (comm.size - 1) == 0:
        # a power of two: log p rounds instead of the ring's p - 1, for
        # the same bytes (the per-round cost dominates a Python plane)
        return A.allgather_recursivedoubling(comm, sendbuf, recvbuf,
                                             count, dtype)
    return A.allgather_ring(comm, sendbuf, recvbuf, count, dtype)


def alltoall_tuned(comm, sendbuf, recvbuf, count, dtype):
    forced = _force_alltoall.get()
    if forced == "basic":
        return B.alltoall_pairwise_isend(comm, sendbuf, recvbuf, count,
                                         dtype)
    if forced == "pairwise":
        return A.alltoall_pairwise(comm, sendbuf, recvbuf, count, dtype)
    if forced == "bruck":
        return A.alltoall_bruck(comm, sendbuf, recvbuf, count, dtype)
    if _bytes(count, dtype) <= 256 and comm.size >= 8:
        return A.alltoall_bruck(comm, sendbuf, recvbuf, count, dtype)
    return A.alltoall_pairwise(comm, sendbuf, recvbuf, count, dtype)


def barrier_tuned(comm):
    forced = _force_barrier.get()
    if forced == "linear":
        return B.barrier(comm)
    if forced == "bruck":
        return A.barrier_bruck(comm)
    if forced == "recursivedoubling":
        return A.barrier_recursivedoubling(comm)
    return A.barrier_bruck(comm)


def reduce_tuned(comm, sendbuf, recvbuf, count, dtype, op, root):
    if not op.commute:
        return B.reduce_linear(comm, sendbuf, recvbuf, count, dtype, op,
                               root)
    return A.reduce_binomial(comm, sendbuf, recvbuf, count, dtype, op,
                             root)


def reduce_scatter_tuned(comm, sendbuf, recvbuf, counts, dtype, op):
    if op.commute and comm.size & (comm.size - 1) == 0:
        return A.reduce_scatter_recursivehalving(
            comm, sendbuf, recvbuf, counts, dtype, op)
    return B.reduce_scatter_basic(comm, sendbuf, recvbuf, counts, dtype,
                                  op)


def reduce_scatter_block_tuned(comm, sendbuf, recvbuf, count, dtype, op):
    if op.commute and comm.size > 2:
        return A.reduce_scatter_block_ring(comm, sendbuf, recvbuf,
                                           count, dtype, op)
    return B.reduce_scatter_block_basic(comm, sendbuf, recvbuf, count,
                                        dtype, op)


class CollTuned(registry.Component):
    """The component comm_select ranks."""

    NAME = "tuned"
    PRIORITY = 30  # the reference's tuned level

    def query(self, comm) -> int:
        return self.PRIORITY if comm.size > 1 else -1

    def slots(self, comm):
        return {
            "barrier": barrier_tuned,
            "bcast": bcast_tuned,
            "reduce": reduce_tuned,
            "allreduce": allreduce_tuned,
            "allgather": allgather_tuned,
            "alltoall": alltoall_tuned,
            "reduce_scatter": reduce_scatter_tuned,
            "reduce_scatter_block": reduce_scatter_block_tuned,
        }
