"""The public MPI-style API of the port (this slice's part of it).

Reference: ompi/mpi/c/ and the JAX package's ``ompi_tpu.mpi``: Init,
Finalize, COMM_WORLD/COMM_SELF, the op constants, Barrier, and the
device branches of Allreduce, Reduce_scatter_block, Allgather, Bcast,
Alltoall and the zero/ pair Reduce_scatter_multi / Allgather_multi
(ompi_tpu/mpi.py:673-680, 712-728, 801-850, 952-956, 975-979,
1007-1016). A device buffer is a ``torch.Tensor`` and the call returns a
new tensor; host (numpy) buffers need the host collectives of the pml
slice and raise ``MPIError(ERR_NOT_SUPPORTED)`` here, as do derived
datatypes (``datatype/``, ROADMAP queue 1 item 4).
"""

from __future__ import annotations

from ompi_tpu_torch import accelerator, errors, op as op_mod
from ompi_tpu_torch.comm import Communicator

SUM, PROD, MIN, MAX = op_mod.SUM, op_mod.PROD, op_mod.MIN, op_mod.MAX


def _device_or_raise(name: str, buf) -> None:
    if not accelerator.is_device_buffer(buf):
        raise errors.MPIError(
            errors.ERR_NOT_SUPPORTED,
            f"{name}: host buffer ({type(buf).__name__}); this slice of "
            "the port runs device (torch.Tensor) buffers only — host "
            "collectives come with the pml slice")


def _deliver(out, recvbuf):
    """The device path returns a new tensor; a recvbuf tensor given
    by the caller receives a copy of it too."""
    if recvbuf is not None:
        recvbuf.copy_(out)
    return out


def _Allreduce(self, sendbuf, recvbuf=None, op=op_mod.SUM,
               deterministic=None):
    """deterministic: None lets the component pick the algorithm;
    'ring'/'linear' fix the operand order — 'linear' is bit-identical
    to the host linear fold."""
    _device_or_raise("Allreduce", sendbuf)
    return _deliver(self.coll.allreduce_dev(
        self, sendbuf, op, deterministic=deterministic), recvbuf)


def _Reduce_scatter_block(self, sendbuf, recvbuf=None, op=op_mod.SUM,
                          deterministic=None):
    """dim 0 of sendbuf must be divisible by the comm size; returns this
    rank's (dim0/size, ...) block."""
    _device_or_raise("Reduce_scatter_block", sendbuf)
    return _deliver(self.coll.reduce_scatter_block_dev(
        self, sendbuf, op, deterministic=deterministic), recvbuf)


def _Allgather(self, sendbuf, recvbuf=None):
    """Returns (size, *sendbuf.shape), rank i's block at index i."""
    _device_or_raise("Allgather", sendbuf)
    return _deliver(self.coll.allgather_dev(self, sendbuf), recvbuf)


def _Bcast(self, buf, root: int = 0):
    """Returns the root's buf on every rank; the other ranks' buf gives
    the shape and dtype and receives a copy of the result too (MPI's
    in-place receive). A root outside [0, size) raises ERR_ROOT."""
    _device_or_raise("Bcast", buf)
    out = self.coll.bcast_dev(self, buf, root)
    return _deliver(out, buf if self.rank != root else None)


def _Alltoall(self, sendbuf, recvbuf=None):
    """dim 0 of sendbuf splits into size blocks; block p of the result
    is block ``rank`` of rank p's sendbuf (the MoE dispatch pattern)."""
    _device_or_raise("Alltoall", sendbuf)
    return _deliver(self.coll.alltoall_dev(self, sendbuf), recvbuf)


def _Reduce_scatter_multi(self, bufs, op=op_mod.SUM, deterministic=None):
    """Bucketed reduce-scatter over a pytree of device tensors (the
    zero/ gradient step): dtype-segregated buckets, each padded to a
    multiple of the comm size and reduce-scattered once; returns a
    zero.ShardedState of this rank's 1-D shard per bucket ('linear' stays
    bit-identical to the per-buffer allreduce fold)."""
    from ompi_tpu_torch.zero import layout as zl

    for leaf in zl.tree_leaves(bufs):
        _device_or_raise("Reduce_scatter_multi", leaf)
    return self.coll.reduce_scatter_multi_dev(
        self, bufs, op, deterministic=deterministic)


def _Allgather_multi(self, state):
    """Rebuild the full pytree from a zero.ShardedState: one allgather
    per bucket, rank-order concat (= the pack order), pad dropped, leaf
    shapes restored."""
    for shard in getattr(state, "shards", None) or ():
        _device_or_raise("Allgather_multi", shard)
    return self.coll.allgather_multi_dev(self, state)


def _Barrier(self) -> None:
    """MPI_Barrier through the comm's table (coll/basic: a store fence
    keyed by the comm, so a dup'd comm can barrier too)."""
    self.coll.barrier(self)


for _name, _fn in {"Allreduce": _Allreduce,
                   "Reduce_scatter_block": _Reduce_scatter_block,
                   "Allgather": _Allgather,
                   "Bcast": _Bcast,
                   "Alltoall": _Alltoall,
                   "Reduce_scatter_multi": _Reduce_scatter_multi,
                   "Allgather_multi": _Allgather_multi,
                   "Barrier": _Barrier}.items():
    setattr(Communicator, _name, _fn)


def Init():
    from ompi_tpu_torch.runtime import state

    return state.init()


def Finalize() -> None:
    from ompi_tpu_torch.runtime import state

    state.finalize()


def __getattr__(name: str):
    if name == "COMM_WORLD":
        from ompi_tpu_torch.runtime import state

        return state.world()
    if name == "COMM_SELF":
        from ompi_tpu_torch.runtime import state

        return state.comm_self()
    raise AttributeError(name)
