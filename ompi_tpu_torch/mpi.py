"""The public MPI-style API of the port (the device half of it).

Reference: ompi/mpi/c/ and the JAX package's ``ompi_tpu.mpi``: Init,
Finalize, COMM_WORLD/COMM_SELF, the op constants, Barrier (the store's,
or with ``device=True`` the device plane's), and the device branches of
the collectives (ompi_tpu/mpi.py:663-1320): Allreduce, Reduce,
Reduce_scatter_block, Reduce_scatter, Allgather, Allgatherv, Gather,
Gatherv, Scatter, Scatterv, Bcast, Alltoall, Alltoallv, Scan, Exscan,
Allreduce_multi and the zero/ pair Reduce_scatter_multi /
Allgather_multi; their nonblocking forms (``I*``, Ibarrier) and the
persistent Allreduce_init, Bcast_init, Allgather_init, Alltoall_init,
Reduce_scatter_block_init and Allreduce_multi_init. A device buffer is a
``torch.Tensor``; a blocking call returns a new tensor (a rooted call's
non-roots get None) and a recvbuf tensor, where given, receives a copy;
a request's ``.array`` holds its result and writes no recvbuf (as the
reference's device branch). Host (numpy) buffers need the host
collectives of the pml slice and raise ``MPIError(ERR_NOT_SUPPORTED)``
here, as do derived datatypes (``datatype/``, ROADMAP queue 1 item 4)
and the host Ibarrier.
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
    by the caller receives a copy of it too (where there is a result:
    a rooted call's non-roots get None)."""
    if recvbuf is not None and out is not None:
        recvbuf.copy_(out)
    return out


def _device_tree_or_raise(name: str, bufs) -> None:
    from ompi_tpu_torch.zero import layout as zl

    for leaf in zl.tree_leaves(bufs):
        _device_or_raise(name, leaf)


def _packed_displs_or_raise(counts, displs, name: str) -> None:
    """The device v-collectives read the send buffer as packed segments;
    another send-side layout would move the wrong rows
    (ompi_tpu/mpi.py:636-648)."""
    if displs is None:
        return
    packed, o = [], 0
    for c in counts:
        packed.append(o)
        o += int(c)
    if [int(d) for d in displs] != packed:
        raise errors.MPIError(
            errors.ERR_ARG,
            f"{name}: the device path needs the packed send displacements "
            f"{packed}, got {list(displs)}")


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
    _device_tree_or_raise("Reduce_scatter_multi", bufs)
    return self.coll.reduce_scatter_multi_dev(
        self, bufs, op, deterministic=deterministic)


def _Allgather_multi(self, state):
    """Rebuild the full pytree from a zero.ShardedState: one allgather
    per bucket, rank-order concat (= the pack order), pad dropped, leaf
    shapes restored."""
    for shard in getattr(state, "shards", None) or ():
        _device_or_raise("Allgather_multi", shard)
    return self.coll.allgather_multi_dev(self, state)


def _Barrier(self, device: bool = False) -> None:
    """MPI_Barrier through the comm's table: coll/basic's store fence
    keyed by the comm (a dup'd comm can barrier too), or with
    ``device=True`` coll/device's one-element allreduce on the device
    plane (ompi_tpu/mpi.py:663-670)."""
    if device:
        return self.coll.barrier_dev(self)
    self.coll.barrier(self)


def _Reduce(self, sendbuf, recvbuf=None, op=op_mod.SUM, root: int = 0,
            deterministic=None):
    """Returns the reduction on the root, None elsewhere (the root's
    recvbuf receives a copy)."""
    _device_or_raise("Reduce", sendbuf)
    return _deliver(self.coll.reduce_dev(
        self, sendbuf, op, root, deterministic=deterministic), recvbuf)


def _Gather(self, sendbuf, recvbuf=None, root: int = 0):
    """Returns (size, *sendbuf.shape) on the root, None elsewhere."""
    _device_or_raise("Gather", sendbuf)
    return _deliver(self.coll.gather_dev(self, sendbuf, root), recvbuf)


def _Gatherv(self, sendbuf, recvbuf, counts, displs=None, root: int = 0):
    """Returns the packed (sum(counts), *rest) on the root, None
    elsewhere (displs is a host-layout argument: the device result is
    packed)."""
    _device_or_raise("Gatherv", sendbuf)
    return _deliver(self.coll.gatherv_dev(self, sendbuf, counts, root),
                    recvbuf)


def _Scatter(self, sendbuf, recvbuf=None, root: int = 0,
             device: bool = False):
    """Rank r gets chunk r of the root's sendbuf. A non-root passes
    sendbuf None with ``device=True``; its recvbuf, when given, is the
    shape template (``like``, every rank or none) and receives the
    chunk."""
    if not device or sendbuf is not None:
        _device_or_raise("Scatter", sendbuf)
    return _deliver(self.coll.scatter_dev(self, sendbuf, root,
                                          like=recvbuf), recvbuf)


def _Scatterv(self, sendbuf, recvbuf, counts, displs=None, root: int = 0,
              device: bool = False):
    """Rank r gets counts[r] rows of the root's packed sendbuf; as
    Scatter for non-roots (recvbuf is the template of the trailing dims
    and dtype)."""
    if not device or sendbuf is not None:
        _device_or_raise("Scatterv", sendbuf)
    _packed_displs_or_raise(counts, displs, "Scatterv")
    return _deliver(self.coll.scatterv_dev(self, sendbuf, counts, root,
                                           like=recvbuf), recvbuf)


def _Allgatherv(self, sendbuf, recvbuf, counts, displs=None):
    """Returns the packed (sum(counts), *rest)."""
    _device_or_raise("Allgatherv", sendbuf)
    return _deliver(self.coll.allgatherv_dev(self, sendbuf, counts),
                    recvbuf)


def _Alltoallv(self, sendbuf, recvbuf, scounts, rcounts, sdispls=None,
               rdispls=None, max_count=None):
    """Block p of the result is the rcounts[p] rows rank p sends this
    rank. ``max_count`` (e.g. a fixed MoE expert capacity) skips the
    count round."""
    _device_or_raise("Alltoallv", sendbuf)
    _packed_displs_or_raise(scounts, sdispls, "Alltoallv")
    return _deliver(self.coll.alltoallv_dev(
        self, sendbuf, scounts, rcounts, max_count=max_count), recvbuf)


def _Reduce_scatter(self, sendbuf, recvbuf, counts, op=op_mod.SUM,
                    deterministic=None):
    """Returns this rank's counts[rank] rows of the reduction."""
    _device_or_raise("Reduce_scatter", sendbuf)
    return _deliver(self.coll.reduce_scatter_dev(
        self, sendbuf, counts, op, deterministic=deterministic), recvbuf)


def _Scan(self, sendbuf, recvbuf=None, op=op_mod.SUM):
    """The inclusive prefix over ranks 0..rank, folded in rank order."""
    _device_or_raise("Scan", sendbuf)
    return _deliver(self.coll.scan_dev(self, sendbuf, op), recvbuf)


def _Exscan(self, sendbuf, recvbuf=None, op=op_mod.SUM):
    """The exclusive prefix; rank 0 gets zeros."""
    _device_or_raise("Exscan", sendbuf)
    return _deliver(self.coll.exscan_dev(self, sendbuf, op), recvbuf)


def _Allreduce_multi(self, bufs, op=op_mod.SUM, deterministic=None):
    """Fused (bucketed) allreduce over a pytree of device tensors: dtype
    buckets of ``coll_device_bucket_bytes``, one allreduce each; returns
    a new pytree ('linear' is bitwise the per-buffer loop)."""
    _device_tree_or_raise("Allreduce_multi", bufs)
    return self.coll.allreduce_multi_dev(self, bufs, op,
                                         deterministic=deterministic)


def _Allreduce_multi_init(self, bufs, op=op_mod.SUM):
    """Persistent Allreduce_multi: planned at init, each start() runs
    the buckets on the tensors' current contents; req.array holds each
    cycle's pytree."""
    _device_tree_or_raise("Allreduce_multi_init", bufs)
    return self.coll.allreduce_multi_init_dev(self, bufs, op)


def _Ibarrier(self, device: bool = False):
    """The device barrier's request (``device=True``); the host form
    needs the pml slice."""
    if not device:
        raise errors.MPIError(
            errors.ERR_NOT_SUPPORTED,
            "Ibarrier: the host form comes with the pml slice (ROADMAP "
            "queue 1 item 2); pass device=True")
    return self.coll.ibarrier_dev(self)


def _Iscatter(self, sendbuf, recvbuf=None, root: int = 0,
              device: bool = False):
    if not device or sendbuf is not None:
        _device_or_raise("Iscatter", sendbuf)
    return self.coll.iscatter_dev(self, sendbuf, root, like=recvbuf)


def _Igatherv(self, sendbuf, recvbuf, counts, displs=None, root: int = 0):
    _device_or_raise("Igatherv", sendbuf)
    return self.coll.igatherv_dev(self, sendbuf, counts, root)


def _Iscatterv(self, sendbuf, recvbuf, counts, displs=None, root: int = 0,
               device: bool = False):
    if not device or sendbuf is not None:
        _device_or_raise("Iscatterv", sendbuf)
    _packed_displs_or_raise(counts, displs, "Iscatterv")
    return self.coll.iscatterv_dev(self, sendbuf, counts, root,
                                   like=recvbuf)


def _Iallgatherv(self, sendbuf, recvbuf, counts, displs=None):
    _device_or_raise("Iallgatherv", sendbuf)
    return self.coll.iallgatherv_dev(self, sendbuf, counts)


def _Ialltoallv(self, sendbuf, recvbuf, scounts, rcounts, sdispls=None,
                rdispls=None, max_count=None):
    _device_or_raise("Ialltoallv", sendbuf)
    _packed_displs_or_raise(scounts, sdispls, "Ialltoallv")
    return self.coll.ialltoallv_dev(self, sendbuf, scounts, rcounts,
                                    max_count=max_count)


def _request_call(name: str, has_recvbuf: bool):
    """An I* or *_init call whose arguments after the buffer (and the
    recvbuf, which a request does not write: its ``.array`` holds the
    result) are its slot's own: ``name.lower() + '_dev'``."""
    slot = name.lower() + "_dev"
    if has_recvbuf:
        def call(self, sendbuf, recvbuf=None, *args, **kwargs):
            _device_or_raise(name, sendbuf)
            return getattr(self.coll, slot)(self, sendbuf, *args, **kwargs)
    else:
        def call(self, buf, *args, **kwargs):
            _device_or_raise(name, buf)
            return getattr(self.coll, slot)(self, buf, *args, **kwargs)
    call.__name__ = "_" + name
    call.__doc__ = (f"{name}: the request of coll/device's ``{slot}`` "
                    "(a DeviceRequest, or a PersistentDeviceRequest for "
                    "*_init).")
    return call


for _fn in (_Allreduce, _Reduce_scatter_block, _Allgather, _Bcast,
            _Alltoall, _Reduce_scatter_multi, _Allgather_multi, _Barrier,
            _Reduce, _Gather, _Gatherv, _Scatter, _Scatterv, _Allgatherv,
            _Alltoallv, _Reduce_scatter, _Scan, _Exscan, _Allreduce_multi,
            _Allreduce_multi_init, _Ibarrier, _Iscatter, _Igatherv,
            _Iscatterv, _Iallgatherv, _Ialltoallv,
            *(_request_call(name, True) for name in (
                "Iallreduce", "Ireduce", "Igather", "Iallgather",
                "Ialltoall", "Iscan", "Iexscan", "Ireduce_scatter_block",
                "Ireduce_scatter", "Allreduce_init", "Allgather_init",
                "Alltoall_init", "Reduce_scatter_block_init")),
            *(_request_call(name, False) for name in ("Ibcast",
                                                      "Bcast_init"))):
    setattr(Communicator, _fn.__name__[1:], _fn)


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
