"""The public MPI-style API of the port.

Reference: ompi/mpi/c/ and the JAX package's ``ompi_tpu.mpi``. The
surface follows the mpi4py convention: lower-case methods move pickled
Python objects, capitalised methods move buffers. A host buffer is numpy
(or any object with the buffer protocol), given as ``array``,
``(array, count)`` or ``(array, count, Datatype)`` with a predefined
Datatype (derived datatypes raise ``MPIError(ERR_NOT_SUPPORTED)``, ROADMAP
queue 1 item 4); a device buffer is a ``torch.Tensor``.

Point-to-point (ompi_tpu/mpi.py:69-660): Send / Recv / Isend / Irecv /
Ssend / Issend / Rsend / Bsend (with Buffer_attach / Buffer_detach) /
Sendrecv / Sendrecv_replace / Isendrecv / Isendrecv_replace, the probe
family (Probe / Iprobe / Mprobe / Improbe / Mrecv), Send_init / Recv_init
/ start_all, Pack / Unpack / Pack_size, and the object API (send / recv /
isend / irecv / sendrecv, and bcast / gather / scatter / allgather /
alltoall / allreduce / reduce / barrier of Python objects) over ob1. A
tensor given to Send / Isend / Rsend / Recv / Irecv / Sendrecv /
Isendrecv goes through ``pml/accel_p2p``'s pipelined staging; unlike the
reference, which returns a new array (jax arrays are immutable), the
port receives in place: ``Recv`` fills the template tensor and returns
it, and an Irecv request's ``.array`` is that tensor. A CUDA tensor on a
rank whose device is the CPU, or on another card than the rank's, raises
``MPIError(ERR_ARG)``.

Collectives (ompi_tpu/mpi.py:663-1320) take device buffers: Allreduce,
Reduce, Reduce_scatter_block, Reduce_scatter, Allgather, Allgatherv,
Gather, Gatherv, Scatter, Scatterv, Bcast, Alltoall, Alltoallv, Scan,
Exscan, Allreduce_multi and the zero/ pair Reduce_scatter_multi /
Allgather_multi; their nonblocking forms (``I*``, Ibarrier) and the
persistent Allreduce_init, Bcast_init, Allgather_init, Alltoall_init,
Reduce_scatter_block_init and Allreduce_multi_init. A blocking call
returns a new tensor (a rooted call's non-roots get None) and a recvbuf
tensor, where given, receives a copy; a request's ``.array`` holds its
result and writes no recvbuf (as the reference's device branch). Host
(numpy) buffers to a collective raise ``MPIError(ERR_NOT_SUPPORTED)``:
the host collectives come with coll/basic's algorithms and coll/tuned
(ROADMAP queue 1 item 4), as does the host Ibarrier. Barrier is
coll/basic's linear barrier over the pml (or, with ``device=True``, the
device plane's).
"""

from __future__ import annotations

import numbers
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ompi_tpu_torch import accelerator, errors, op as op_mod, pml
from ompi_tpu_torch.comm import Communicator, Group, UNDEFINED  # noqa: F401
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.datatype import Datatype, PREDEFINED, dtype_of
from ompi_tpu_torch.datatype.datatype import DERIVED_ITEM
from ompi_tpu_torch.pml import request as rq
from ompi_tpu_torch.pml.request import (  # noqa: F401  (re-exports)
    ANY_SOURCE, ANY_TAG, PROC_NULL, Request, Status, test_all, test_any,
    wait_all, wait_any, wait_some,
)

SUM, PROD, MIN, MAX = op_mod.SUM, op_mod.PROD, op_mod.MIN, op_mod.MAX

#: where the host-buffer collectives are waiting
HOST_COLL_ITEM = ("host-buffer collectives come with coll/basic's "
                  "algorithms and coll/tuned (ROADMAP queue 1 item 4)")


def _device_or_raise(name: str, buf) -> None:
    if not accelerator.is_device_buffer(buf):
        raise errors.MPIError(
            errors.ERR_NOT_SUPPORTED,
            f"{name}: host buffer ({type(buf).__name__}); the port's "
            f"collectives take device (torch.Tensor) buffers — "
            f"{HOST_COLL_ITEM}")


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
    """MPI_Barrier through the comm's table: coll/basic's linear barrier
    over the pml, or with ``device=True`` coll/device's one-element
    allreduce on the device plane (ompi_tpu/mpi.py:663-670)."""
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
    needs the nonblocking host collectives (libnbc)."""
    if not device:
        raise errors.MPIError(
            errors.ERR_NOT_SUPPORTED,
            f"Ibarrier: the host form is libnbc's; {HOST_COLL_ITEM}; "
            "pass device=True")
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


# ---------------------------------------------------------------------------
# point-to-point (ompi_tpu/mpi.py:37-660)
# ---------------------------------------------------------------------------

def _is_dev(buf) -> bool:
    return isinstance(buf, torch.Tensor)


def _parse_buf(buf) -> Tuple[Any, int, Optional[Datatype]]:
    """(buffer, count, datatype) from a host buffer spec: ``array``,
    ``(array, count)`` or ``(array, count, Datatype)``."""
    if isinstance(buf, tuple):
        if _is_dev(buf[0]):
            raise errors.MPIError(
                errors.ERR_NOT_SUPPORTED,
                "(tensor, count[, datatype]) packs on the device, which "
                f"the datatype engine does: {DERIVED_ITEM}")
        if isinstance(buf[0], np.ndarray) \
                and not buf[0].flags["C_CONTIGUOUS"]:
            raise errors.MPIError(errors.ERR_BUFFER,
                                  "a non-contiguous numpy buffer needs a "
                                  f"derived datatype: {DERIVED_ITEM}")
        if len(buf) == 2:
            arr, count = buf
            return arr, int(count), dtype_of(arr)
        arr, count, dt = buf
        if not isinstance(dt, Datatype) \
                or PREDEFINED.get(dt.name) is not dt \
                and not dt.name.startswith("MPI_NP_"):
            raise errors.MPIError(errors.ERR_NOT_SUPPORTED,
                                  f"datatype {dt!r}: {DERIVED_ITEM}")
        return arr, int(count), dt
    if _is_dev(buf):
        raise TypeError(
            "tensor passed to an operation without a device path: the "
            "device entries are Send / Isend / Rsend / Recv / Irecv / "
            "Sendrecv / Isendrecv and the collectives")
    if isinstance(buf, np.ndarray):
        if not buf.flags["C_CONTIGUOUS"]:
            raise errors.MPIError(
                errors.ERR_BUFFER,
                "a non-contiguous numpy buffer needs a derived datatype: "
                f"{DERIVED_ITEM}; pass np.ascontiguousarray(buf)")
        return buf, buf.size, dtype_of(buf)
    return buf, memoryview(buf).nbytes, None


def _check_rank(comm, rank: int) -> None:
    if rank in (PROC_NULL, ANY_SOURCE):
        return
    if not 0 <= rank < comm.size:
        raise errors.RankError(f"rank {rank} out of range for {comm}")


def _copy_status(st: Status, status: Optional[Status]) -> None:
    if status is not None:
        status.source, status.tag = st.source, st.tag
        status.count, status.error = st.count, st.error


# -- the object (pickled) point-to-point --

def _send(self, obj, dest: int, tag: int = 0) -> None:
    _check_rank(self, dest)
    pvar.record("send")
    pml.current().send_obj(self, obj, dest, tag)


def _isend(self, obj, dest: int, tag: int = 0) -> Request:
    _check_rank(self, dest)
    return pml.current().isend_obj(self, obj, dest, tag)


def _recv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
          status: Optional[Status] = None):
    req = pml.current().irecv_obj(self, source, tag)
    _copy_status(req.wait(), status)
    return req._obj


def _irecv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG) -> Request:
    """The object arrives in the request's ``_obj`` at completion."""
    return pml.current().irecv_obj(self, source, tag)


def _sendrecv(self, obj, dest: int, source: int = ANY_SOURCE,
              sendtag: int = 0, recvtag: int = ANY_TAG):
    rreq = pml.current().irecv_obj(self, source, recvtag)
    sreq = pml.current().isend_obj(self, obj, dest, sendtag)
    rreq.wait()
    sreq.wait()
    return rreq._obj


# -- the buffer point-to-point --

def _Send(self, buf, dest: int, tag: int = 0) -> None:
    """A tensor goes through the pipelined staging of
    ``pml/accel_p2p``."""
    _check_rank(self, dest)
    pvar.record("send")
    if _is_dev(buf):
        from ompi_tpu_torch.pml import accel_p2p

        return accel_p2p.send_dev(self, buf, dest, tag)
    arr, count, dt = _parse_buf(buf)
    pml.current().send(self, arr, count, dt, dest, tag)


def _Isend(self, buf, dest: int, tag: int = 0) -> Request:
    _check_rank(self, dest)
    if _is_dev(buf):
        from ompi_tpu_torch.pml import accel_p2p

        return accel_p2p.isend_dev(self, buf, dest, tag)
    arr, count, dt = _parse_buf(buf)
    return pml.current().isend(self, arr, count, dt, dest, tag)


def _Ssend(self, buf, dest: int, tag: int = 0) -> None:
    """Synchronous send: completes once the receiver has matched."""
    arr, count, dt = _parse_buf(buf)
    pml.current().send(self, arr, count, dt, dest, tag, sync=True)


def _Issend(self, buf, dest: int, tag: int = 0) -> Request:
    arr, count, dt = _parse_buf(buf)
    return pml.current().isend(self, arr, count, dt, dest, tag, sync=True)


def _Rsend(self, buf, dest: int, tag: int = 0) -> None:
    """Ready send: the receive is posted, so the eager path is the
    same as Send's."""
    _Send(self, buf, dest, tag)


#: MPI_BSEND_OVERHEAD: per-message bookkeeping charged against an
#: attached buffer
BSEND_OVERHEAD = 64

#: None: no buffer attached, Bsend buffers without bound (the
#: reference's documented extension); attaching one opts into MPI's
#: capacity contract
_bsend_capacity: Optional[int] = None
_pending_bsends: List[Tuple[Request, int]] = []


def Buffer_attach(buf_or_size) -> None:
    """MPI_Buffer_attach: cap buffered-send memory at a byte count or a
    buffer's size (the copies are heap allocations; only the size
    counts). With a buffer attached, a Bsend past the capacity raises
    ERR_BUFFER."""
    global _bsend_capacity
    if _bsend_capacity is not None:
        raise errors.MPIError(errors.ERR_BUFFER,
                              "a bsend buffer is already attached")
    # numbers.Integral takes numpy ints too (which expose the buffer
    # protocol and would otherwise attach as 8 bytes)
    size = (int(buf_or_size) if isinstance(buf_or_size, numbers.Integral)
            else memoryview(buf_or_size).nbytes)
    if size < 0:
        raise errors.MPIError(errors.ERR_BUFFER,
                              f"negative buffer size {size}")
    _bsend_capacity = size


def Buffer_detach() -> int:
    """MPI_Buffer_detach: blocks until every outstanding buffered send
    has delivered, then returns the detached size."""
    global _bsend_capacity
    if _bsend_capacity is None:
        raise errors.MPIError(errors.ERR_BUFFER, "no bsend buffer attached")
    _flush_bsends()
    size, _bsend_capacity = _bsend_capacity, None
    return size


def _flush_bsends() -> None:
    for r, _ in list(_pending_bsends):
        r.wait()
    _pending_bsends.clear()


def _bsend_used() -> int:
    """Reclaim delivered copies (after one progress sweep: rendezvous
    completions flip inside a sweep), then the live charge."""
    from ompi_tpu_torch.core import progress

    progress.progress()
    _pending_bsends[:] = [(r, nb) for r, nb in _pending_bsends
                          if not r.completed]
    return sum(nb for _, nb in _pending_bsends)


def _Bsend(self, buf, dest: int, tag: int = 0) -> None:
    """Buffered send: copy now, deliver in the background."""
    arr, count, dt = _parse_buf(buf)
    if isinstance(arr, np.ndarray):
        copy = np.array(arr, copy=True)
    else:  # a raw buffer keeps its byte semantics
        copy = np.frombuffer(bytes(arr), dtype=np.uint8).copy()
    charge = copy.nbytes + BSEND_OVERHEAD
    if _bsend_capacity is not None \
            and _bsend_used() + charge > _bsend_capacity:
        raise errors.MPIError(
            errors.ERR_BUFFER,
            f"bsend of {copy.nbytes} bytes exceeds the attached buffer "
            f"({_bsend_capacity} bytes, {_bsend_used()} in flight)")
    _pending_bsends.append(
        (pml.current().isend(self, copy, count, dt, dest, tag), charge))


def _Recv(self, buf, source: int = ANY_SOURCE, tag: int = ANY_TAG,
          status: Optional[Status] = None):
    """A host buffer is filled in place and the Status returned; a
    tensor is received in place through ``pml/accel_p2p`` and returned
    (the Status goes to ``status``)."""
    if _is_dev(buf):
        from ompi_tpu_torch.pml import accel_p2p

        out, st = accel_p2p.recv_dev(self, buf, source, tag)
        _copy_status(st, status)
        return out
    arr, count, dt = _parse_buf(buf)
    st = pml.current().recv(self, arr, count, dt, source, tag)
    _copy_status(st, status)
    return st


def _Irecv(self, buf, source: int = ANY_SOURCE,
           tag: int = ANY_TAG) -> Request:
    """For a tensor, the request's ``.array`` is ``buf`` once complete."""
    if _is_dev(buf):
        from ompi_tpu_torch.pml import accel_p2p

        return accel_p2p.irecv_dev(self, buf, source, tag)
    arr, count, dt = _parse_buf(buf)
    return pml.current().irecv(self, arr, count, dt, source, tag)


def _Sendrecv(self, sendbuf, dest: int, recvbuf, source: int = ANY_SOURCE,
              sendtag: int = 0, recvtag: int = ANY_TAG) -> Status:
    rreq = _Irecv(self, recvbuf, source, recvtag)
    sreq = _Isend(self, sendbuf, dest, sendtag)
    st = rreq.wait()
    sreq.wait()
    return st


class _PairRequest(rq.Request):
    """One request over a (recv, send) pair, MPI-4's Isendrecv handle:
    complete when both are; its status is the receive's."""

    def __init__(self, rreq: Request, sreq: Request) -> None:
        super().__init__()
        self._rreq = rreq
        self._sreq = sreq

    @property
    def completed(self) -> bool:
        return self._rreq.completed and self._sreq.completed

    @completed.setter
    def completed(self, v: bool) -> None:
        pass  # the base __init__ writes here; the property is derived

    @property
    def status(self) -> Status:
        return self._rreq.status

    @status.setter
    def status(self, st) -> None:
        pass

    @property
    def array(self):
        return getattr(self._rreq, "array", None)

    def wait(self, timeout=None) -> Status:
        import time

        t0 = time.perf_counter()
        st = self._rreq.wait(timeout=timeout)
        rem = (None if timeout is None else
               max(0.0, timeout - (time.perf_counter() - t0)))
        self._sreq.wait(timeout=rem)  # one budget for both halves
        return st


def _Isendrecv(self, sendbuf, dest: int, recvbuf, source: int = ANY_SOURCE,
               sendtag: int = 0, recvtag: int = ANY_TAG) -> Request:
    """MPI_Isendrecv: both halves post now."""
    return _PairRequest(_Irecv(self, recvbuf, source, recvtag),
                        _Isend(self, sendbuf, dest, sendtag))


def _Isendrecv_replace(self, buf, dest: int, source: int = ANY_SOURCE,
                       sendtag: int = 0, recvtag: int = ANY_TAG) -> Request:
    """MPI_Isendrecv_replace: the send's snapshot is taken now (the
    receive overwrites ``buf`` as it lands)."""
    arr, count, dt = _parse_buf(buf)
    tmp = np.array(arr, copy=True)
    return _PairRequest(_Irecv(self, (arr, count, dt), source, recvtag),
                        _Isend(self, (tmp, count, dt), dest, sendtag))


def _Sendrecv_replace(self, buf, dest: int, source: int = ANY_SOURCE,
                      sendtag: int = 0, recvtag: int = ANY_TAG) -> Status:
    return _Isendrecv_replace(self, buf, dest, source, sendtag,
                              recvtag).wait()


def _Probe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG) -> Status:
    return pml.current().probe(self, source, tag)


def _Iprobe(self, source: int = ANY_SOURCE,
            tag: int = ANY_TAG) -> Optional[Status]:
    return pml.current().iprobe(self, source, tag)


def _Mprobe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG):
    """(Message, Status) of a matched message, removed from matching."""
    return pml.current().mprobe(self, source, tag)


def _Improbe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG):
    return pml.current().improbe(self, source, tag)


def _Mrecv(self, msg, buf) -> Status:
    arr, count, dt = _parse_buf(buf)
    return pml.current().mrecv(msg, arr, count, dt)


class _PersistentRequest(rq.Request):
    """MPI_Send_init / MPI_Recv_init handles, restarted by start().
    ``completed`` / ``status`` follow the live inner request, so the
    plural waits see completion; an inactive request is complete."""

    def __init__(self, comm, kind: str, args: tuple) -> None:
        super().__init__()
        self.persistent = True
        self.comm = comm
        self.kind = kind
        self.args = args
        self._live: Optional[Request] = None

    @property
    def completed(self) -> bool:
        return self._live is None or self._live.completed

    @completed.setter
    def completed(self, v: bool) -> None:
        pass  # the base __init__ writes here; the property is derived

    @property
    def status(self) -> Status:
        return self._live.status if self._live is not None \
            else self._idle_status

    @status.setter
    def status(self, st) -> None:
        self._idle_status = st

    def start(self) -> None:
        p = pml.current()
        buf, count, dt, peer, tag = self.args
        self._live = (p.isend if self.kind == "send" else p.irecv)(
            self.comm, buf, count, dt, peer, tag)

    @property
    def active(self) -> bool:
        """Started and not yet known complete."""
        return self._live is not None and not self._live.completed

    def wait(self, timeout=None):
        if self._live is None:
            return self.status
        return self._live.wait(timeout=timeout)


def _Send_init(self, buf, dest: int, tag: int = 0) -> _PersistentRequest:
    arr, count, dt = _parse_buf(buf)
    return _PersistentRequest(self, "send", (arr, count, dt, dest, tag))


def _Recv_init(self, buf, source: int = ANY_SOURCE,
               tag: int = ANY_TAG) -> _PersistentRequest:
    arr, count, dt = _parse_buf(buf)
    return _PersistentRequest(self, "recv", (arr, count, dt, source, tag))


def start_all(reqs: Sequence[Request]) -> None:
    """MPI_Startall, all or nothing: a request that is not persistent
    raises TypeError and one whose last cycle is still active raises
    ERR_REQUEST, before any request starts."""
    for r in reqs:
        if not getattr(r, "persistent", False) \
                or not callable(getattr(r, "start", None)):
            raise TypeError(f"start_all: request {getattr(r, 'id', r)!r} "
                            "is not a persistent request")
    for r in reqs:
        if getattr(r, "active", False):
            raise errors.MPIError(
                errors.ERR_REQUEST,
                f"start_all: request {getattr(r, 'id', '?')} is still "
                "active (no request was started)")
    for r in reqs:
        r.start()


Startall = start_all


def _Pack(self, inbuf, outbuf, position: int = 0) -> int:
    """MPI_Pack: inbuf's packed bytes into outbuf at position; returns
    the new position."""
    from ompi_tpu_torch.datatype import BYTE, Convertor

    arr, count, dt = _parse_buf(inbuf)
    data = Convertor(arr, dt or BYTE, count).pack()
    out = memoryview(outbuf).cast("B")
    if position + len(data) > len(out):
        raise errors.TruncateError(
            f"Pack: need {position + len(data)} bytes, outbuf has "
            f"{len(out)}")
    out[position:position + len(data)] = data
    return position + len(data)


def _Unpack(self, inbuf, position: int, outbuf) -> int:
    """MPI_Unpack: packed bytes of inbuf at position into outbuf;
    returns the new position."""
    from ompi_tpu_torch.datatype import BYTE, Convertor

    arr, count, dt = _parse_buf(outbuf)
    conv = Convertor(arr, dt or BYTE, count)
    src = memoryview(inbuf).cast("B")
    need = conv.packed_size
    if position + need > len(src):
        raise errors.TruncateError(
            f"Unpack: need {need} bytes at position {position}, inbuf "
            f"has {len(src)}")
    conv.unpack(bytes(src[position:position + need]))
    return position + need


def _Pack_size(self, count: int, dtype) -> int:
    """MPI_Pack_size: an upper bound on Pack's output bytes."""
    dt = dtype if isinstance(dtype, Datatype) else dtype_of(
        np.empty(0, dtype))
    return count * dt.size


# -- the object collectives (coll/basic over the pml) --

def _barrier(self) -> None:
    self.coll.barrier(self)


def _bcast(self, obj=None, root: int = 0):
    return self.coll.bcast_obj(self, obj, root)


def _gather(self, obj, root: int = 0):
    return self.coll.gather_obj(self, obj, root)


def _scatter(self, objs=None, root: int = 0):
    return self.coll.scatter_obj(self, objs, root)


def _allgather(self, obj):
    return self.coll.allgather_obj(self, obj)


def _alltoall(self, objs):
    return self.coll.alltoall_obj(self, objs)


#: the elementwise numpy function of each builtin op the object
#: reductions take (the reference's ``Op.np_fn``)
_NP_FN = {op_mod.SUM: np.add, op_mod.PROD: np.multiply,
          op_mod.MIN: np.minimum, op_mod.MAX: np.maximum,
          op_mod.LAND: np.logical_and, op_mod.LOR: np.logical_or,
          op_mod.LXOR: np.logical_xor, op_mod.BAND: np.bitwise_and,
          op_mod.BOR: np.bitwise_or, op_mod.BXOR: np.bitwise_xor}


def _obj_fn(op):
    """An op for the object reductions: a callable, a builtin Op (its
    elementwise numpy function) or None (+)."""
    if isinstance(op, op_mod.Op):
        fn = _NP_FN.get(op)
        if fn is None:
            raise errors.MPIError(errors.ERR_OP,
                                  f"{op.name} on Python objects")
        return fn
    return op if callable(op) else (lambda a, b: a + b)


def _allreduce(self, obj, op=None):
    return self.coll.allreduce_obj(self, obj, _obj_fn(op))


def _reduce(self, obj, op=None, root: int = 0):
    vals = self.coll.gather_obj(self, obj, root)
    if vals is None:
        return None
    fn = _obj_fn(op)
    acc = vals[0]
    for v in vals[1:]:
        acc = fn(acc, v)
    return acc


for _name, _fn in {
        "send": _send, "isend": _isend, "recv": _recv, "irecv": _irecv,
        "sendrecv": _sendrecv, "Send": _Send, "Isend": _Isend,
        "Ssend": _Ssend, "Issend": _Issend, "Rsend": _Rsend,
        "Bsend": _Bsend, "Recv": _Recv, "Irecv": _Irecv,
        "Sendrecv": _Sendrecv, "Sendrecv_replace": _Sendrecv_replace,
        "Isendrecv": _Isendrecv, "Isendrecv_replace": _Isendrecv_replace,
        "Probe": _Probe, "Iprobe": _Iprobe, "Mprobe": _Mprobe,
        "Improbe": _Improbe, "Mrecv": _Mrecv, "Send_init": _Send_init,
        "Recv_init": _Recv_init, "Pack": _Pack, "Unpack": _Unpack,
        "Pack_size": _Pack_size, "barrier": _barrier, "bcast": _bcast,
        "gather": _gather, "scatter": _scatter, "allgather": _allgather,
        "alltoall": _alltoall, "allreduce": _allreduce,
        "reduce": _reduce}.items():
    setattr(Communicator, _name, _fn)


# attribute caching (ompi/attribute/attribute.c; the predefined
# attributes of attribute_predefined.c:119-195) and Info objects
from ompi_tpu_torch.attr import (  # noqa: E402,F401
    APPNUM, HOST, IO, KEYVAL_INVALID, LASTUSEDCODE, NO_COPY, TAG_UB,
    UNIVERSE_SIZE, WTIME_IS_GLOBAL, dup_fn, null_copy_fn,
)
from ompi_tpu_torch.info import Info  # noqa: E402,F401


def Comm_create_keyval(copy_fn=None, delete_fn=None, extra_state=None):
    """MPI_Comm_create_keyval: ``copy_fn(obj, keyval, extra_state,
    value)`` -> the dup's value (NO_COPY drops it; None never copies);
    ``delete_fn(obj, keyval, value, extra_state)`` on delete, overwrite
    and free."""
    from ompi_tpu_torch import attr

    return attr.create_keyval(copy_fn, delete_fn, extra_state)


def Comm_free_keyval(keyval: int) -> int:
    from ompi_tpu_torch import attr

    return attr.free_keyval(keyval)


def Grequest_start(query_fn=None, free_fn=None, cancel_fn=None):
    """MPI_Grequest_start: a request the application completes with
    ``req.complete()`` (MPI_Grequest_complete)."""
    return rq.GeneralizedRequest(query_fn, free_fn, cancel_fn)


def Get_processor_name() -> str:
    from ompi_tpu_torch.runtime import rte

    return rte.hostname()


def Init():
    from ompi_tpu_torch.runtime import state

    return state.init()


def Finalize() -> None:
    """MPI_Finalize: outstanding buffered sends deliver first."""
    from ompi_tpu_torch.runtime import state

    _flush_bsends()
    state.finalize()


def __getattr__(name: str):
    if name == "COMM_WORLD":
        from ompi_tpu_torch.runtime import state

        return state.world()
    if name == "COMM_SELF":
        from ompi_tpu_torch.runtime import state

        return state.comm_self()
    raise AttributeError(name)
